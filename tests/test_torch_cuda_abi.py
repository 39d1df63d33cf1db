"""The C <-> ctypes boundary of the port's CUDA libraries, checked on the
CPU without nvcc: every ``extern "C"`` function of ``csrc/*.cu`` is parsed
from the source and its parameters' count and kinds (pointer, ``int``,
``long long``, ``float``) held against the argtypes that
``ops/cuda_kernels.py``'s ``_LIBS`` gives ctypes. ctypes passes a
mismatch without a word, and on the card it shows only as a wrong
pointer or a cut integer."""
import ctypes
import re

import pytest

from deeplearning4j_tpu_torch.ops import cuda_build, cuda_kernels

_KIND = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
         ctypes.c_longlong: "long long", ctypes.c_float: "float"}
#: every library also exports the error-string helper ``_lib`` binds
_ERROR_STRING = ("dl4j_cuda_error_string", ("int",))


def _param_kind(param: str) -> str:
    p = " ".join(param.split())
    if "*" in p:
        return "ptr"
    for kind in ("long long", "int", "float"):
        if re.match(rf"(const )?{kind} \w+$", p):
            return kind
    raise ValueError(f"parameter of no ctypes kind: {param!r}")


def extern_c_functions(text: str):
    """{name: (return type, parameter kinds)} of the functions defined
    inside the ``extern "C" { ... }`` blocks of a C++ source."""
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    out = {}
    for block in re.finditer(r'extern\s+"C"\s*\{', text):
        depth, top, i = 1, [], block.end()
        while depth:
            ch = text[i]
            if ch == "{":
                if depth == 1:
                    top.append("{")
                depth += 1
            elif ch == "}":
                depth -= 1
            elif depth == 1:
                top.append(ch)
            i += 1
        for m in re.finditer(r"([\w\s\*]+?)\b(\w+)\s*\(([^()]*)\)\s*\{",
                             "".join(top)):
            params = [p for p in m.group(3).split(",") if p.strip()]
            out[m.group(2)] = (" ".join(m.group(1).split()),
                               tuple(_param_kind(p) for p in params))
    return out


def _library_functions(sources):
    found = {}
    for src in sources:
        found.update(extern_c_functions(
            (cuda_build.CSRC_DIR / src).read_text()))
    return found


_ENTRIES = [(lib, entry) for lib, (_, entries) in cuda_kernels._LIBS.items()
            for entry in entries]


@pytest.mark.parametrize("lib,entry", _ENTRIES,
                         ids=[e for _, e in _ENTRIES])
def test_entry_parameters_match_the_ctypes_argtypes(lib, entry):
    sources, entries = cuda_kernels._LIBS[lib]
    found = _library_functions(sources)
    assert entry in found, f"{entry} not defined in {sources}"
    ret, kinds = found[entry]
    want = tuple(_KIND[t] for t in entries[entry])
    assert ret == "int", (entry, ret)     # every entry returns its error
    assert len(kinds) == len(want), (entry, len(kinds), len(want))
    assert kinds == want, [(i, k, w) for i, (k, w) in
                           enumerate(zip(kinds, want)) if k != w]


@pytest.mark.parametrize("lib", list(cuda_kernels._LIBS))
def test_each_library_exports_exactly_its_entries(lib):
    """Nothing exported goes unbound, nothing bound is missing, and the
    error-string helper takes one int."""
    sources, entries = cuda_kernels._LIBS[lib]
    found = _library_functions(sources)
    name, kinds = _ERROR_STRING
    assert found.pop(name)[1] == kinds
    assert set(found) == set(entries)


def test_the_parser_sees_a_swapped_parameter():
    """A ``long long`` where ctypes expects ``int`` (and a pointer count
    off by one) changes the parsed kinds, so the checks above would
    fail on it."""
    src = '''
    namespace { int helper(int a) { return a; } }
    extern "C" {
    // a comment (with parentheses)
    int f(int dtype, const void* q, long long sqb, float scale,
          void* stream) {
      if (dtype) { return helper(1); }
      return 0;
    }
    const char* g(int code) { return nullptr; }
    }  // extern "C"
    '''
    found = extern_c_functions(src)
    assert found == {"f": ("int", ("int", "ptr", "long long", "float",
                                   "ptr")),
                     "g": ("const char*", ("int",))}
    swapped = src.replace("long long sqb", "int sqb")
    assert extern_c_functions(swapped)["f"][1] != found["f"][1]
    with pytest.raises(ValueError, match="no ctypes kind"):
        extern_c_functions(src.replace("float scale", "double scale"))
