"""The port's content-addressed compile store
(``deeplearning4j_tpu_torch/perf/compile_store.py``) on the CPU: twins of
the nine tests of ``tests/test_compile_store.py`` — fence semantics,
corruption quarantine, crash consistency under kill -9 mid-``put``, the
flag's gating and the build cache's routing through the store's fenced
``kernels/`` plane — and the library check of ``ops/cuda_build.py``: a
damaged library is quarantined and built again, never loaded.

The fence is (store format, torch + CUDA version, device capability) in
place of the JAX store's (jaxlib, topology).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from deeplearning4j_tpu_torch.perf.compile_store import (CORRUPT_DIR,
                                                         ENTRY_SUFFIX,
                                                         MAGIC,
                                                         CompileStore,
                                                         from_env,
                                                         program_fingerprint)

REPO = Path(__file__).resolve().parent.parent


def _store(root, torch_version="2.0+cuda12", capability="cpu"):
    return CompileStore(root, torch_version=torch_version,
                        capability=capability)


# -- fingerprint + round trip --------------------------------------------------
def test_fingerprint_stable_and_order_insensitive():
    a = program_fingerprint(buckets=[8, 16], block=8, spec_k=2)
    b = program_fingerprint(spec_k=2, block=8, buckets=[8, 16])
    assert a == b and len(a) == 64
    assert a != program_fingerprint(buckets=[8, 32], block=8, spec_k=2)


def test_put_get_roundtrip_and_counters(tmp_path):
    store = _store(tmp_path)
    fp = program_fingerprint(model="m", buckets=[8])
    assert store.get(fp) is None                      # cold miss
    path = store.put(fp, b"payload-bytes")
    assert path.is_file() and path.suffix == ENTRY_SUFFIX
    assert store.get(fp) == b"payload-bytes"
    store.put(fp, b"v2")
    assert store.get(fp) == b"v2"
    c = store.counters()
    assert c["puts"] == 2 and c["hits"] == 2
    assert c["misses"] == 1 and c["quarantined"] == 0
    stats = store.stats()
    assert stats["objects"] == 1 and stats["fence"] == store.fence


def test_fence_mismatch_is_miss_not_damage(tmp_path):
    """Another torch/CUDA build or card reads a disjoint keyspace, and a
    same-path entry whose header names another universe is a miss left
    in place — never quarantined."""
    fp = program_fingerprint(model="m")
    old = _store(tmp_path, torch_version="2.10+cuda12.6",
                 capability="sm_90")
    old.put(fp, b"old-binary-artifact")
    new = _store(tmp_path, torch_version="2.11+cuda12.8",
                 capability="sm_90")
    assert new.fence != old.fence
    assert new.get(fp) is None
    assert old.get(fp) == b"old-binary-artifact"
    new.entry_path(fp).write_bytes(old.entry_path(fp).read_bytes())
    assert new.get(fp) is None
    assert new.counters()["quarantined"] == 0
    assert new.entry_path(fp).is_file()


def _corrupt(path: Path, mutate):
    path.write_bytes(mutate(path.read_bytes()))


def test_corrupt_entries_quarantined_then_recompile_path(tmp_path):
    store = _store(tmp_path)
    cases = [
        ("magic", lambda b: b"XXXX" + b[4:]),
        ("trunc", lambda b: b[:len(MAGIC) + 3]),
        ("header", lambda b: b.replace(MAGIC, MAGIC + b"not json", 1)),
        ("crc", lambda b: b[:-2] + bytes([b[-2] ^ 0xFF]) + b[-1:]),
    ]
    for i, (name, mutate) in enumerate(cases):
        fp = program_fingerprint(case=name)
        store.put(fp, b"payload-%d" % i + b"x" * 64)
        _corrupt(store.entry_path(fp), mutate)
        assert store.get(fp) is None, name
        assert not store.entry_path(fp).exists(), name
        store.put(fp, b"recompiled")
        assert store.get(fp) == b"recompiled", name
    assert store.counters()["quarantined"] == len(cases)
    quarantined = list((store.fence_dir / CORRUPT_DIR).iterdir())
    assert len(quarantined) == len(cases)


def test_quarantine_never_clobbers_prior_evidence(tmp_path):
    store = _store(tmp_path)
    fp = program_fingerprint(case="twice")
    for _ in range(2):
        store.put(fp, b"p" * 32)
        _corrupt(store.entry_path(fp), lambda b: b"XXXX" + b[4:])
        assert store.get(fp) is None
    names = [p.name for p in (store.fence_dir / CORRUPT_DIR).iterdir()]
    assert len(names) == 2 and len(set(names)) == 2


# -- crash consistency: kill -9 mid-put leaves old-or-absent ------------------
_KILL9_CHILD = r"""
import sys
sys.path.insert(0, %(repo)r)
from deeplearning4j_tpu_torch.perf.compile_store import CompileStore
store = CompileStore(%(root)r, torch_version="2.0+cuda12", capability="cpu")
fp = %(fp)r
print("READY", flush=True)
i = 0
while True:
    i += 1
    store.put(fp, (b"gen-%%08d|" %% i) + bytes([i %% 251]) * 65536)
    print("PUT %%d" %% i, flush=True)
"""


def test_kill9_mid_put_leaves_old_or_absent(tmp_path):
    fp = program_fingerprint(sweep="kill9")
    for delay in (0.002, 0.01, 0.03):
        root = tmp_path / f"run_{int(delay * 1000)}"
        child = subprocess.Popen(
            [sys.executable, "-c", _KILL9_CHILD % {
                "repo": str(REPO), "root": str(root), "fp": fp}],
            stdout=subprocess.PIPE, text=True)
        puts = 0
        for line in child.stdout:
            if line.startswith("PUT"):
                puts += 1
                if puts >= 2:
                    break
        time.sleep(delay)
        child.kill()
        child.wait(timeout=60)
        child.stdout.close()
        store = _store(root)
        got = store.get(fp)
        if got is not None:
            assert got.startswith(b"gen-") and len(got) == 65549, \
                f"kill@{delay}: torn payload"
            gen = int(got[4:12])
            assert got[13:] == bytes([gen % 251]) * 65536, \
                f"kill@{delay}: cross-generation tear"
        assert store.counters()["quarantined"] == 0, \
            f"kill@{delay}: atomic publish still landed a torn entry"


# -- env gating + build-cache routing ------------------------------------------
def test_from_env_gating(tmp_path, monkeypatch):
    for off in ("", "0", "off", "none", "false", "disabled"):
        monkeypatch.setenv("DL4J_TPU_COMPILE_STORE", off)
        assert from_env() is None
    monkeypatch.delenv("DL4J_TPU_COMPILE_STORE", raising=False)
    assert from_env() is None
    monkeypatch.setenv("DL4J_TPU_COMPILE_STORE", str(tmp_path / "s"))
    store = from_env()
    assert store is not None
    assert store.root == tmp_path / "s"
    assert store.capability == "cpu"          # no card on this machine


_ROUTING_CHILD = r"""
import json, sys
sys.path.insert(0, %(repo)r)
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.perf import compile_cache
d = compile_cache.configure_from_env()
store = compile_cache.active_store()
lib = cuda_build.build("threshold_codec", ("threshold_codec.cu",))
print(json.dumps({
    "dir": d,
    "has_store": store is not None,
    "kernels_dir": str(store.kernels_dir) if store else None,
    "fence_in_stats": compile_cache.cache_stats().get("store_fence"),
    "lib_dir": str(lib.parent),
    "triton": (compile_cache.prepare_triton(),
               __import__("os").environ["TRITON_CACHE_DIR"])[1],
}))
"""


def _stub_nvcc(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "echo 'library' > \"$2\"\n")
    nvcc.chmod(0o755)
    return f"{bindir}:{os.environ.get('PATH', '/usr/bin:/bin')}"


def test_compile_store_routes_the_build_cache(tmp_path):
    """DL4J_TPU_COMPILE_STORE supersedes DL4J_TPU_COMPILE_CACHE: the
    store's fenced kernels/ plane becomes the build dir of the nvcc
    libraries, and Triton's cache sits under it."""
    env = dict(os.environ, DL4J_TPU_COMPILE_STORE=str(tmp_path / "store"),
               DL4J_TPU_COMPILE_CACHE=str(tmp_path / "cache"),
               PATH=_stub_nvcc(tmp_path))
    env.pop("TRITON_CACHE_DIR", None)
    r = subprocess.run(
        [sys.executable, "-c", _ROUTING_CHILD % {"repo": str(REPO)}],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["has_store"] is True
    assert out["dir"] == out["kernels_dir"] == out["lib_dir"]
    assert str(tmp_path / "store") in out["dir"]
    assert out["fence_in_stats"]
    assert out["triton"] == os.path.join(out["dir"], "triton")


def test_compile_store_off_keeps_the_default_build_dir(tmp_path):
    """Without the store and without DL4J_TPU_COMPILE_CACHE the builds go
    to the package's own _build/: nothing is written outside the
    checkout."""
    env = dict(os.environ, PATH=_stub_nvcc(tmp_path))
    env.pop("DL4J_TPU_COMPILE_STORE", None)
    env.pop("DL4J_TPU_COMPILE_CACHE", None)
    child = _ROUTING_CHILD.replace(
        'lib = cuda_build.build("threshold_codec", ("threshold_codec.cu",))',
        'lib = compile_cache.build_dir() / "x"')
    r = subprocess.run(
        [sys.executable, "-c", child % {"repo": str(REPO)}],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["dir"] is None and out["has_store"] is False
    assert out["lib_dir"] == str(REPO / "deeplearning4j_tpu_torch" /
                                 "_build")


def test_damaged_library_is_quarantined_and_built_again(tmp_path,
                                                        monkeypatch):
    """``ops/cuda_build.py`` records each library's size and CRC-32; a
    library that no longer matches it (torn or damaged) goes to
    ``corrupt/`` and nvcc runs again, and the build cache counts one
    miss for it; a whole one is a hit."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.perf import compile_cache
    monkeypatch.setenv("PATH", _stub_nvcc(tmp_path))
    monkeypatch.delenv("DL4J_TPU_COMPILE_STORE", raising=False)
    compile_cache.configure(cache_dir=str(tmp_path / "cache"))
    try:
        compile_cache.reset_counters()
        first = cuda_build.build("threshold_codec", ("threshold_codec.cu",))
        assert cuda_build.build("threshold_codec",
                                ("threshold_codec.cu",)) == first
        first.write_bytes(b"torn")
        again = cuda_build.build("threshold_codec", ("threshold_codec.cu",))
        assert again == first and again.read_bytes() == b"library\n"
        corrupt = list((tmp_path / "cache" / CORRUPT_DIR).iterdir())
        assert sorted(p.suffix for p in corrupt) == [".json", ".so"]
        assert compile_cache.counters() == {
            "compile_requests": 3, "persistent_hits": 1,
            "persistent_misses": 2}
    finally:
        compile_cache.configure_from_env()
