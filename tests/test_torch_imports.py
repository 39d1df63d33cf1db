"""The port stands alone: importing any of its modules loads neither
``jax`` nor the JAX package nor ``triton``, and initialises no CUDA
context; no source of the port (nor ``chip_smoke.py``) imports JAX or
the JAX package anywhere, not even inside a function."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_stays_light():
    mods = list(_modules())
    assert {"deeplearning4j_tpu_torch.serving.gateway",
            "deeplearning4j_tpu_torch.eval_.evaluation",
            "deeplearning4j_tpu_torch.data.iterators",
            "deeplearning4j_tpu_torch.environment",
            "deeplearning4j_tpu_torch.obs.trace",
            "deeplearning4j_tpu_torch.obs.health",
            "deeplearning4j_tpu_torch.resilience.faults",
            "deeplearning4j_tpu_torch.resilience.checkpoint",
            "deeplearning4j_tpu_torch.serialization",
            "deeplearning4j_tpu_torch.train.listeners",
            "deeplearning4j_tpu_torch.data.mnist",
            "deeplearning4j_tpu_torch.data.digits",
            "deeplearning4j_tpu_torch.data.normalizers",
            "deeplearning4j_tpu_torch.nn.preprocessors",
            "deeplearning4j_tpu_torch.nn.layers.conv",
            "deeplearning4j_tpu_torch.zoo.lenet",
            "deeplearning4j_tpu_torch.zoo.pretrained",
            "deeplearning4j_tpu_torch.nn.constraints",
            "deeplearning4j_tpu_torch.nn.layers.special",
            "deeplearning4j_tpu_torch.nn.layers.extra",
            "deeplearning4j_tpu_torch.nn.transferlearning",
            "deeplearning4j_tpu_torch.nlp",
            "deeplearning4j_tpu_torch.nlp.tokenization",
            "deeplearning4j_tpu_torch.nlp.bert_iterator",
            "deeplearning4j_tpu_torch.zoo.resnet",
            "deeplearning4j_tpu_torch.zoo.alexnet",
            "deeplearning4j_tpu_torch.zoo.vgg",
            "deeplearning4j_tpu_torch.zoo.simple_cnn",
            "deeplearning4j_tpu_torch.nn.layers.recurrent",
            "deeplearning4j_tpu_torch.zoo.textgen_lstm",
            "deeplearning4j_tpu_torch.perf",
            "deeplearning4j_tpu_torch.perf.sentry",
            "deeplearning4j_tpu_torch.perf.warmup",
            "deeplearning4j_tpu_torch.perf.compile_cache",
            "deeplearning4j_tpu_torch.perf.compile_store"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "print(json.dumps({'mods': sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'triton',\n"
        "                           'deeplearning4j_tpu')),\n"
        "    'cuda_init': torch.cuda.is_initialized()}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"mods": [], "cuda_init": False}


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_registry_rows_resolve_to_counted_kernels():
    """Every ported row resolves to a function with a launch counter and
    an existing source, and every main path it names (the ``sp``,
    ``zero``, ``dp_graph`` and ``eval`` paths included) is a phase
    ``chip_smoke.py`` drives."""
    import chip_smoke
    from deeplearning4j_tpu_torch.ops import kernel_registry
    paths = {p for e in kernel_registry.ported() for p in e.paths}
    assert {"sp", "zero", "dp_graph", "eval"} <= paths
    for e in kernel_registry.ported():
        assert set(e.paths) <= set(chip_smoke.PHASES), e.key
        fn = e.port_fn()
        assert isinstance(fn.launches, int)
        assert (ROOT / e.source).exists()
        before = fn.launches
        e.reset()
        assert fn.launches == 0
        fn.launches = before

