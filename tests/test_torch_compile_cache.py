"""The port's compile lifecycle (``deeplearning4j_tpu_torch/perf/``) on
the CPU: twins of every test of ``tests/test_compile_cache.py``, the
sentry's counters held name by name to the JAX package's for the same
calls, and warmup held to change nothing.

Contracts under test:

- after ``warmup()`` the first train step and the first request on every
  declared bucket add no trace (``sentry.total_traces``), served by the
  warmed signature (``aot_hits``);
- the sentry warns at budget + 1 distinct unplanned signatures and
  raises under ``strict``; declared signatures never count; dead
  networks leave the registry;
- the kernel build cache: ``cache_stats``'s keys, the routing flags, and
  a build honoured across processes (a stand-in ``nvcc`` on ``PATH``, as
  this machine has none);
- (``tests/test_torch_sentry_parity.py`` holds the counters to the
  JAX package's, entry point by entry point);
- ``fit`` after ``warmup`` equals ``fit`` alone to the bit (a dropout
  net, whose draws the warmup must not take), and a gateway's warmup
  leaves its pool and sampler as they were;
- the symbolic seeds of a capture (``perf.sentry.TapeSeed``) evaluate to
  the seeds the eager step computes;
- numbers reach a capturable program as 0-d tensors: a request's
  temperature does, and a Python int or float is refused.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.perf import (RetraceBudgetExceeded,
                                           WarmupSpec, compile_cache,
                                           sentry, warmup_plan)

REPO = Path(__file__).resolve().parents[1]

X4 = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
Y4 = np.array([[1, 0], [0, 1], [0, 1], [1, 0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(n_in=2, n_out=2, seed=42, dropout=0.0, lib="port"):
    conf_cls, it, dense, out, u = (
        (NeuralNetConfiguration, InputType, DenseLayer, OutputLayer, upd)
        if lib == "port" else (JConf, JIT, JDense, JOut, jupd))
    kw = {"dropout": dropout} if dropout else {}
    conf = (conf_cls.builder().seed(seed)
            .updater(u.Adam(learning_rate=0.05))
            .weight_init_fn("xavier").list()
            .layer(dense(n_out=8, activation="tanh", **kw))
            .layer(out(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(it.feed_forward(n_in)).build())
    if lib == "port":
        return MultiLayerNetwork(conf).init(device="cpu")
    return JNet(conf).init()


def _traces() -> int:
    """``sentry.total_traces()`` once the dead networks of earlier tests
    have left the registry (a collection inside a test would otherwise
    take their traces out of the total)."""
    import gc
    gc.collect()
    return sentry.total_traces()


def _stats(sentry_mod) -> dict:
    out = sentry_mod.stats()
    for v in out.values():
        v.pop("compile_time_s")
    return out


# -- warmup --------------------------------------------------------------------
def test_warmup_then_fit_and_serve_zero_new_traces():
    net = _mlp()
    sentry.reset()
    report = net.warmup([WarmupSpec(features=(4, 2), labels=(4, 2))])
    assert report["compiled"] == 2          # train step + output
    assert report["seconds"] > 0
    before = _traces()
    net.fit(X4, Y4)
    net.output(X4)
    assert sentry.total_traces() == before
    snap = sentry.stats()
    assert snap["MultiLayerNetwork.train_step"]["aot_hits"] == 1
    assert snap["MultiLayerNetwork.output"]["aot_hits"] == 1
    assert snap["MultiLayerNetwork.train_step"]["compiles"] == 0


def test_warmup_idempotent_and_declares_planned():
    net = _mlp()
    sentry.reset()
    spec = WarmupSpec(features=(4, 2), labels=(4, 2))
    net.warmup([spec])
    again = net.warmup([spec])
    assert again["compiled"] == 0
    snap = sentry.stats()["MultiLayerNetwork.train_step"]
    assert snap["planned_shapes"] >= 1
    assert snap["unplanned_shapes"] == 0


def test_warmup_every_declared_bucket_before_first_batch():
    net = _mlp()
    specs = warmup_plan([2, 4, 8], feature_dims=(2,), label_dims=(2,))
    assert [s.features for s in specs] == [(2, 2), (4, 2), (8, 2)]
    net.warmup(specs)
    before = _traces()
    for b in (2, 4, 8):
        net.fit(X4[:b] if b <= 4 else np.tile(X4, (2, 1)),
                Y4[:b] if b <= 4 else np.tile(Y4, (2, 1)))
        net.output(np.zeros((b, 2), np.float32))
    assert sentry.total_traces() == before


def _graph(lib="port", seed=7):
    conf_cls, it, dense, out, u = (
        (NeuralNetConfiguration, InputType, DenseLayer, OutputLayer, upd)
        if lib == "port" else (JConf, JIT, JDense, JOut, jupd))
    conf = (conf_cls.builder().seed(seed)
            .updater(u.Sgd(learning_rate=0.1))
            .graph_builder().add_inputs("in")
            .add_layer("d", dense(n_out=6, activation="tanh"), "in")
            .add_layer("out", out(n_out=3, activation="softmax",
                                  loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(**{"in": it.feed_forward(5)})
            .build())
    if lib == "port":
        return ComputationGraph(conf).init(device="cpu")
    return JGraph(conf).init()


def test_graph_warmup_zero_new_traces():
    net = _graph()
    net.warmup([WarmupSpec(features=(4, 5), labels=(4, 3))])
    before = _traces()
    x = np.random.default_rng(0).random((4, 5), np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    net.fit(x, y)
    net.output(x)
    assert sentry.total_traces() == before


def test_parallel_inference_warmup_covers_all_buckets():
    from deeplearning4j_tpu_torch.parallel.inference import \
        ParallelInference
    net = _mlp(n_in=3)
    pi = ParallelInference(net, buckets=(2, 4))
    try:
        report = pi.warmup(feature_shape=(3,))
        assert report["compiled"] == 2
        before = _traces()
        out = pi.output(np.ones((3, 3), np.float32))   # pads to 4
        assert np.asarray(out).shape == (3, 2)
        assert sentry.total_traces() == before
    finally:
        pi.shutdown()


def test_gpt_decode_warmup_zero_new_traces():
    from deeplearning4j_tpu_torch.zoo.gpt import GPTNano
    model = GPTNano(vocab_size=64, max_len=64)
    net = model.init(seq_len=32, device="cpu")
    report = model.warmup_decode(net, n_new=4, batch_sizes=(2,),
                                 prompt_lens=(10,))
    assert report["compiled"] == 1
    before = _traces()
    out = model.generate(net, np.ones((2, 10), np.int32), n_new=4)
    assert out.shape == (2, 14)
    assert sentry.total_traces() == before
    assert sentry.stats()["CausalTransformerLM.decode"]["aot_hits"] >= 1


def test_warmup_requires_initialized_network():
    from deeplearning4j_tpu_torch.perf.warmup import warmup_network

    class Empty:
        params = None
    with pytest.raises(RuntimeError, match="init"):
        warmup_network(Empty(), [])


# -- retrace sentry ------------------------------------------------------------
def test_sentry_triggers_at_budget_plus_one():
    fn = sentry.jit(lambda x: x + 1, name="_test_budget", budget=2)
    with sentry.strict():
        fn(torch.zeros(1))
        fn(torch.zeros(2))                  # 2 distinct: at budget, ok
        with pytest.raises(RetraceBudgetExceeded):
            fn(torch.zeros(3))              # budget+1 → storm


def test_sentry_warns_without_strict(caplog):
    fn = sentry.jit(lambda x: x * 2, name="_test_warn", budget=1)
    fn(torch.zeros(1))
    with caplog.at_level("WARNING", logger="deeplearning4j_tpu_torch.perf"):
        fn(torch.zeros(2))
    assert any("retrace storm" in r.message for r in caplog.records)


def test_warmed_shapes_never_count_against_budget():
    from deeplearning4j_tpu_torch.perf.warmup import sds
    fn = sentry.jit(lambda x: x - 1, name="_test_planned", budget=1)
    with sentry.strict():
        for n in (1, 2, 3, 4):
            fn.warmup(sds((n,), "float32", "cpu"))
        for n in (1, 2, 3, 4):
            fn(torch.zeros(n))


def test_registry_releases_dead_networks():
    import gc
    from deeplearning4j_tpu_torch.perf.sentry import _LOCK, _live_stats

    def make():
        net = _mlp(seed=11)
        net.fit(X4, Y4)
        net.output(X4)

    gc.collect()
    with _LOCK:
        n0 = len(_live_stats())
    make()
    gc.collect()
    with _LOCK:
        n1 = len(_live_stats())
    assert n1 == n0, "dead network's sentry ledgers were not released"


def test_strict_budget_override():
    fn = sentry.jit(lambda x: x, name="_test_override")
    with sentry.strict(budget=1):
        fn(torch.zeros(5))
        with pytest.raises(RetraceBudgetExceeded):
            fn(torch.zeros(6))


def test_tiny_fit_under_strict_sentry():
    net = _mlp(seed=3)
    it = [(X4, Y4)] * 3
    with sentry.strict(budget=8):
        net.fit(iter(it))
        net.output(X4)


# -- the kernel build cache ----------------------------------------------------
def test_cache_stats_shape():
    stats = compile_cache.cache_stats()
    assert {"dir", "enabled", "entries", "bytes", "compile_requests",
            "persistent_hits", "persistent_misses"} <= stats.keys()


def test_default_cache_gated_off_on_cpu(monkeypatch):
    """Without the variable the builds stay in the package's ``_build/``
    (the flag's default, the JAX package's XLA cache dir under HOME, is
    never applied), and 'off' keeps it so."""
    monkeypatch.delenv("DL4J_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("DL4J_TPU_COMPILE_STORE", raising=False)
    assert compile_cache.configure() is None
    assert compile_cache.build_dir() == compile_cache.DEFAULT_DIR
    monkeypatch.setenv("DL4J_TPU_COMPILE_CACHE", "off")
    assert compile_cache.configure() is None
    compile_cache.configure_from_env()


def test_configure_disable_values(tmp_path, monkeypatch):
    monkeypatch.delenv("DL4J_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("DL4J_TPU_COMPILE_STORE", raising=False)
    for off in ("", "0", "off", "none"):
        assert compile_cache.configure(cache_dir=off) is None
    active = compile_cache.configure(cache_dir=str(tmp_path / "cc"))
    assert active == str(tmp_path / "cc") and os.path.isdir(active)
    assert compile_cache.build_dir() == tmp_path / "cc"
    compile_cache.configure_from_env()
    assert compile_cache.cache_dir() is None


_CACHE_CHILD = r"""
import json, sys
sys.path.insert(0, %(repo)r)
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.perf import compile_cache
path = cuda_build.build("threshold_codec", ("threshold_codec.cu",))
print(json.dumps(dict(compile_cache.cache_stats(), lib=str(path))))
"""


def test_cache_populated_and_honored_across_processes(tmp_path):
    """Process 1 builds into DL4J_TPU_COMPILE_CACHE (a stand-in ``nvcc``
    writes the library); a FRESH process 2 asking for the same library
    runs no nvcc: every request is a hit."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls"
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        "while [ \"$1\" != -o ]; do shift; done\n"
        "echo 'library' > \"$2\"\n")
    nvcc.chmod(0o755)
    env = dict(os.environ, DL4J_TPU_COMPILE_CACHE=str(tmp_path / "cache"),
               PATH=f"{bindir}:{os.environ.get('PATH', '/usr/bin:/bin')}")
    env.pop("DL4J_TPU_COMPILE_STORE", None)

    def run():
        r = subprocess.run([sys.executable, "-c",
                            _CACHE_CHILD % {"repo": str(REPO)}],
                           cwd=REPO, env=env, timeout=120,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
        return json.loads(r.stdout.strip().splitlines()[-1])

    first = run()
    assert first["enabled"] and first["dir"] == str(tmp_path / "cache")
    assert first["entries"] > 0, first
    assert first["persistent_hits"] == 0 and first["compile_requests"] == 1
    second = run()
    assert second["persistent_hits"] > 0, second
    assert second["persistent_hits"] == second["compile_requests"]
    assert second["lib"] == first["lib"]
    assert len(calls.read_text().splitlines()) == 1     # one nvcc run


# -- warmup changes no state -----------------------------------------------------
def test_fit_after_warmup_equals_fit_alone_to_the_bit():
    """A dropout net: warmup (train step, K-step loop, output) takes no
    draw, moves no tree and no counter, so the fits after it give the
    parameters, optimizer state and losses of the fits alone."""
    rng = np.random.default_rng(4)
    data = [(rng.random((4, 3), np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)])
            for _ in range(3)]
    nets = [_mlp(n_in=3, dropout=0.3) for _ in range(2)]
    before = {k: v.clone() for k, v in nets[1].params["layer_0"].items()}
    nets[1].warmup([WarmupSpec(features=(4, 3), labels=(4, 2),
                               steps_per_loop=2)])
    assert nets[1].iteration == 0
    for k, v in nets[1].params["layer_0"].items():
        assert torch.equal(v, before[k])
    scores = []
    for net in nets:
        out = []
        for x, y in data:
            net.fit(x, y)
            out.append(net.score_)
        net.fit(iter(data[:2]), steps_per_loop=2)
        out.append(net.score_)
        scores.append(out)
    assert scores[0] == scores[1]
    from deeplearning4j_tpu_torch import tree
    for a, b in zip(tree.leaves(nets[0].params), tree.leaves(nets[1].params)):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(nets[0].opt_state),
                    tree.leaves(nets[1].opt_state)):
        assert torch.equal(a, b)


def test_gateway_warmup_leaves_pool_and_sampler_alone():
    """A sampled gateway's warmup writes no live page and draws nothing
    from the sampler: a burst after it gives the tokens of a burst on a
    gateway never warmed, and the pool outside the trash page is zero
    after the warmup."""
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    model = CausalTransformerLM(vocab_size=64, hidden=32, n_layers=2,
                                n_heads=2, n_kv_heads=1, max_len=64, seed=9)
    params = model.init_params(device="cpu")
    prompts = [np.arange(t, dtype=np.int32) % 64 for t in (3, 11, 20)]
    outs = []
    for warm in (False, True):
        gw = ServingGateway(model, params, max_slots=3, block=8,
                            max_context=32, default_max_new=6, sample=True,
                            top_k=8, seed=3)
        if warm:
            gw.warmup(prompt_lens=range(1, 25))
            for a in gw._sched.pager.pool:
                assert not a[:, 1:].any()
        gw.pause()
        streams = [gw.submit(p) for p in prompts]
        gw.resume()
        outs.append([st.result(timeout=120).tolist() for st in streams])
        gw.shutdown()
    assert outs[0] == outs[1]


def test_admissions_at_many_temperatures_share_one_prefill_a_bucket():
    """A request's temperature reaches the prefill programs as a 0-d
    tensor on the device, as the JAX scheduler passes it: admissions at
    several temperatures after a warmup add no trace and keep one
    signature a prompt bucket (on the card: one graph a bucket)."""
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    model = CausalTransformerLM(vocab_size=64, hidden=32, n_layers=2,
                                n_heads=2, n_kv_heads=1, max_len=64, seed=9)
    gw = ServingGateway(model, model.init_params(device="cpu"),
                        max_slots=3, block=8, max_context=32,
                        default_max_new=3, sample=True, top_k=8, seed=3)
    gw.warmup(prompt_lens=range(1, 25))
    traces = sentry.total_traces()
    gw.pause()
    streams = [gw.submit(np.arange(t, dtype=np.int32) % 64, temperature=temp)
               for t, temp in zip((3, 11, 20, 5, 17, 24),
                                  (0.3, 0.7, 1.0, 1.5, 2.0, 0.9))]
    gw.resume()
    for st in streams:
        st.result(timeout=120)
        assert st.error() is None
    gw.shutdown()
    assert sentry.total_traces() == traces
    fns = gw._sched._admit_fns
    assert sorted(fns) == [16, 32]
    for fn in fns.values():
        snap = fn.stats.snapshot()
        assert snap["distinct_shapes"] == 1 and snap["aot_hits"] >= 1, snap


def test_capturable_entry_point_refuses_python_numbers():
    """A Python int or float among a capturable entry point's arguments
    (its seeds apart) raises ``TypeError`` at the call and at warmup, on
    the CPU as on the card, where each value would capture a graph of
    its own; a flag (bool) passes, and so does a number given to an
    entry point that never captures."""
    fn = sentry.jit(lambda x, flag, seed: x + 1, name="_test_numbers",
                    capture=True, seeds=(2,))
    x = torch.zeros(2)
    assert torch.equal(fn(x, True, 7), torch.ones(2))
    for bad in (0.5, 3):
        with pytest.raises(TypeError, match="0-d tensors"):
            fn(x, bad, 7)
        with pytest.raises(TypeError, match="0-d tensors"):
            fn.warmup(x, bad, 7)
    assert sentry.stats()["_test_numbers"]["distinct_shapes"] == 1
    plain = sentry.jit(lambda x, t: x * t, name="_test_numbers_plain")
    assert torch.equal(plain(torch.ones(2), 0.5), torch.full((2,), 0.5))


# -- symbolic seeds -------------------------------------------------------------
def test_tape_seeds_evaluate_to_the_eager_seeds():
    """Under capture a step's seed is a ``TapeSeed``: split and fold as
    the forward splits and folds the integer, it evaluates at each
    replay to what the eager step computes from that replay's seed."""
    from deeplearning4j_tpu_torch.nn.layers.base import fold_in, split_seed
    from deeplearning4j_tpu_torch.perf.sentry import _Tape

    def chain(seed):
        a, b = split_seed(seed)
        c, d, e = split_seed(b, 3)
        return [a, fold_in(c, 5), e, fold_in(fold_in(d, 1), 2)]

    tape = _Tape()
    root = tape.root()
    sym = chain(root)
    for step_seed in (1234, 99, fold_in(7, 3)):
        memo: dict = {}
        assert [s.value([step_seed], memo) for s in sym] == chain(step_seed)
    with pytest.raises(TypeError, match="symbolic"):
        int(sym[0])


def test_perf_families_are_first_class():
    """The ``obs.metrics`` perf collector (twin of the families
    ``tests/test_obs.py:278-283`` reads): the sentry's traces, unplanned
    shapes, compiles and AOT hits per entry point, the build time and the
    kernel build cache's requests and hits, in the exposition."""
    from deeplearning4j_tpu_torch.obs import metrics
    net = _mlp(seed=5)
    net.warmup([WarmupSpec(features=(4, 2), labels=(4, 2))])
    net.fit(X4, Y4)
    fams = metrics.parse_exposition(metrics.REGISTRY.exposition())
    fn = (("function", "MultiLayerNetwork.train_step"),)
    assert fams[("dl4j_tpu_retrace_traces_total", fn)] >= 1
    assert ("dl4j_tpu_retrace_unplanned_shapes", fn) in fams
    assert ("dl4j_tpu_retrace_compiles_total", fn) in fams
    assert fams[("dl4j_tpu_aot_hits_total", fn)] >= 1
    for name in ("dl4j_tpu_compile_time_seconds_total",
                 "dl4j_tpu_compile_cache_requests_total",
                 "dl4j_tpu_compile_cache_hits_total"):
        assert any(k[0] == name for k in fams), name


def test_signature_keys_structure_shape_dtype_device():
    """A signature is the tree's structure and each tensor's shape, dtype
    and device — a stand-in signs as the tensor it stands for — and a
    Python value's type, not its value."""
    from deeplearning4j_tpu_torch.perf.warmup import sds
    sig = sentry.signature
    t = torch.zeros((2, 3))
    assert sig((t, None, {"a": 1})) == sig((sds((2, 3), "float32", "cpu"),
                                            None, {"a": 7}))
    assert sig((t,)) != sig((t.double(),))
    assert sig((t,)) != sig((torch.zeros((3, 2)),))
    assert sig((t, None)) != sig((t, t))
    assert sig(({"a": t},)) != sig(({"b": t},))
    assert sig((1,)) != sig((1.0,))


def test_eager_context_runs_the_function_and_keeps_the_counters():
    """``sentry.eager()`` (the eager half of a captured-vs-eager
    comparison) changes which executable runs, never the counters: a
    capturable entry point counts its first call and its hits alike."""
    calls = []
    fn = sentry.jit(lambda x: calls.append(1) or x + 1,
                    name="_test_eager", capture=True)
    with sentry.eager():
        assert torch.equal(fn(torch.zeros(2)), torch.ones(2))
    fn(torch.zeros(2))
    st = sentry.stats()["_test_eager"]
    assert (st["traces"], st["compiles"], st["aot_hits"]) == (1, 1, 0)
    assert len(calls) == 2 and fn.graphs() == 0
