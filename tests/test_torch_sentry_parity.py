"""The sentry's counters of the port held name by name to the JAX
package's (``deeplearning4j_tpu_torch/perf/sentry.py`` against
``deeplearning4j_tpu/perf/sentry.py``) on the CPU, and the serving
gateway's programs held to add no trace after their warmup.

For one call sequence each (warmup, fits or requests over three
buckets, an output, an unplanned shape, ``strict`` at budget + 1)
``sentry.stats()`` of the port equals the JAX package's in every
counter but ``compile_time_s`` — traces, distinct, planned and
unplanned shapes, compiles, warmed and AOT hits — for
``MultiLayerNetwork`` (train step, K-step loop, output), a tBPTT net
(tbptt step and loop), ``ComputationGraph`` (train step, K-step loop,
output), ``CausalTransformerLM.decode``, the serving scheduler's
programs (decode step, prefill, and with speculative decode and prefix
sharing the verify step, the suffix prefill and the page copy) and
``ParallelInference``; ``tests/test_torch_parallel.py`` holds the
wrapper's step so. Then twins of ``tests/test_serving.py:200``, ``:409``
and ``:832``: continuous-batching traffic, sampled decoding and
speculative decode with prefix sharing add no trace after the warmup,
under ``strict``.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JIT
from deeplearning4j_tpu.perf import WarmupSpec as JSpec
from deeplearning4j_tpu.perf import sentry as jsentry
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.perf import WarmupSpec, sentry
from deeplearning4j_tpu_torch.nn.config import InputType
from test_torch_compile_cache import _graph, _mlp, _stats, _traces


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the port's counters against the JAX package's -------------------------------
def _mln_sequence(lib):
    """warmup of two buckets, fits over three (4, 8, and 2 unplanned),
    output on a warmed bucket and an unplanned one, then ``strict`` at
    budget 2: a second unplanned output shape passes, a third raises."""
    s, spec = (sentry, WarmupSpec) if lib == "port" else (jsentry, JSpec)
    net = _mlp(n_in=3, dropout=0.2, lib=lib)
    s.reset()
    net.warmup([spec(features=(4, 3), labels=(4, 2), steps_per_loop=2),
                spec(features=(8, 3), labels=(8, 2))])
    rng = np.random.default_rng(0)
    batch = lambda b: (rng.random((b, 3), np.float32),
                       np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)])
    for b in (4, 8, 4, 2):
        net.fit(*batch(b))
    net.fit(iter([batch(4), batch(4), batch(4)]), steps_per_loop=2)
    net.output(rng.random((4, 3), np.float32))
    net.output(rng.random((5, 3), np.float32))
    with s.strict(budget=2):
        net.output(rng.random((6, 3), np.float32))
        with pytest.raises(s.RetraceBudgetExceeded):
            net.output(rng.random((7, 3), np.float32))
    return _stats(s)


def _graph_sequence(lib):
    s, spec = (sentry, WarmupSpec) if lib == "port" else (jsentry, JSpec)
    net = _graph(lib)
    s.reset()
    net.warmup([spec(features=(4, 5), labels=(4, 3), steps_per_loop=2)])
    rng = np.random.default_rng(1)
    batch = lambda b: (rng.random((b, 5), np.float32),
                       np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)])
    for b in (4, 6, 4):
        net.fit(*batch(b))
    net.fit(iter([([x], [y]) for x, y in (batch(4), batch(4))]),
            steps_per_loop=2)
    net.output(rng.random((4, 5), np.float32))
    with s.strict(budget=1):
        net.output(rng.random((3, 5), np.float32))
        with pytest.raises(s.RetraceBudgetExceeded):
            net.output(rng.random((2, 5), np.float32))
    return _stats(s)


def _tbptt_sequence(lib):
    """A tBPTT LSTM (segments of 4): a batch of 8 steps (two segments:
    the tbptt step, then the tbptt loop), one of 6 (a step a segment,
    the last one short), one of 8 again, then ``strict`` at budget 2: a
    batch of 3 rows is the tbptt step's fourth unplanned signature."""
    if lib == "port":
        from deeplearning4j_tpu_torch.nn import layers as L
        conf_cls, it, u, s = NeuralNetConfiguration, InputType, upd, sentry
    else:
        from deeplearning4j_tpu.nn import layers as L
        conf_cls, it, u, s = JConf, JIT, jupd, jsentry
    conf = (conf_cls.builder().seed(7).updater(u.Adam(learning_rate=0.02))
            .list().layer(L.LSTM(n_out=4))
            .layer(L.RnnOutputLayer(n_out=2, activation="softmax",
                                    loss="mcxent"))
            .backprop_type("TruncatedBPTT").tbptt_fwd_length(4)
            .tbptt_back_length(4).set_input_type(it.recurrent(3)).build())
    net = (MultiLayerNetwork(conf).init(device="cpu") if lib == "port"
           else JNet(conf).init())
    s.reset()
    rng = np.random.default_rng(2)
    batch = lambda t, b=2: (rng.random((b, t, 3), np.float32),
                            np.eye(2, dtype=np.float32)[
                                rng.integers(0, 2, (b, t))])
    for t in (8, 6, 8):
        net.fit(*batch(t))
    with s.strict(budget=2):
        with pytest.raises(s.RetraceBudgetExceeded):
            net.fit(*batch(8, b=3))
    return _stats(s)


def _decode_sequence(lib):
    kw = dict(vocab_size=64, hidden=32, n_layers=2, n_heads=2,
              n_kv_heads=1, max_len=64, seed=9)
    if lib == "port":
        from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
        s = sentry
        model = CausalTransformerLM(**kw)
        net = model.init(seq_len=32, device="cpu")
    else:
        from deeplearning4j_tpu.zoo.gpt import CausalTransformerLM
        s = jsentry
        model = CausalTransformerLM(**kw)
        net = model.init(seq_len=32)
    s.reset()
    model.warmup_decode(net, n_new=4, batch_sizes=(2,), prompt_lens=(10,))
    for b, t in ((2, 10), (2, 5), (1, 10)):
        model.generate(net, np.ones((b, t), np.int32), n_new=4)
    with s.strict(budget=0):
        with pytest.raises(s.RetraceBudgetExceeded):
            model.generate(net, np.ones((3, 10), np.int32), n_new=4)
    return _stats(s)


class _Req:
    """A duck-typed request for driving a scheduler directly."""

    def __init__(self, prompt, max_new):
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = max_new
        self.temperature = None
        self.eos_id = None
        self.tokens = []

    def push(self, tok):
        self.tokens.append(tok)

    def finish(self):
        pass

    def fail(self, exc):
        raise exc


def _scheduler_sequence(lib, spec_k=1, sharing=False):
    """The scheduler driven directly (no gateway thread, so the steps
    are the same on both sides): warmup over prompts of 1..24, three
    requests admitted and stepped out, three more (a prompt twice, a
    shared tail under prefix sharing, and one sharing its first 16
    tokens), a prompt of 40 tokens (the unplanned
    bucket 64), then ``strict`` at budget 0 on one of 100 (bucket
    128)."""
    if lib == "port":
        from deeplearning4j_tpu_torch.serving.scheduler import \
            DecodeScheduler
        from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
        s = sentry
    else:
        from deeplearning4j_tpu.serving.scheduler import DecodeScheduler
        from deeplearning4j_tpu.zoo.gpt import CausalTransformerLM
        s = jsentry
    model = CausalTransformerLM(vocab_size=64, hidden=32, n_layers=2,
                                n_heads=2, n_kv_heads=1, max_len=128,
                                seed=9)
    if lib == "port":
        # the JAX model's weights, so both decode the same tokens (the
        # speculative steps' count follows the accepted drafts)
        import jax
        from deeplearning4j_tpu.zoo.gpt import CausalTransformerLM as JLM
        jnet = JLM(vocab_size=64, hidden=32, n_layers=2, n_heads=2,
                   n_kv_heads=1, max_len=128, seed=9).init()
        params = model.params_from_jax(jax.tree.map(np.asarray,
                                                    jnet.params),
                                       device="cpu")
    else:
        params = model.init()
    sched = DecodeScheduler(model, params, max_slots=3, block=8,
                            max_context=128, spec_k=spec_k,
                            prefix_sharing=sharing)
    s.reset()
    sched.warmup(prompt_lens=range(1, 25))
    rng = np.random.default_rng(1)
    base = rng.integers(0, 64, 24)

    def serve(prompts):
        reqs = [_Req(p, 5) for p in prompts]
        pending = list(reqs)
        while pending or sched.active_count():
            while pending and sched.admit(pending[0]):
                pending.pop(0)
            sched.step()
        return reqs

    serve([rng.integers(0, 64, int(t)) for t in (3, 17, 9)])
    serve([base, base, np.concatenate([base[:16], rng.integers(0, 64, 4)])])
    serve([rng.integers(0, 64, 40)])
    with s.strict(budget=0):
        with pytest.raises(s.RetraceBudgetExceeded):
            serve([rng.integers(0, 64, 100)])
    return _stats(s)


def _inference_sequence(lib):
    if lib == "port":
        from deeplearning4j_tpu_torch.parallel.inference import \
            ParallelInference
        s = sentry
    else:
        from deeplearning4j_tpu.parallel.inference import ParallelInference
        s = jsentry
    net = _mlp(n_in=3, lib=lib)
    s.reset()
    pi = ParallelInference(net, buckets=(2, 4), mode="inplace")
    try:
        pi.warmup(feature_shape=(3,))
        for n in (1, 2, 4, 3):
            pi.output(np.ones((n, 3), np.float32))
        pi.output(np.ones((6, 3), np.float32))    # past the buckets
        with s.strict(budget=1):
            with pytest.raises(s.RetraceBudgetExceeded):
                net.output(np.ones((7, 3), np.float32))
    finally:
        pi.shutdown()
    return _stats(s)


SEQUENCES = {
    "multilayer": _mln_sequence,
    "graph": _graph_sequence,
    "tbptt": _tbptt_sequence,
    "decode": _decode_sequence,
    "scheduler": _scheduler_sequence,
    "scheduler_spec_sharing": lambda lib: _scheduler_sequence(
        lib, spec_k=2, sharing=True),
    "parallel_inference": _inference_sequence,
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_sentry_stats_match_jax(case):
    """One call sequence through both packages: ``sentry.stats()`` equal
    name by name in traces, distinct, planned and unplanned shapes,
    compiles, warmed and aot_hits."""
    want = SEQUENCES[case]("jax")
    got = SEQUENCES[case]("port")
    assert got == want


# -- the gateway: zero traces after warmup (twins of tests/test_serving.py) --
def _tiny_lm():
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    model = CausalTransformerLM(vocab_size=64, hidden=32, n_layers=2,
                                n_heads=2, n_kv_heads=1, max_len=64, seed=9)
    return model, model.init_params(device="cpu")


def test_zero_retraces_after_warmup():
    """Twin of ``tests/test_serving.py:200``: continuous-batching traffic
    over every warmed prompt bucket adds no trace under ``strict``."""
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    model, params = _tiny_lm()
    gw = ServingGateway(model, params, max_slots=3, block=8,
                        max_context=32, default_max_new=6)
    gw.warmup(prompt_lens=range(1, 25))
    before = _traces()
    rng = np.random.default_rng(1)
    with sentry.strict():
        streams = [gw.submit(rng.integers(0, 64, int(t)), max_new=6)
                   for t in rng.integers(1, 25, 12)]
        for st in streams:
            st.result(timeout=120)
    assert sentry.total_traces() == before
    gw.shutdown()


def test_sampled_decoding_serves_without_retraces():
    """Twin of ``tests/test_serving.py:409``: a sampled gateway (top-k,
    nucleus, a per-request temperature) serves warmed buckets without a
    trace, every token in the vocabulary."""
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    model, params = _tiny_lm()
    gw = ServingGateway(model, params, max_slots=2, block=8,
                        max_context=32, default_max_new=6, sample=True,
                        top_k=8, top_p=0.9, seed=3)
    gw.warmup(prompt_lens=(4, 20))
    before = _traces()
    outs = []
    for t in (4, 17):
        st = gw.submit(np.zeros(t, np.int32), temperature=0.8)
        outs.append(st.result(timeout=120))
    assert sentry.total_traces() == before
    for t, o in zip((4, 17), outs):
        gen = o[t:]
        assert gen.shape == (6,)
        assert ((gen >= 0) & (gen < model.vocab_size)).all()
    gw.shutdown()


def test_spec_and_sharing_zero_retraces_after_warmup():
    """Twin of ``tests/test_serving.py:832``: speculative decode with
    prefix sharing — fresh prompts, exact repeats (a shared tail, so a
    page copy) and shared prefixes with novel suffixes — adds no trace
    after the warmup, under ``strict``."""
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    model, params = _tiny_lm()
    gw = ServingGateway(model, params, max_slots=3, block=8,
                        max_context=32, default_max_new=6, spec_k=2,
                        prefix_sharing=True)
    gw.warmup(prompt_lens=range(1, 25))
    before = _traces()
    rng = np.random.default_rng(1)
    base = rng.integers(0, 64, 24).astype(np.int32)
    with sentry.strict():
        streams = [gw.submit(rng.integers(0, 64, int(t)), max_new=6)
                   for t in rng.integers(1, 25, 6)]
        streams.append(gw.submit(base, max_new=6))
        streams.append(gw.submit(base, max_new=6))
        streams.append(gw.submit(
            np.concatenate([base[:16],
                            rng.integers(0, 64, 4).astype(np.int32)]),
            max_new=6))
        for st in streams:
            st.result(timeout=120)
    assert sentry.total_traces() == before
    gw._sched.pager.check_invariants()
    gw.shutdown()
