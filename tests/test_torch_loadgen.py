"""The port's serving load generator (``serving/loadgen.py``) on the CPU.

The request generators must give the JAX package's lists for the same
arguments (exact); ``run_trace`` drives a CPU gateway in each load model
and reports the JAX package's keys; the reports run on the device the
caller names (here the CPU, at a few requests). No tolerance is needed:
the checks are counts, keys and equal arrays.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import loadgen as jax_loadgen
from deeplearning4j_tpu_torch.serving import loadgen
from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    model = CausalTransformerLM(vocab_size=64, hidden=32, n_layers=2,
                                n_heads=2, n_kv_heads=1, max_len=64, seed=9)
    return model, model.init_params(device="cpu")


def _same_requests(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert x["tenant"] == y["tenant"] and x["max_new"] == y["max_new"]
        assert x["prompt"].dtype == y["prompt"].dtype == np.int32
        np.testing.assert_array_equal(x["prompt"], y["prompt"])


@pytest.mark.parametrize("seed", [0, 5])
def test_request_generators_match_jax(seed):
    kw = dict(n_requests=7, max_new=9, vocab_size=100, seed=seed)
    _same_requests(loadgen.gen_requests(prompt_lens=(3, 20), **kw),
                   jax_loadgen.gen_requests(prompt_lens=(3, 20), **kw))
    shared = dict(prefix_len=40, suffix_lens=(2, 9),
                  tenants=("a", "b", "c"), **kw)
    mine = loadgen.gen_shared_prefix_requests(**shared)
    _same_requests(mine, jax_loadgen.gen_shared_prefix_requests(**shared))
    for r in mine:
        np.testing.assert_array_equal(r["prompt"][:40], mine[0]["prompt"][:40])


@pytest.mark.parametrize("mode", ["burst", "open", "closed"])
def test_run_trace_modes(tiny, mode):
    """Every load model serves the whole trace and reports the JAX
    package's keys (its ``run_trace`` driving the same kind of gateway
    gives the key set); a request the pool can never hold is counted as
    a submit error, not dropped silently."""
    model, params = tiny
    reqs = loadgen.gen_requests(n_requests=6, max_new=4, prompt_lens=(2, 8),
                                vocab_size=64, seed=1)
    gw = ServingGateway(model, params, max_slots=2, block=8, max_context=32,
                        queue_limit=16)
    gw.warmup(prompt_lens=range(1, 9))
    stats = loadgen.run_trace(gw, reqs, mode=mode, rate=500.0, clients=3)
    assert stats["mode"] == mode and stats["completed"] == 6
    assert stats["failed"] == 0 and stats["tokens"] == 24
    assert stats["ttft_p50_ms"] > 0 and stats["per_token_mean_ms"] > 0
    assert stats["prefix_hit_rate"] == 0 and stats["spec_accept_rate"] is None
    ref = jax_loadgen.run_trace(gw, reqs[:2], mode=mode, rate=500.0,
                                clients=2)
    assert set(stats) == set(ref)
    bad = [{"tenant": "t", "prompt": np.zeros(30, np.int32), "max_new": 8}]
    assert loadgen.run_trace(gw, bad, mode=mode)["submit_errors"] == 1
    gw.shutdown()
    with pytest.raises(ValueError, match="mode"):
        loadgen.run_trace(gw, reqs, mode="sideways")


def test_run_trace_counts_sharing_and_spec(tiny):
    """The shared-prefix trace through a spec + sharing gateway: every
    request after the first rides the prefix, the saved prefill tokens
    are counted, the accept rate is reported."""
    model, params = tiny
    reqs = loadgen.gen_shared_prefix_requests(
        n_requests=5, prefix_len=24, suffix_lens=(2, 6), max_new=6,
        vocab_size=64, seed=2)
    gw = ServingGateway(model, params, max_slots=4, block=8, max_context=48,
                        spec_k=4, prefix_sharing=True)
    gw.warmup(prompt_lens=range(1, 31))
    stats = loadgen.run_trace(gw, reqs, mode="burst")
    gw.shutdown()
    assert stats["completed"] == 5 and stats["tokens"] == 30
    assert stats["prefix_hit_rate"] == 0.8
    assert stats["prefill_tokens_saved"] == 4 * 24
    assert 0.0 <= stats["spec_accept_rate"] <= 1.0


def test_baseline_tokens_per_sec(tiny):
    model, params = tiny
    reqs = loadgen.gen_requests(n_requests=3, max_new=5, prompt_lens=(2, 8),
                                vocab_size=64)
    assert loadgen.baseline_tokens_per_sec(model, params, reqs,
                                           repeat=2) > 0


def test_reports_on_the_named_device():
    """``smoke_report`` and ``shared_prefix_report`` build their model on
    the device they are given (the CPU here) and serve every request;
    their keys are the JAX reports' but the retrace count (the port has
    no compile lifecycle yet)."""
    rep = loadgen.smoke_report(n_requests=4, max_new=4, max_slots=4,
                               device="cpu")
    assert rep["completed"] == 4 and rep["failed"] == 0
    assert rep["continuous_tokens_per_sec"] > 0 and rep["speedup"] > 0
    assert "(cpu)" in rep["model"] and rep["warmup"]["buckets"] == [16, 32]
    shared = loadgen.shared_prefix_report(n_requests=4, prefix_len=40,
                                          max_new=4, max_slots=4,
                                          device="cpu")
    assert shared["completed"] == 4 and shared["failed"] == 0
    assert shared["prefix_hit_rate"] == 0.75
    assert shared["prefill_tokens_saved"] == 3 * 32
    assert shared["ttft_speedup"] > 0
    assert shared["spec_accept_rate"] is not None
