"""The data-parallel slice on the CPU: the port's accumulator exchanges,
``ParallelWrapper`` in its four modes, the training masters and the Spark
facade, run in spawned gloo processes (``tests/torch_dp_worker.py``, one
per rank, world size 2 and a 2 × 2 mesh) against the JAX package's
``shard_map`` and ``ParallelWrapper`` on as many CPU devices, from the
same numpy gradients, batches and carried-across weights.

The ranks are started once per module (a module-scoped fixture) and run
while this process computes the JAX side; each check below reads their
results. The process group comes up through a file under the test's
temporary directory (no port), every rank runs torch on one thread and
imports no ``jax``.

Tolerances:
- the exchanges (``exchange``, ``exchange_async``, ``exchange_packed``,
  ``exchange_hierarchical``): none. From the same f32 gradients both
  packages encode with the same comparisons, sum two ternary values (in
  either order: IEEE addition commutes) and divide by the same count, so
  the decoded means, the residuals and the adapted τ are held bit for
  bit over two steps.
- the wrapper, every mode: losses 1e-5 relative per step (PR 2's band);
  the parameters after 3 steps 99.9 % within 1e-6 (PR 2's band) and all
  within 2 · lr · steps, the most two Adam trajectories of 3 steps of
  about lr each can part. Beyond 1e-4 (PR 2's bound for the rest):
  - SYNC and AVERAGING: at most 1e-5 of the elements (measured 1 of
    988 816). JAX sums the gradient over the global batch in one
    program, the port over each rank's rows and then over the ranks: an
    element whose gradient lies within f32 rounding of zero may point the
    other way, and Adam turns that into a step of about lr.
  - ENCODED and ASYNC: at most 1e-4 of the elements, the share of codes
    allowed to flip (measured 18 and 9 of 988 816). The encoding is
    discontinuous at |g| = τ, so an element whose gradient lies within
    f32 rounding of ±τ may take another code on the two sides.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu.parallel import compression as jcomp
from deeplearning4j_tpu.parallel import master as jmaster
from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano
from deeplearning4j_tpu_torch.parallel import master as pmaster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
KW = dict(vocab_size=16, max_len=64, seed=5)
MODES = ("sync", "encoded", "averaging", "async")
LOSS_RTOL = 1e-5
LR, STEPS = 3e-4, 3           # the model's AdamW learning rate
#: the share of parameters allowed beyond 1e-4, by mode
OFF_SHARE = {"sync": 1e-5, "averaging": 1e-5, "encoded": 1e-4,
             "async": 1e-4}
GRAD_SHAPES = {"b/c": (10001,), "w": (37, 53)}


def _flat(tree_, prefix):
    """``{prefix/a/b: array}`` of a nested dict of arrays."""
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _nested(flat):
    out = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def _inputs():
    """Per-rank gradients for two steps, three batches, JAX weights."""
    rng = np.random.default_rng(0)
    inp = {}
    for step in range(2):
        for rank in range(4):
            for key, shape in GRAD_SHAPES.items():
                inp[f"grads/s{step}/r{rank}/{key}"] = (
                    rng.standard_normal(shape) * 1e-3).astype(np.float32)
    for i in range(3):
        inp[f"x{i}"] = rng.integers(0, 16, (4, 24)).astype(np.int32)
        inp[f"y{i}"] = rng.integers(0, 16, (4, 24)).astype(np.int32)
    jnet = JaxGPTNano(**KW).init(seq_len=24)
    inp.update(_flat(jax.tree.map(np.asarray, jnet.params), "weights"))
    return inp


def _spawn(job, world, out_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"{job}-rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, job, str(rank), str(world), out_dir],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _collect(procs, job, out_dir, timeout):
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    ranks = []
    for rank, (p, _) in enumerate(procs):
        base = os.path.join(out_dir, f"{job}-rank{rank}")
        if p.returncode != 0:
            with open(base + ".log") as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{job} rank {rank} exited "
                                 f"{p.returncode}:\n{tail}")
        with open(base + ".json") as f:
            log = json.load(f)
        ranks.append((dict(np.load(base + ".npz")), log))
    return ranks


# -- the JAX side -------------------------------------------------------------
def _jax_exchange(method, init, n_dev, axes, inp, **kw):
    """Two steps of ``acc.<method>`` inside ``shard_map`` over ``n_dev``
    CPU devices laid out as ``axes``; per-device inputs and state carry a
    leading device axis. Returns {step: (out, state)} as numpy."""
    from jax import shard_map
    names = tuple(axes)
    mesh = Mesh(np.array(jax.devices()[:n_dev]).reshape(
        tuple(axes.values())), names)
    spec = P(names)
    acc = jcomp.EncodedGradientsAccumulator()

    def local(g, st):
        g, st = (jax.tree.map(lambda a: a[0], t) for t in (g, st))
        out, st = getattr(acc, method)(g, st, **kw)
        return (jax.tree.map(lambda a: a[None], out),
                jax.tree.map(lambda a: a[None], st))

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec, spec),
                           out_specs=(spec, spec), check_vma=False))
    grads = [_nested({k: np.stack([inp[f"grads/s{s}/r{r}/{k}"]
                                   for r in range(n_dev)])
                      for k in GRAD_SHAPES}) for s in range(2)]
    one = getattr(acc, init)(jax.tree.map(lambda a: a[0], grads[0]))
    state = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (n_dev,) + a.shape), one)
    res = {}
    for s in range(2):
        out, state = fn(grads[s], state)
        res[s] = (_flat(jax.tree.map(np.asarray, out), "out"),
                  _flat(jax.tree.map(np.asarray, state), "state"))
    return res


def _jax_wrappers(inp):
    """Each mode on 2 devices, one ``fit`` call a batch."""
    weights = _nested({k[len("weights/"):]: v for k, v in inp.items()
                       if k.startswith("weights/")})
    res = {}
    for mode in MODES:
        net = JaxGPTNano(**KW).init(seq_len=24)
        net.params = jax.tree.map(jnp.asarray, weights)
        w = JaxWrapper(net, workers=2, mode=mode, averaging_frequency=2,
                       prefetch_buffer=0)
        losses = []
        for i in range(3):
            w.fit([JaxDataSet(inp[f"x{i}"], inp[f"y{i}"])])
            losses.append(float(net.score_))
        res[mode] = (losses, _flat(jax.tree.map(np.asarray, net.params),
                                   "params"))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dp"))
    inp = _inputs()
    np.savez(os.path.join(out_dir, "inputs.npz"), **inp)
    dp2, mesh4 = _spawn("dp2", 2, out_dir), _spawn("mesh4", 4, out_dir)
    try:
        jax_ex = {m: _jax_exchange(m, init, 2, {"data": 2}, inp,
                                   axis_name="data")
                  for m, init in (("exchange", "init_state"),
                                  ("exchange_async", "init_async_state"),
                                  ("exchange_packed", "init_state"))}
        jax_ex["exchange_hierarchical"] = _jax_exchange(
            "exchange_hierarchical", "init_state", 4,
            {"slice": 2, "data": 2}, inp, intra_axis="data",
            cross_axis="slice")
        jax_w = _jax_wrappers(inp)
    finally:
        ranks2 = _collect(dp2, "dp2", out_dir, timeout=300)
        ranks4 = _collect(mesh4, "mesh4", out_dir, timeout=300)
    return dict(jax_ex=jax_ex, jax_w=jax_w, dp2=ranks2, mesh4=ranks4)


# -- the checks ---------------------------------------------------------------
def test_ranks_form_gloo_groups_and_named_axes(runs):
    for rank, (_, log) in enumerate(runs["dp2"]):
        assert log["backend"] == "gloo" and log["rank"] == rank
        assert log["mesh"] == [2, rank]
    for rank, (_, log) in enumerate(runs["mesh4"]):
        # ranks laid out row-major over {"slice": 2, "data": 2}
        assert log["mesh"] == {
            "slice": [rank // 2, [rank % 2, rank % 2 + 2]],
            "data": [rank % 2, [rank // 2 * 2, rank // 2 * 2 + 1]]}


@pytest.mark.parametrize("method,job", [
    ("exchange", "dp2"), ("exchange_async", "dp2"),
    ("exchange_packed", "dp2"), ("exchange_hierarchical", "mesh4")])
def test_exchange_is_bit_identical_to_jax(runs, method, job):
    """Decoded means, residuals (and in-flight updates) and τ of every
    rank, two steps: the second step carries the first's residuals (and,
    async, delivers the peers' first-step updates one step late)."""
    for s, (out, state) in runs["jax_ex"][method].items():
        for rank, (res, _) in enumerate(runs[job]):
            for name, ref in (*out.items(), *state.items()):
                got = res[f"{method}/s{s}/{name}"]
                np.testing.assert_array_equal(
                    got, ref[rank], err_msg=f"{method} step {s} rank "
                    f"{rank} {name}")


def _param_check(got, ref, off_share):
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert (d <= 1e-6).mean() >= 0.999, (d <= 1e-6).mean()
    assert (d > 1e-4).mean() <= off_share, (d > 1e-4).sum()
    assert d.max() <= 2 * LR * STEPS, d.max()


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_trains_as_jax(runs, mode):
    losses, ref = runs["jax_w"][mode]
    for rank, (res, log) in enumerate(runs["dp2"]):
        np.testing.assert_allclose(log[f"wrapper/{mode}/losses"], losses,
                                   rtol=LOSS_RTOL, atol=0)
        assert log[f"wrapper/{mode}/iteration"] == 3
        got = {k.replace(f"wrapper/{mode}/", ""): v for k, v in res.items()
               if k.startswith(f"wrapper/{mode}/params/")}
        assert set(got) == set(ref)
        _param_check(got, ref, OFF_SHARE[mode])
    # every rank ends with the same weights (SYNC and ENCODED apply the
    # same update; AVERAGING and ASYNC fold their replicas back)
    (a, _), (b, _) = runs["dp2"]
    for k in a:
        if k.startswith(f"wrapper/{mode}/params/"):
            np.testing.assert_array_equal(a[k], b[k])


def test_shared_training_master_makes_an_encoded_wrapper(runs):
    mode, tau, clip, js = runs["dp2"][0][1]["master/shared"]
    assert (mode, tau, clip) == ("encoded", 1e-3, 5.0)
    assert js == {"@class": "SharedTrainingMaster",
                  "batch_size_per_worker": 2, "threshold": 1e-3,
                  "residual_clip": 5.0, "prefetch_num_batches": 2}


@pytest.mark.parametrize("name,mode", [("shared", "encoded"),
                                       ("averaging", "averaging")])
def test_spark_fit_equals_the_wrapper(runs, name, mode):
    """``SparkDl4jMultiLayer.fit_datasets`` over the master is the
    wrapper's mode over the same batches, to the bit."""
    for res, log in runs["dp2"]:
        for k, v in res.items():
            if k.startswith(f"wrapper/{mode}/params/"):
                np.testing.assert_array_equal(
                    res[k.replace(f"wrapper/{mode}", f"spark/{name}")], v)
        assert log[f"spark/{name}/score"] == \
            log[f"wrapper/{mode}/losses"][-1]
    stats = runs["dp2"][0][1]["spark/averaging/stats"]
    assert len(stats) == 1 and stats[0]["iterations"] == 3


REFUSED = {
    "warmup": "compile-lifecycle slice",
    "checkpoint_tree": "resilience slice",
    "checkpoint_target": "resilience slice",
    "load_checkpoint_tree": "resilience slice",
    "load_gathered_tree": "resilience slice",
    "elastic": "resilience slice", "numerics": "observatories slice",
    "elastic_init": "resilience slice",
}
BAD_ARGS = {"bad_mode": "unknown mode", "mesh_size": "needs 3 ranks",
            "workers": "needs 3 ranks", "cuda_in_gloo": "CUDA tensor",
            "sharded_not_sync": "SYNC-mode",
            "overlap_alone": "set sharded_update=True"}


def test_refused_options_raise_naming_their_slice(runs):
    msgs = runs["dp2"][0][1]["refused"]
    assert set(msgs) == set(REFUSED) | set(BAD_ARGS)
    for name, slice_ in REFUSED.items():
        assert msgs[name].startswith("NotImplementedError") \
            and slice_ in msgs[name], (name, msgs[name])
    for name, text in BAD_ARGS.items():
        assert msgs[name].startswith("ValueError") \
            and text in msgs[name], (name, msgs[name])


def test_masters_json_matches_jax():
    for cls in ("ParameterAveragingTrainingMaster", "SharedTrainingMaster"):
        jb = getattr(jmaster, cls).Builder(8)
        pb = getattr(pmaster, cls).Builder(8)
        if cls == "SharedTrainingMaster":
            jb, pb = jb.threshold(2e-3), pb.threshold(2e-3)
        else:
            jb, pb = jb.averaging_frequency(3), pb.averaging_frequency(3)
        assert pb.build().to_json() == jb.build().to_json()


def test_sharded_iterator_deals_batches_round_robin():
    base = list(range(7))
    for n in (1, 2, 3):
        shards = [pmaster.ShardedDataSetIterator(base, i, n)
                  for i in range(n)]
        ref = [jmaster.ShardedDataSetIterator(base, i, n)
               for i in range(n)]
        assert [list(s) for s in shards] == [list(s) for s in ref]
        assert [len(s) for s in shards] == [len(s) for s in ref]
    # no process group: this process is the only shard
    assert list(pmaster.ShardedDataSetIterator(base)) == base
