"""The ZeRO twins, shared by ``tests/test_torch_zero.py`` (n = 2) and
``tests/test_torch_zero_4.py`` (n = 4), which import these checks and
give the module fixture ``world``: the port's sharded update
(``ParallelWrapper(sharded_update=True)``, ``gather_overlap``,
``gather_opt_state``, ``parallel/zero.py``) run as gloo ranks
(``tests/torch_zero_worker.py``, one process per rank, a ``{"data": n}``
mesh) against the JAX package's ``ParallelWrapper(workers=n,
sharded_update=True)`` on as many of its CPU devices, from the same
numpy batches and carried-across weights; and C4's dropout masks. The
nets are the JAX tests' own: ``tests/test_sharded_update.py``'s dense
net (4-16-2, tanh, Adam 0.05) and ``tests/test_fused_kernels.py``'s
(16-32-4, relu, Adam 1e-3). Each rank is fed its block of rows of each
global batch, the rows ``P("data")`` gives its device in the JAX
wrapper. (One file for each n spreads the JAX side's compiles over two
test workers.)

The ranks start once per module (a module-scoped fixture) and run while
this process computes the JAX side; each rank runs torch on one thread
and imports no ``jax``.

Twins (the JAX test each stands for, in brackets):
- the trajectory, 12 steps [``test_sharded_update.py:69``]: against
  the port's replicated SYNC in the JAX test's band (losses 1e-5
  relative, params 1e-4 relative and 1e-6 absolute), and against the
  JAX sharded wrapper in ``tests/test_torch_parallel.py``'s bands for
  SYNC (losses 1e-5 relative a step; params 99.9 % within 1e-6, at most
  1e-5 of them past 1e-4, all within 2 · lr · steps);
- the flat reduce-scatter then all-gather against the all-reduce mean
  [``:93``], bit for bit. The reduce-scatter sums the same n terms of
  each element as the all-reduce, and gloo sums them in the same order
  in both (measured at n = 2 and 4 on the CPU, every element of 342 844
  equal); at n = 2 the sum of two terms is the same in either order.
  Also against the JAX ``pmean`` of the same values: bit for bit at
  n = 2; at n = 4 XLA adds in another order, so within 1 ulp a term;
- every rank's params equal to the bit [``:124``];
- the rank's moments [``:145``]: each moment leaf holds ``padded / n``
  elements, and the rank's optimizer bytes equal the JAX
  ``per_device_bytes(_dp_state, n)`` and the ``OPT_STATE_BYTES`` gauge;
- the refused options [``:171``]: the cross-leaf clip and a mode other
  than SYNC raise ``ValueError`` with the JAX package's message; so does
  ``gather_overlap`` without the sharded update;
- the overlap bit for bit equal to the end gather
  [``tests/test_fused_kernels.py:296``]; params assigned between fits
  feed the next overlap fit [``:322``]; a fit that raises still
  gathers ``net.params``;
- ``gather_opt_state`` against the JAX one (the step count exact; the
  moments in the trajectory's params band against their largest
  value);
- a resume: within the port, 8 steps equal 5 + ``gather_opt_state`` + a
  new net and wrapper + 3, bit for bit; from the JAX package's params
  and optimizer state after 5 sharded steps (carried across with
  ``opt_state_from_jax``), 3 more steps against the JAX wrapper's in the
  trajectory's bands;
- AdamW's decay mask by key name kept on the shards: sharded equals
  replicated;
- C4: dropout 0.5 under SYNC, the same rows on every rank: no rank's
  mask equals another's, the keep rate is 0.35–0.65, the params equal
  to the bit; a one-rank group's wrapper step equals ``net.fit``'s;
- ``zero_dp_report`` over the group.

JAX tests with no torch counterpart: ``test_sharded_update.py:212``
(buffer donation: PyTorch has no donation, the update allocates new
tensors); ``:185`` and ``tests/test_fused_kernels.py:357`` (``warmup``:
ROADMAP item A12); ``:244`` and ``:277`` (checkpoints: item A14).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu.parallel.zero import \
    per_device_bytes as jax_per_device_bytes
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

import torch_zero_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_zero_worker.py")
LOSS_RTOL = 1e-5
STEPS = 12                   # the trajectory: 3 epochs of 4 batches


def _flat(tree_, prefix):
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _under(res, prefix):
    """``{rest: array}`` of the keys ``prefix/rest`` of ``res``."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _sub(d, prefix):
    """The items of ``d`` whose keys start with ``prefix/``."""
    return {k: v for k, v in d.items() if k.startswith(prefix + "/")}


def _jax_net(kw, updater=None):
    b = (JaxConf.builder().seed(kw["seed"])
         .updater(updater or jupd.Adam(learning_rate=kw["lr"])))
    conf = (b.list()
            .layer(JaxDense(n_out=kw["hidden"], activation=kw["act"]))
            .layer(JaxOutput(n_out=kw["classes"], activation="softmax",
                             loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(kw["features"]))
            .build())
    return JaxNet(conf).init()


def _port_opt(jax_opt, kw):
    """A JAX optimizer state (the whole layout) in the port's layout,
    through ``opt_state_from_jax`` on a port net of the same kind."""
    b = (worker.NeuralNetConfiguration.builder().seed(kw["seed"])
         .updater(worker.upd.Adam(learning_rate=kw["lr"])).list()
         .layer(worker.DenseLayer(n_out=kw["hidden"], activation=kw["act"]))
         .layer(worker.OutputLayer(n_out=kw["classes"],
                                   activation="softmax", loss="mcxent"))
         .set_input_type(worker.InputType.feed_forward(kw["features"]))
         .build())
    net = MultiLayerNetwork(b).init(device="cpu")
    net.opt_state_from_jax(jax.tree.map(np.asarray, jax_opt))
    return tree.map_(lambda t: t.numpy(), net.opt_state)


def _inputs(world):
    rng = np.random.default_rng(0)
    inp = {}
    # tests/test_sharded_update.py _toy_data(): 256 rows, 4 batches of 64
    x = rng.normal(size=(256, 4)).astype(np.float32)
    inp["mlp/x"] = x
    inp["mlp/y"] = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    inp.update(_flat(jax.tree.map(np.asarray,
                                  _jax_net(worker.MLP).params),
                     "mlp/weights"))
    # tests/test_fused_kernels.py _toy_it(): one batch of 64
    rng = np.random.default_rng(0)
    inp["fk/x"] = rng.normal(size=(64, 16)).astype(np.float32)
    inp["fk/y"] = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    inp.update(_flat(jax.tree.map(np.asarray, _jax_net(worker.FK).params),
                     "fk/weights"))
    # tests/test_sharded_update.py:93's gradients: device r's slice
    rng = np.random.default_rng(3)
    for key, shape in (("l0/W", (5, 13)), ("l0/b", (13,))):
        g = rng.normal(size=(world,) + shape).astype(np.float32)
        for r in range(world):
            inp[f"rs/g/r{r}/{key}"] = g[r]
    rng = np.random.default_rng(4)
    inp["c4/x"] = rng.normal(size=(32, 4)).astype(np.float32)
    inp["c4/y"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    return inp


def _mlp_batches(inp):
    return [JaxDataSet(inp["mlp/x"][i:i + 64], inp["mlp/y"][i:i + 64])
            for i in range(0, 256, 64)]


def _jax_resume(inp, world):
    """The JAX sharded wrapper's 5 steps, then a new net and wrapper from
    their params and gathered moments, 3 more. The 5 steps' state goes
    into ``inp`` (in the port's layout) for the ranks."""
    data = _mlp_batches(inp)
    steps = data + data
    net = _jax_net(worker.MLP)
    w = JaxWrapper(net, workers=world, sharded_update=True,
                   prefetch_buffer=0)
    w.fit(steps[:5])
    params = jax.tree.map(np.asarray, net.params)
    opt5 = w.gather_opt_state()
    inp.update(_flat(params, "resume/jax/params"))
    inp.update(_flat(_port_opt(opt5, worker.MLP), "resume/jax/opt"))
    net2 = _jax_net(worker.MLP)
    net2.params = jax.tree.map(jnp.asarray, params)
    net2.opt_state = opt5
    w2 = JaxWrapper(net2, workers=world, sharded_update=True,
                    prefetch_buffer=0)
    w2.fit(steps[5:])
    return {"resume/after": _flat(jax.tree.map(np.asarray, net2.params),
                                  "params"),
            "resume/after_opt": _flat(
                _port_opt(w2.gather_opt_state(), worker.MLP), "opt")}


def _jax_zero(inp, world):
    """The JAX sharded wrapper on ``world`` devices: the trajectory (one
    ``fit`` a batch, its loss), its params, gathered optimizer state and
    per-device bytes; the refusals' messages; the ``:93`` fence's
    ``pmean``."""
    out = {}
    data = _mlp_batches(inp)
    net = _jax_net(worker.MLP)
    w = JaxWrapper(net, workers=world, sharded_update=True,
                   prefetch_buffer=0)
    losses = []
    for _ in range(3):
        for ds in data:
            w.fit([ds])
            losses.append(float(net.score_))
    out["losses"] = losses
    out["params"] = _flat(jax.tree.map(np.asarray, net.params), "params")
    out["opt"] = _flat(_port_opt(w.gather_opt_state(), worker.MLP), "opt")
    out["opt_bytes"] = jax_per_device_bytes(w._dp_state, world)
    # the refusals' messages
    msgs = {}
    conf = (JaxConf.builder().seed(42)
            .updater(jupd.Adam(learning_rate=0.05))
            .gradient_normalization("ClipL2PerParamType").list()
            .layer(JaxDense(n_out=16, activation="tanh"))
            .layer(JaxOutput(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    for name, fn in (
            ("cross_leaf_norm", lambda: JaxWrapper(
                JaxNet(conf).init(), workers=world,
                sharded_update=True)._prepare()),
            ("not_sync", lambda: JaxWrapper(
                _jax_net(worker.MLP), workers=world, mode="averaging",
                sharded_update=True)),
            ("overlap_alone", lambda: JaxWrapper(
                _jax_net(worker.MLP), workers=world,
                gather_overlap=True))):
        try:
            fn()
        except ValueError as e:
            msgs[name] = f"ValueError: {e}"
    out["refused"] = msgs
    # :93 — the pmean of the same per-device gradients
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    g = {"l0": {k: np.stack([inp[f"rs/g/r{r}/l0/{k}"]
                             for r in range(world)]) for k in ("W", "b")}}
    pm = jax.jit(jax.shard_map(
        lambda a: jax.tree.map(lambda t: jax.lax.pmean(t[0], "data"), a),
        mesh=mesh, in_specs=(P("data"),), out_specs=P(),
        check_vma=False))(g)
    out["pmean"] = _flat(jax.tree.map(np.asarray, pm), "rs")
    out["abs_sum"] = {f"l0/{k}": np.abs(v).sum(0, dtype=np.float32)
                      for k, v in g["l0"].items()}
    return out


def _spawn(world, out_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"zero-rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, "zero", str(rank), str(world),
             out_dir], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _collect(procs, out_dir, timeout):
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
        base = os.path.join(out_dir, f"zero-rank{rank}")
        if p.returncode != 0:
            with open(base + ".log") as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"zero rank {rank} exited "
                                 f"{p.returncode}:\n{tail}")
        with open(base + ".json") as f:
            log = json.load(f)
        ranks.append((dict(np.load(base + ".npz")), log))
    return ranks


def zero_runs(world, tmp_path_factory, more_inputs=None, more_jax=None):
    """Write the inputs (``more_inputs(inp)`` adds to them), start the
    ranks, run the JAX side meanwhile (``more_jax(inp)`` adds to it) and
    collect both: ``{"world", "ranks", "jax"}``."""
    out_dir = str(tmp_path_factory.mktemp(f"zero{world}"))
    inp = _inputs(world)
    if more_inputs is not None:
        more_inputs(inp)
    ref = _jax_resume(inp, world)      # the ranks resume from its state
    np.savez(os.path.join(out_dir, "inputs.npz"), **inp)
    procs = _spawn(world, out_dir)
    try:
        ref.update(_jax_zero(inp, world))
        if more_jax is not None:
            ref.update(more_jax(inp))
    finally:
        ranks = _collect(procs, out_dir, timeout=400)
    return {"world": world, "ranks": ranks, "jax": ref}


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    return zero_runs(world, tmp_path_factory)


# -- the checks ---------------------------------------------------------------
def _param_check(got, ref, lr, steps, off_share=1e-5):
    """``tests/test_torch_parallel.py``'s bands for two packages' Adam
    trajectories: 99.9 % within 1e-6, at most ``off_share`` past 1e-4,
    all within 2 · lr · steps."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert (d <= 1e-6).mean() >= 0.999, (d <= 1e-6).mean()
    assert (d > 1e-4).mean() <= off_share, (d > 1e-4).sum()
    assert d.max() <= 2 * lr * steps, d.max()


def test_sharded_matches_replicated_trajectory(runs):
    """[``test_sharded_update.py:69``] 12 steps of the sharded update on
    the replicated SYNC trajectory, in the JAX test's band."""
    for res, log in runs["ranks"]:
        assert log["traj/sh/iteration"] == log["traj/rep/iteration"] == 12
        np.testing.assert_allclose(log["traj/sh/losses"],
                                   log["traj/rep/losses"], rtol=1e-5,
                                   atol=1e-7)
        rep, sh = _under(res, "traj/rep/params"), _under(
            res, "traj/sh/params")
        assert set(rep) == set(sh) == {"layer_0/W", "layer_0/b",
                                       "layer_1/W", "layer_1/b"}
        for k in rep:
            np.testing.assert_allclose(sh[k], rep[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_sharded_trajectory_matches_jax(runs):
    """The port's sharded trajectory against the JAX sharded wrapper's
    on as many devices: every step's loss, the params after 12 steps."""
    ref = runs["jax"]
    for res, log in runs["ranks"]:
        np.testing.assert_allclose(log["traj/sh/losses"], ref["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        _param_check(_sub(_under(res, "traj/sh"), "params"), ref["params"],
                     worker.MLP["lr"], STEPS)


def test_scatter_gather_equals_the_mean(runs):
    """[``test_sharded_update.py:93``] The layout's reduce-scatter, mean
    and all-gather give every rank the all-reduce mean, bit for bit; and
    the JAX ``pmean`` of the same values: bit for bit at n = 2 (two terms
    sum alike in either order), within (n − 1) ulps of Σ|g| over n past
    that (each of the n − 1 additions rounds once, and XLA's CPU psum
    adds the n terms in another order than gloo: measured 1 ulp at n = 4
    on 28 of 65 elements)."""
    n = runs["world"]
    ref, abs_sum = runs["jax"]["pmean"], runs["jax"]["abs_sum"]
    for res, _ in runs["ranks"]:
        rt, pm = _under(res, "rs/roundtrip"), _under(res, "rs/pmean")
        assert set(rt) == set(pm) == {"l0/W", "l0/b"}
        for k in rt:
            np.testing.assert_array_equal(rt[k], pm[k], err_msg=k)
            if n == 2:
                np.testing.assert_array_equal(rt[k], ref[f"rs/{k}"],
                                              err_msg=k)
            else:
                band = (n - 1) * np.spacing(abs_sum[k]) / n
                assert (np.abs(rt[k] - ref[f"rs/{k}"]) <= band).all(), k


def test_ranks_hold_the_same_params(runs):
    """[``test_sharded_update.py:124``] Every rank reassembles the same
    params, under the end gather and under the overlap."""
    (a, _), *rest = runs["ranks"]
    for b, _ in rest:
        for prefix in ("traj/sh/params", "traj/ov/params",
                       "overlap/ov/params"):
            got, want = _under(b, prefix), _under(a, prefix)
            assert got and set(got) == set(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{prefix}/{k}")


def test_rank_holds_one_nth_of_the_moments(runs):
    """[``test_sharded_update.py:145``] Each moment leaf of a rank holds
    ``padded / n`` elements (the step counts stay scalars), the rank's
    optimizer bytes are the JAX ``per_device_bytes(_dp_state, n)``, the
    gauge reads them under ``layout=sharded``, and the whole moments
    left the device for host memory."""
    n = runs["world"]
    for _, log in runs["ranks"]:
        shards = dict(log["traj/sh/shards"])
        padded = log["traj/sh/padded"]
        moments = [k for k in shards if not k.endswith("count")]
        assert len(moments) == 2 * len(padded)
        for layer in ("layer_0", "layer_1"):
            assert shards[f"{layer}/count"] == []
        # mu and nu of each layer, in the params' leaf order
        want = [[p // n] for p in padded]
        assert [shards[k] for k in moments if "/mu/" in k] == want
        assert [shards[k] for k in moments if "/nu/" in k] == want
        assert log["traj/sh/opt_bytes"] == runs["jax"]["opt_bytes"]
        assert log["traj/sh/gauge"]["layout=sharded"] == \
            log["traj/sh/opt_bytes"]
        assert log["traj/sh/evicted_device"] == ["cpu"]


def test_refused_options_raise_as_jax(runs):
    """[``test_sharded_update.py:171``] The cross-leaf clip and a mode
    other than SYNC raise ``ValueError`` with the JAX package's message,
    as does ``gather_overlap`` without the sharded update."""
    ref = runs["jax"]["refused"]
    assert set(ref) == {"cross_leaf_norm", "not_sync", "overlap_alone"}
    for _, log in runs["ranks"]:
        msgs = log["refused"]
        for name, want in ref.items():
            assert msgs[name] == want, (name, msgs[name], want)
        assert "sharded_update" in msgs["cross_leaf_norm"]
        assert "SYNC" in msgs["not_sync"]


def test_overlap_equals_end_gather(runs):
    """[``tests/test_fused_kernels.py:296``] 8 steps with the gather at
    the top of the next step are the end-gather steps, bit for bit."""
    for res, _ in runs["ranks"]:
        sh, ov = (_under(res, f"overlap/{m}/params") for m in ("sh", "ov"))
        assert sh and set(sh) == set(ov)
        for k in sh:
            np.testing.assert_array_equal(ov[k], sh[k], err_msg=k)
        tr, tov = (_under(res, f"traj/{m}/params") for m in ("sh", "ov"))
        for k in tr:
            np.testing.assert_array_equal(tov[k], tr[k], err_msg=k)


def test_overlap_respects_params_reassignment(runs):
    """[``tests/test_fused_kernels.py:322``] Params assigned between two
    overlap fits feed the next one: one step from zeros stays near zero
    (lr 1e-3), the continued run keeps initializer-scale weights."""
    for _, log in runs["ranks"]:
        w_cont = log["overlap/reassign/False"]
        w_zero = log["overlap/reassign/True"]
        assert w_zero < 0.05 < w_cont, (w_zero, w_cont)


def test_overlap_fit_that_raises_gathers_params(runs):
    """A batch below the agreed size raises at the third step on every
    rank; ``net.params`` is gathered on the way out: the two steps taken,
    bit for bit those of an end-gather fit of the same two batches."""
    for res, log in runs["ranks"]:
        assert log["overlap/raised/error"].startswith("ValueError") \
            and "smaller than the agreed" in log["overlap/raised/error"]
        assert log["overlap/raised/iteration"] == 2
        assert log["overlap/raised/stale"] is False
        two, raised = (_under(res, f"overlap/{m}/params")
                       for m in ("two", "raised"))
        assert two and set(two) == set(raised)
        for k in two:
            np.testing.assert_array_equal(raised[k], two[k], err_msg=k)


def _moments_check(got, ref):
    """Step counts exact; each moment leaf within 1e-4 of its largest
    value (the trajectory's relative band) of the reference."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, want in ref.items():
        if k.endswith("count"):
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            scale = np.abs(want).max()
            assert np.abs(got[k] - want).max() <= 1e-4 * scale, k


def test_gather_opt_state_matches_jax(runs):
    """``gather_opt_state`` after the trajectory's 12 sharded steps: the
    whole moments in ``net.opt_state``'s layout, against the JAX
    wrapper's gathered state."""
    for res, _ in runs["ranks"]:
        _moments_check(_sub(_under(res, "traj/sh"), "opt"),
                       runs["jax"]["opt"])


def test_resume_keeps_the_moments(runs):
    """8 sharded steps equal 5, ``gather_opt_state``, a new net and
    wrapper from those params and moments, and 3 more, bit for bit; and
    3 steps from the JAX wrapper's params and moments after 5 match the
    JAX wrapper's 3 more."""
    ref = runs["jax"]
    for res, log in runs["ranks"]:
        whole, port = (_under(res, f"resume/{m}/params")
                       for m in ("whole", "port"))
        assert whole and set(whole) == set(port)
        for k in whole:
            np.testing.assert_array_equal(port[k], whole[k], err_msg=k)
        _param_check(_under(res, "resume/jax_carried/params"),
                     _under(ref["resume/after"], "params"),
                     worker.MLP["lr"], 3)
        _moments_check(_sub(_under(res, "resume/jax_carried"), "opt"),
                       ref["resume/after_opt"])
        assert log["resume/iteration"] == 3


def test_adamw_decay_mask_kept_on_shards(runs):
    """AdamW with ``exclude_bias_and_norm`` (its mask by key name): the
    sharded update equals replicated SYNC, so the shards kept the keys
    (a layout that lost them would decay the biases)."""
    for res, _ in runs["ranks"]:
        rep, sh = (_under(res, f"adamw/{m}/params") for m in ("rep", "sh"))
        assert rep and set(rep) == set(sh)
        for k in rep:
            np.testing.assert_allclose(sh[k], rep[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_dropout_masks_differ_across_ranks(runs):
    """C4: under SYNC past one rank each rank draws its own dropout
    masks (every rank was fed the same rows), keeps about half at rate
    0.5, and the ranks end with the same params to the bit; a one-rank
    group's wrapper step is ``net.fit``'s, so the seed at world size 1
    is unchanged."""
    kept = [res["c4/kept"] for res, _ in runs["ranks"]]
    for i, a in enumerate(kept):
        assert 0.35 < a.mean() < 0.65, (i, a.mean())
        for b in kept[i + 1:]:
            assert a.shape == b.shape and not np.array_equal(a, b)
    params = [_under(res, "c4/params") for res, _ in runs["ranks"]]
    assert params[0]
    for p in params[1:]:
        assert p.keys() == params[0].keys()
        for k, v in p.items():
            np.testing.assert_array_equal(v, params[0][k], err_msg=k)
    for _, log in runs["ranks"]:
        assert log["c4/one_rank_equal"] is True


def test_zero_dp_report_over_the_group(runs):
    """``zero_dp_report`` over the gloo group: the three rows, the
    optimizer bytes of the sharded rows at about 1/n of the replicated
    (the step counts whole) and the sharded params on the replicated
    trajectory (the report's relative measure, within the JAX band)."""
    n = runs["world"]
    for _, log in runs["ranks"]:
        rep = log["report"]
        assert rep["n_ranks"] == n and rep["backend"] == "gloo"
        assert set(rep) >= {"replicated", "sharded", "sharded_overlap"}
        for row in ("replicated", "sharded", "sharded_overlap"):
            assert rep[row]["step_ms"] > 0
        assert rep["sharded"]["opt_state_bytes_per_rank"] == \
            rep["sharded_overlap"]["opt_state_bytes_per_rank"]
        assert 1 / n <= rep["opt_state_ratio"] < 1 / n + 0.01
        assert rep["max_param_rel_diff"] <= 1e-4
        assert rep["max_param_rel_diff_overlap"] <= 1e-4
