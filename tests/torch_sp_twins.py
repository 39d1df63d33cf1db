"""The sequence-parallel twins, shared by
``tests/test_torch_sequence_parallel.py`` (n = 2) and
``tests/test_torch_sequence_parallel_4.py`` (n = 4), which import these
checks and give the module fixture ``world``: the port's ring, zigzag
ring and Ulysses attention, the layer API under ``distributed_context``
and GPTNano trained sequence-parallel, run as gloo ranks
(``tests/torch_sp_worker.py``, one process per rank, a ``{"seq": n}``
mesh) against the JAX package on as many of its CPU devices
(``make_mesh({"seq": n})``), from the same numpy inputs and
carried-across weights. (One file for each n spreads the JAX side's
compiles, most of the time of each, over two test workers.)

Each rank holds only its shard of every sequence (the per-process rule
of ``deeplearning4j_tpu_torch/parallel/mesh.py``): the contiguous chunk
under ring and Ulysses, chunks (m, 2n−1−m) of 2n under zigzag. The
checks put the ranks' shards back in global order (by concatenation,
and the JAX ``zigzag_unpermute``) or compare a rank's rows with the JAX
global output's rows at that rank's positions.

The ranks start once per module (a module-scoped fixture) and run while
this process computes the JAX side; each rank runs torch on one thread
and imports no ``jax``.

Tolerances:
- attention (outputs and gradients): the reference tests' own bands,
  rtol 2e-4 and atol 2e-5 (atol 1e-5 where the JAX test has it).
- GPTNano in f32 from the JAX weights, against the JAX network on the
  same global batches: ``output`` (before training) within the
  attention band; the losses of 3 ``fit`` steps (the third batch
  padded) and then ``score`` of the padded batch within 2e-5 relative
  (the ring merges its blocks, and the ranks sum their shares, in
  another order than the JAX einsum; measured ≤ 2.6e-6);
  the parameters as ``tests/test_torch_parallel.py`` holds the
  data-parallel wrapper: 99.9 % within 1e-6, at most 1e-4 of them past
  1e-4 and all within 2 · lr · steps (Adam's step is ~lr wherever a
  gradient is within rounding of zero). Every rank's parameters are the
  same to the bit.
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
from deeplearning4j_tpu.nn.layers import MultiHeadAttention as JaxMHA
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu.parallel import (distributed_context, make_mesh,
                                         ring_self_attention,
                                         ulysses_self_attention,
                                         zigzag_permute,
                                         zigzag_ring_self_attention,
                                         zigzag_unpermute)
from deeplearning4j_tpu.parallel.ring_attention import zigzag_order
from deeplearning4j_tpu.zoo.gpt import GPTNano as JaxGPTNano

import torch_sp_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sp_worker.py")
LR = 3e-4                     # the model's AdamW learning rate
LM_RTOL = 2e-5


def _flat(tree_, prefix):
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


def _lengths_mask(lengths, b, t):
    lens = np.broadcast_to(np.asarray(lengths), (b,))
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    for name, (_, (b, t, h, hkv, d), _, lengths, self_attn, loss) in \
            worker.ATTN.items():
        inp[f"{name}/q"] = rng.standard_normal((b, t, h, d)).astype(
            np.float32)
        if not self_attn:
            for key in ("k", "v"):
                inp[f"{name}/{key}"] = rng.standard_normal(
                    (b, t, hkv, d)).astype(np.float32)
        if lengths is not None:
            inp[f"{name}/mask"] = _lengths_mask(lengths, b, t)
        if loss in ("co", "co_valid"):
            inp[f"{name}/co"] = rng.standard_normal((b, t, h, d)).astype(
                np.float32)
    layer = JaxMHA(n_in=16, n_out=16, n_heads=8, causal=True)
    params, _, _ = layer.init(jax.random.PRNGKey(0), (32, 16))
    inp.update(_flat(jax.tree.map(np.asarray, params), "layer/params"))
    inp["layer/x"] = rng.standard_normal((2, 32, 16)).astype(np.float32)
    inp["layer/mask"] = _lengths_mask((32, 21), 2, 32)
    pnet = _jax_pos_net(None)
    inp.update(_flat(jax.tree.map(np.asarray, pnet.params), "pos/weights"))
    jnet = JaxGPTNano(**worker.NANO).init(seq_len=worker.LM_T)
    inp.update(_flat(jax.tree.map(np.asarray, jnet.params), "lm/weights"))
    b, t = worker.LM_B, worker.LM_T
    for i in range(worker.LM_STEPS):
        toks = rng.integers(0, 16, (b, t + 1))
        inp[f"lm/x{i}"] = toks[:, :-1].astype(np.int32)
        inp[f"lm/y{i}"] = toks[:, 1:].astype(np.int32)
    mask = _lengths_mask((t, 21), b, t)
    inp["lm/fmask2"] = inp["lm/lmask2"] = mask
    return inp


def _spawn(world, out_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"sp{world}-rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, "sp", str(rank), str(world), out_dir],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _collect(procs, world, out_dir, timeout):
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
        base = os.path.join(out_dir, f"sp{world}-rank{rank}")
        if p.returncode != 0:
            with open(base + ".log") as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"sp rank {rank} of {world} exited "
                                 f"{p.returncode}:\n{tail}")
        with open(base + ".json") as f:
            log = json.load(f)
        ranks.append((dict(np.load(base + ".npz")), log))
    return ranks


# -- the JAX side -------------------------------------------------------------
def _jax_attn(inp, n):
    """Each case of ``worker.ATTN`` through the JAX function on a
    {"seq": n} mesh: the global output and the gradients of its loss."""
    mesh = make_mesh({"seq": n})
    res = {}
    for name, (mode, _, causal, lengths, self_attn, loss) in \
            worker.ATTN.items():
        q = jnp.asarray(inp[f"{name}/q"])
        k = q if self_attn else jnp.asarray(inp[f"{name}/k"])
        v = q if self_attn else jnp.asarray(inp[f"{name}/v"])
        mask = (None if lengths is None
                else jnp.asarray(inp[f"{name}/mask"]))

        def attend(q, k, v, mode=mode, causal=causal, mask=mask):
            if mode == "ring":
                return ring_self_attention(q, k, v, mesh, mask=mask,
                                           causal=causal)
            if mode == "ulysses":
                return ulysses_self_attention(q, k, v, mesh, mask=mask,
                                              causal=causal)
            zmask = None if mask is None else zigzag_permute(mask, n,
                                                             axis=1)
            return zigzag_unpermute(zigzag_ring_self_attention(
                zigzag_permute(q, n), zigzag_permute(k, n),
                zigzag_permute(v, n), mesh, mask=zmask), n)

        res[f"{name}/out"] = np.asarray(attend(q, k, v))
        if loss is None:
            continue
        if loss == "sq":
            total = lambda *a: jnp.sum(attend(*a) ** 2)
        else:
            co = jnp.asarray(inp[f"{name}/co"])
            if loss == "co_valid":
                co = co * mask[:, :, None, None]
            total = lambda *a, co=co: jnp.sum(attend(*a) * co)
        if self_attn:
            grads = (jax.grad(lambda x: total(x, x, x))(q),)
        else:
            grads = jax.grad(total, argnums=(0, 1, 2))(q, k, v)
        for key, g in zip(("dq", "dk", "dv"), grads):
            res[f"{name}/{key}"] = np.asarray(g)
    return res


def _jax_layers(inp, n):
    mesh = make_mesh({"seq": n})
    params = jax.tree.map(jnp.asarray, _nested(
        {k[len("layer/params/"):]: v for k, v in inp.items()
         if k.startswith("layer/params/")}))
    x, mask = jnp.asarray(inp["layer/x"]), jnp.asarray(inp["layer/mask"])
    res = {}
    for mode, masked in worker.LAYER:
        for rope in (False, True):
            layer = JaxMHA(n_in=16, n_out=16, n_heads=8, causal=True,
                           sequence_parallel=mode, rope=rope)
            with distributed_context(mesh):
                out, _ = layer.apply(params, {}, x,
                                     mask=mask if masked else None)
            res[(mode, masked, rope)] = np.asarray(out)
    return res


def _jax_pos_net(mode):
    from deeplearning4j_tpu.nn import layers
    from deeplearning4j_tpu.nn.config import (InputType,
                                              NeuralNetConfiguration)
    conf = worker.pos_conf(NeuralNetConfiguration.builder, layers, mode) \
        .set_input_type(InputType.recurrent(1, worker.LM_T)).build()
    return JaxMultiLayerNetwork(conf).init()


def _jax_pos(inp):
    """The positional-embedding net, local, from the same weights:
    ``output`` of the first batch, one ``fit`` step's loss and the
    positional table after it."""
    net = _jax_pos_net(None)
    net.params = jax.tree.map(jnp.asarray, _nested(
        {k[len("pos/weights/"):]: v for k, v in inp.items()
         if k.startswith("pos/weights/")}))
    output = np.asarray(net.output(inp["lm/x0"]))
    net.fit(inp["lm/x0"], inp["lm/y0"])
    return dict(output=output, loss=float(net.score_),
                table=np.asarray(net.params["layer_1"]["pos"]))


def _jax_lm(inp, clip=None):
    """GPTNano, local (no context), from the same weights: ``output`` of
    the first batch, then 3 fit steps on the same global batches (their
    losses and the parameters after them) and ``score`` of the padded
    one."""
    model = JaxGPTNano(**worker.NANO)
    conf = model.conf(worker.LM_T)
    if clip is not None:
        conf.gradient_normalization, \
            conf.gradient_normalization_threshold = clip
    net = JaxMultiLayerNetwork(conf).init()
    net.params = jax.tree.map(jnp.asarray, _nested(
        {k[len("lm/weights/"):]: v for k, v in inp.items()
         if k.startswith("lm/weights/")}))
    output = np.asarray(net.output(inp["lm/x0"]))
    losses = []
    for i in range(worker.LM_STEPS):
        kw = {}
        if f"lm/fmask{i}" in inp:
            kw = dict(features_mask=inp[f"lm/fmask{i}"],
                      labels_mask=inp[f"lm/lmask{i}"])
        net.fit(inp[f"lm/x{i}"], inp[f"lm/y{i}"], **kw)
        losses.append(float(net.score_))
    return dict(losses=losses,
                params=_flat(jax.tree.map(np.asarray, net.params),
                             "params"),
                output=output,
                score=net.score(JaxDataSet(inp["lm/x2"], inp["lm/y2"],
                                           inp["lm/fmask2"],
                                           inp["lm/lmask2"])))


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """The ranks of a {"seq": world} mesh, spawned once per module, and
    the JAX side computed meanwhile."""
    out_dir = str(tmp_path_factory.mktemp("sp"))
    inp = _inputs()
    np.savez(os.path.join(out_dir, "inputs.npz"), **inp)
    procs = _spawn(world, out_dir)
    try:
        jax_res = dict(attn=_jax_attn(inp, world),
                       layer=_jax_layers(inp, world), pos=_jax_pos(inp),
                       lm=_jax_lm(inp),
                       clip=_jax_lm(inp, worker.CLIP))
    finally:
        ranks = _collect(procs, world, out_dir, timeout=600)
    return dict(inp=inp, ranks=ranks, n=world, **jax_res)


def _positions(mode, n, m, t):
    """The global positions of rank m's tokens, from the JAX package's
    zigzag order (contiguous chunk m for ring and Ulysses)."""
    if mode != "zigzag_ring":
        return np.arange(m * t // n, (m + 1) * t // n)
    c = t // (2 * n)
    order = zigzag_order(n)
    return np.concatenate([np.arange(j * c, (j + 1) * c)
                           for j in order[2 * m:2 * m + 2]])


def _global(ranks, key, mode):
    """The ranks' shards of ``key`` put back in global order."""
    shards = [res[key] for res, _ in ranks]
    t = sum(s.shape[1] for s in shards)
    n = len(shards)
    out = np.empty((shards[0].shape[0], t) + shards[0].shape[2:],
                   shards[0].dtype)
    for m, s in enumerate(shards):
        out[:, _positions(mode, n, m, t)] = s
    return out


# -- the checks ---------------------------------------------------------------
def test_ranks_form_a_seq_context(runs):
    for rank, (_, log) in enumerate(runs["ranks"]):
        assert log["backend"] == "gloo"
        assert log["index"] == rank and log["context"] == [runs["n"], rank]


#: case -> (twin of, atol of its forward check)
ATTN_TWINS = {
    "ring_full": ("test_parallel.py:254", 2e-5),
    "ring_masked": ("test_parallel.py:271", 2e-5),
    "ring_causal": ("test_parallel.py:377", 1e-5),
    "ring_causal_grads": ("test_parallel.py:396", 2e-5),
    "ring_masked_grads": ("test_parallel.py:423", 2e-5),
    "ring_causal_masked": ("test_parallel.py:442", 2e-5),
    "zz_causal": ("test_parallel.py:460", 1e-5),
    "zz_grads": ("test_parallel.py:484", 2e-5),
    "zz_masked": ("test_parallel.py:509", 1e-5),
    "zz_masked_grads": ("test_parallel.py:535", 2e-5),
    "ring_gqa": ("test_gpt.py:156", 2e-5),
    "uly_full": ("test_parallel.py:752", 2e-5),
    "uly_causal": ("test_parallel.py:752", 2e-5),
    "uly_masked": ("test_parallel.py:752", 2e-5),
}


@pytest.mark.parametrize("name", list(worker.ATTN))
def test_attention_matches_jax(runs, name):
    """Each rank's output and gradients, put back in global order, equal
    the JAX function's at the same mesh size (on the valid rows of a
    causally masked forward, as the JAX test compares them)."""
    mode, _, causal, lengths, _, loss = worker.ATTN[name]
    ref, ranks = runs["attn"], runs["ranks"]
    valid = 1.0
    if lengths is not None and causal and loss is None:
        valid = runs["inp"][f"{name}/mask"][:, :, None, None]
    got = _global(ranks, f"{name}/out", mode)
    np.testing.assert_allclose(got * valid, ref[f"{name}/out"] * valid,
                               rtol=2e-4, atol=ATTN_TWINS[name][1],
                               err_msg=f"{name} out")
    for key in ("dq", "dk", "dv"):
        if f"{name}/{key}" in ref:
            np.testing.assert_allclose(
                _global(ranks, f"{name}/{key}", mode), ref[f"{name}/{key}"],
                rtol=2e-4, atol=2e-5, err_msg=f"{name} {key}")


def test_separate_processes_agree_on_the_gradient_checksum(runs):
    """``tests/test_multiprocess_sp.py:77``: the ranks are separate
    processes; the collective-reduced checksum sum |dL/dq| of the GQA
    causal ring is the same on every rank, and equals the JAX
    gradient's."""
    sums = [log["mp_gradsum"] for _, log in runs["ranks"]]
    assert len(set(sums)) == 1, sums
    want = float(np.abs(runs["attn"]["ring_gqa/dq"]).sum())
    assert abs(float(sums[0]) - want) <= 2e-4 * want, (sums[0], want)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("mode,masked", worker.LAYER)
def test_layer_api_on_the_rank_shard(runs, mode, masked, rope):
    """``MultiHeadAttention(sequence_parallel=mode)`` (``:574``, ``:596``;
    RoPE at the rank's global positions in the second half): each rank's
    rows equal the JAX layer's global output at that rank's positions,
    on the valid rows of a padded batch."""
    want = runs["layer"][(mode, masked, rope)]
    mask = runs["inp"]["layer/mask"] if masked else np.ones((2, 32))
    for m, (res, _) in enumerate(runs["ranks"]):
        pos = _positions(mode, runs["n"], m, 32)
        valid = mask[:, pos, None]
        got = res[f"layer/{mode}/{int(masked)}/{int(rope)}/out"]
        np.testing.assert_allclose(got * valid, want[:, pos] * valid,
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"rank {m}")


@pytest.mark.parametrize("mode", worker.MODES)
def test_learned_positions_at_the_rank_positions(runs, mode):
    """``PositionalEmbeddingLayer`` under the context adds the table's
    rows at the rank's global positions: the net's gathered ``output``
    equals the JAX net's, and after one ``fit`` step the loss and the
    whole table (each rank's gradient lands on its own rows, summed over
    the group) match."""
    ref = runs["pos"]
    for res, log in runs["ranks"]:
        np.testing.assert_allclose(res[f"pos/{mode}/output"],
                                   ref["output"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(log[f"pos/{mode}/loss"], ref["loss"],
                                   rtol=LM_RTOL, atol=0)
        np.testing.assert_allclose(res[f"pos/{mode}/table"], ref["table"],
                                   rtol=0, atol=2e-6)


def _param_check(got, ref):
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert (d <= 1e-6).mean() >= 0.999, (d <= 1e-6).mean()
    assert (d > 1e-4).mean() <= 1e-4, (d > 1e-4).sum()
    assert d.max() <= 2 * LR * worker.LM_STEPS, d.max()


@pytest.mark.parametrize("mode", worker.MODES)
def test_lm_fit_matches_jax(runs, mode):
    """GPTNano under the context: ``output`` (gathered to the global
    [B, T, V]), 3 ``fit`` steps (the third on a padded batch) and
    ``score`` of the padded batch, against the JAX network on the same
    global batches; the ranks end with the same parameters to the
    bit."""
    ref, ranks = runs["lm"], runs["ranks"]
    for res, log in ranks:
        np.testing.assert_allclose(res[f"lm/{mode}/output"], ref["output"],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(log[f"lm/{mode}/losses"], ref["losses"],
                                   rtol=LM_RTOL, atol=0)
        np.testing.assert_allclose(log[f"lm/{mode}/score"], ref["score"],
                                   rtol=LM_RTOL, atol=0)
        got = {k.replace(f"lm/{mode}/", ""): v for k, v in res.items()
               if k.startswith(f"lm/{mode}/params/")}
        assert set(got) == set(ref["params"])
        _param_check(got, ref["params"])
    first = ranks[0][0]
    for res, _ in ranks[1:]:
        for k, v in first.items():
            if k.startswith(f"lm/{mode}/params/"):
                np.testing.assert_array_equal(res[k], v, err_msg=k)


def test_gradient_clipping_sees_the_global_gradient(runs):
    """Per-layer L2 clipping at a threshold every layer exceeds: the
    norm is that of the group's summed gradient, so the steps equal the
    JAX network's."""
    ref = runs["clip"]
    for res, log in runs["ranks"]:
        np.testing.assert_allclose(log["lm/clip/losses"], ref["losses"],
                                   rtol=LM_RTOL, atol=0)
        got = {k.replace("lm/clip/", ""): v for k, v in res.items()
               if k.startswith("lm/clip/params/")}
        _param_check(got, ref["params"])


def test_lm_trains_under_the_context(runs):
    """``tests/test_gpt.py:183``: 10 steps of GPTNano in ring mode under
    the context, every loss finite and the last below the first, on
    every rank alike."""
    losses = [log["trains/losses"] for _, log in runs["ranks"]]
    assert all(l == losses[0] for l in losses)
    assert np.isfinite(losses[0]).all() and losses[0][-1] < losses[0][0]


def test_dropout_masks_differ_across_ranks(runs):
    """Dropout under the context: each rank draws its own shard's mask
    (none is another rank's), keeps about half of it at rate 0.5, and
    the ranks still end with the same parameters to the bit."""
    kept = [res["dropout/kept"] for res, _ in runs["ranks"]]
    for i, a in enumerate(kept):
        assert 0.35 < a.mean() < 0.65, (i, a.mean())
        for b in kept[i + 1:]:
            assert a.shape == b.shape and not np.array_equal(a, b)
    params = [{k: v for k, v in res.items()
               if k.startswith("dropout/params/")}
              for res, _ in runs["ranks"]]
    assert params[0]
    for p in params[1:]:
        assert p.keys() == params[0].keys()
        for k, v in p.items():
            np.testing.assert_array_equal(v, params[0][k], err_msg=k)


REFUSED = {
    "batch_axis": ("NotImplementedError", "item A3"),
    "head_axis": ("NotImplementedError", "item A3"),
    "multi_axis": ("NotImplementedError", "item A3"),
    "ring_batch_axis": ("NotImplementedError", "item A3"),
    "pooling": ("NotImplementedError", "item A10"),
    "dense_flattens": ("NotImplementedError", "item A10"),
    "graph": ("NotImplementedError", "item A4"),
    "modes_disagree": ("ValueError", "disagree"),
    "local_beside_sp": ("ValueError", "disagree"),
    "indivisible_t": ("ValueError", "not divisible"),
    "zigzag_not_causal": ("ValueError", "causal-only"),
    "ulysses_heads": ("ValueError", "divisible"),
}


def test_refused_uses_raise_naming_their_item(runs):
    msgs = runs["ranks"][0][1]["refused"]
    assert set(msgs) == set(REFUSED)
    for name, (kind, text) in REFUSED.items():
        assert msgs[name].startswith(kind) and text in msgs[name], \
            (name, msgs[name])
