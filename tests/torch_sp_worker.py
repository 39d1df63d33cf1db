"""One rank of the sequence-parallel port tests
(``tests/torch_sp_twins.py`` starts one process per rank).
Imports ``torch`` and the port only, never ``jax``.

    python tests/torch_sp_worker.py sp RANK WORLD DIR

Reads the global inputs of ``DIR/inputs.npz`` (made by the test from a
numpy seed), forms a ``{"seq": WORLD}`` mesh over a gloo group that comes
up through a file under ``DIR``, and runs under ``distributed_context``:

- every case of :data:`ATTN` on this rank's shard of its q, k, v (and
  key mask): the output, and the gradients of the case's loss;
- ``MultiHeadAttention`` with each mode (:data:`LAYER`) on this rank's
  shard of x, from the JAX layer's weights;
- a net with learned positions (:func:`pos_conf`) from the JAX weights
  in each mode: ``output`` and one ``fit`` step;
- GPTNano (:data:`NANO`) from the JAX weights in each mode: ``output``,
  3 ``fit`` steps on the global batches of the inputs (the third
  padded), then ``score``; the same in ring mode with per-layer L2
  clipping; 10 steps of GPTNano from its own seed (:data:`TRAINS`);
- GPTNano transferred with a frozen prefix and l2 (:func:`frozen_net`),
  3 ``fit`` steps in zigzag-ring mode; the same with weight noise;
- a ring net with dropout on its embedding (:func:`dropout_cases`): the
  positions each rank kept in its first ``fit`` step, and its
  parameters after two;
- the layers and the vertex that reduce the sequence (:func:`pool_cases`)
  on this rank's shard in each mode: ``GlobalPoolingLayer`` of each
  type, masked and not, ``ClsTokenPoolLayer`` with and without its
  pooler, ``LearnedSelfAttentionLayer`` (one rank's keys all masked),
  ``DenseLayer`` on [B, T, F] and ``LastTimeStepVertex``: the pooled
  output, the gradient of this rank's tokens and the parameters'
  gradients summed over the group;
- the ring block → average pool → output net from the JAX weights
  (:func:`pool_net_case`), fit outside the context, then inside, then
  outside again;
- the same net with a ``TimeDistributed`` dense layer before the pool,
  from its own seed (:func:`td_case`): one ``fit`` and ``output`` under
  the context, and the same on a copy outside it;
- a BERT classifier graph from the JAX weights in ``"ring"`` and
  ``"ulysses"`` (:func:`bert_cases`): ``output``, 3 ``fit`` steps on
  padded batches, ``score`` and the parameters;
- the refusals of the context, the networks and the vertices.

It writes ``DIR/sp<WORLD>-rank<R>.npz`` (arrays) and ``.json`` (losses,
checksums, messages).
"""
import contextlib
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention  # noqa
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    distributed_context, initialize_distributed, make_mesh,
    ring_self_attention, ulysses_self_attention,
    zigzag_ring_self_attention)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: E402
    all_reduce_sum, shard_sequence)
from deeplearning4j_tpu_torch.zoo.gpt import GPTNano  # noqa: E402

#: attention cases, twins of ``tests/test_parallel.py``,
#: ``tests/test_gpt.py:156`` and (``ring_gqa``, whose ranks also report
#: the collective-reduced checksum of dq) ``tests/test_multiprocess_sp.py
#: :77``:
#: name -> (function, shape (B, T, H, Hkv, D), causal, key-mask lengths
#: or None, self-attention (x, x, x), loss): loss None (forward only),
#: "co" sum(out · co), "co_valid" sum(out · co · valid) or "sq"
#: sum(out²)
ATTN = {
    "ring_full": ("ring", (2, 32, 4, 4, 8), False, None, False, None),
    "ring_masked": ("ring", (1, 16, 2, 2, 4), False, (10,), True, None),
    "ring_causal": ("ring", (2, 32, 4, 4, 8), True, None, False, None),
    "ring_causal_grads": ("ring", (1, 32, 2, 2, 8), True, None, False,
                          "co"),
    "ring_masked_grads": ("ring", (1, 16, 2, 2, 4), False, (11,), True,
                          "co"),
    "ring_causal_masked": ("ring", (2, 24, 2, 2, 4), True, (24, 17), True,
                           None),
    "zz_causal": ("zigzag_ring", (2, 64, 2, 2, 8), True, None, False,
                  None),
    "zz_grads": ("zigzag_ring", (1, 32, 2, 2, 8), True, None, True, "co"),
    "zz_masked": ("zigzag_ring", (2, 64, 2, 2, 8), True, (64, 41), True,
                  None),
    "zz_masked_grads": ("zigzag_ring", (1, 32, 2, 2, 8), True, (23,), True,
                        "co_valid"),
    "ring_gqa": ("ring", (1, 32, 4, 2, 8), True, None, False, "sq"),
    "uly_full": ("ulysses", (2, 32, 8, 8, 4), False, None, False, "sq"),
    "uly_causal": ("ulysses", (2, 32, 8, 8, 4), True, None, False, None),
    "uly_masked": ("ulysses", (2, 32, 8, 8, 4), False, (20, 28), False,
                   None),
}
#: the layer-API cases (``tests/test_parallel.py:574``, ``:596``), each
#: also with RoPE: (mode, masked)
LAYER = [("ring", False), ("ulysses", False), ("zigzag_ring", False),
         ("ring", True), ("zigzag_ring", True)]
MODES = ("ring", "zigzag_ring", "ulysses")
NANO = dict(vocab_size=16, max_len=64, seed=5)
#: the parity batches: B x T, the third padded
LM_B, LM_T, LM_STEPS = 2, 32, 3
#: ``tests/test_gpt.py:183``: 10 steps of GPTNano at T = 16 in ring mode
TRAINS = 10
#: the per-layer L2 clip of the clipped parity case (small enough that
#: every layer clips)
CLIP = ("ClipL2PerLayer", 0.05)
#: the frozen parity case: the embedding and blocks 1-2 frozen, and l2
#: on the layers that train (large enough that a term counted once per
#: rank shows in the losses)
FROZEN_UNTIL, FROZEN_L2 = 2, 1e-3
#: the weight-noise case: the frozen case with Gaussian weight noise of
#: this standard deviation on the first trainable block
NOISE_STD = 0.05
#: the pooling twins: [B, T, F] inputs and the key-mask lengths of the
#: masked cases (the second row's 3 steps leave a rank, in every mode at
#: 2 and 4 ranks, with no live step)
POOL_B, POOL_T, POOL_F = 2, 16, 8
POOL_LENGTHS = (16, 3)
POOL_TYPES = ("max", "avg", "sum", "pnorm")
#: the learned queries' attention: head dim 16, one of K1's
LEARNED = dict(n_out=32, n_heads=2, n_queries=3)
#: the twins of ``tests/test_parallel.py:621`` and ``:665``: a causal ring
#: encoder block, average pooling and a softmax output over [8, 16, 16],
#: fit outside the context, three times inside it, then outside again
POOLNET_B, POOLNET_T = 8, 16
POOLNET_FITS = (False, True, True, True, False)
#: the BERT classifier: BertTiny's widths (2 layers, 128 features) with 4
#: heads, so that Ulysses' all-to-all divides them over 4 ranks;
#: dropout 0, as the JAX package's masks are its own
BERT = dict(vocab_size=64, hidden=128, n_layers=2, n_heads=4, max_len=32,
            dropout=0.0, seed=11)
BERT_B, BERT_T, BERT_STEPS = 2, 32, 3
BERT_MODES = ("ring", "ulysses")


def put(res, prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            put(res, f"{prefix}/{k}", v)
    else:
        res[prefix] = t.detach().cpu().numpy()


def jax_weights(net, flat, prefix):
    """``net``'s parameters from the JAX weights under ``prefix`` of the
    inputs (a group without parameters, dropped from the flat file,
    comes back empty)."""
    return net.params_from_jax({**{k: {} for k in net.params},
                                **nested(flat, prefix)})


def nested(flat, prefix):
    out = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def attn_cases(inp, mesh, n, m, res, log):
    fns = {"ring": ring_self_attention, "ulysses": ulysses_self_attention,
           "zigzag_ring": zigzag_ring_self_attention}
    for name, (mode, _, causal, lengths, self_attn, loss) in ATTN.items():
        shard = lambda a: shard_sequence(torch.tensor(a), mode, n, m)
        q = shard(inp[f"{name}/q"]).requires_grad_(loss is not None)
        if self_attn:
            k = v = q
        else:
            k = shard(inp[f"{name}/k"]).requires_grad_(loss is not None)
            v = shard(inp[f"{name}/v"]).requires_grad_(loss is not None)
        kw = {}
        if lengths is not None:
            kw["mask"] = shard(inp[f"{name}/mask"])
        if mode != "zigzag_ring":
            kw["causal"] = causal
        out = fns[mode](q, k, v, mesh, **kw)
        res[f"{name}/out"] = out.detach().numpy()
        if loss is None:
            continue
        if loss == "sq":
            total = (out ** 2).sum()
        else:
            co = shard(inp[f"{name}/co"])
            if loss == "co_valid":
                co = co * kw["mask"][:, :, None, None]
            total = (out * co).sum()
        leaves = (q,) if self_attn else (q, k, v)
        grads = torch.autograd.grad(total, leaves)
        for key, g in zip(("dq", "dk", "dv"), grads):
            res[f"{name}/{key}"] = g.numpy()
        if name == "ring_gqa":
            # the JAX worker's collective-reduced checksum: sum |dL/dq|
            gs = all_reduce_sum(grads[0].abs().sum().reshape(1))
            log["mp_gradsum"] = f"{float(gs[0]):.6f}"


def layer_cases(inp, mesh, n, m, res):
    params = {k: torch.tensor(v) for k, v in
              nested(inp, "layer/params").items()}
    x, mask = torch.tensor(inp["layer/x"]), torch.tensor(inp["layer/mask"])
    for mode, masked in LAYER:
        for rope in (False, True):
            layer = MultiHeadAttention(n_in=16, n_out=16, n_heads=8,
                                       causal=True, sequence_parallel=mode,
                                       rope=rope)
            out, _ = layer.apply(
                params, {}, shard_sequence(x, mode, n, m),
                mask=shard_sequence(mask, mode, n, m) if masked else None)
            res[f"layer/{mode}/{int(masked)}/{int(rope)}/out"] = \
                out.numpy()


def pos_conf(builder, layers, mode):
    """An embedding, learned positions, a causal encoder block in
    ``mode`` and a per-token softmax head, from either package's
    ``NeuralNetConfiguration.builder`` and layer module."""
    b = (builder().seed(7).list()
         .layer(layers.EmbeddingSequenceLayer(n_in=16, n_out=16))
         .layer(layers.PositionalEmbeddingLayer(max_len=64))
         .layer(layers.TransformerEncoderBlock(n_heads=4, causal=True,
                                               sequence_parallel=mode))
         .layer(layers.RnnOutputLayer(n_out=16, activation="softmax",
                                      loss="sparse_mcxent")))
    return b


def pos_cases(inp, res, log):
    """The positional-embedding net: ``output`` and one ``fit`` step
    (its loss, then the positional table) in each mode."""
    from deeplearning4j_tpu_torch.nn import layers
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    for mode in MODES:
        conf = pos_conf(NeuralNetConfiguration.builder, layers, mode) \
            .set_input_type(InputType.recurrent(1, LM_T)).build()
        net = MultiLayerNetwork(conf).init(device="cpu")
        net.params_from_jax(nested(inp, "pos/weights"))
        res[f"pos/{mode}/output"] = net.output(inp["lm/x0"]).numpy()
        net.fit(inp["lm/x0"], inp["lm/y0"])
        log[f"pos/{mode}/loss"] = net.score()
        res[f"pos/{mode}/table"] = net.params["layer_1"]["pos"].numpy()


def nano_net(inp, mode, clip=None):
    model = GPTNano(**NANO, sequence_parallel=mode)
    if clip is None:
        net = model.init(LM_T, device="cpu")
    else:
        from deeplearning4j_tpu_torch.nn.multilayer import \
            MultiLayerNetwork
        conf = model.conf(LM_T)
        conf.gradient_normalization, \
            conf.gradient_normalization_threshold = clip
        net = MultiLayerNetwork(conf).init(device="cpu")
    return net.params_from_jax(nested(inp, "lm/weights"))


def frozen_net(inp, mode, noise=False):
    """GPTNano from the JAX weights, transferred with its embedding and
    blocks 1-2 frozen and l2 on the rest; with ``noise``, weight noise on
    the first trainable block."""
    from deeplearning4j_tpu_torch.nn import (FineTuneConfiguration,
                                             TransferLearning)
    from deeplearning4j_tpu_torch.nn.constraints import WeightNoise
    net = TransferLearning.builder(nano_net(inp, mode)) \
        .fine_tune_configuration(FineTuneConfiguration(l2=FROZEN_L2)) \
        .set_feature_extractor(FROZEN_UNTIL).build()
    if noise:
        net.layers[FROZEN_UNTIL + 1].weight_noise = WeightNoise(
            stddev=NOISE_STD)
    return net


def fit_steps(net, inp):
    losses = []
    for i in range(LM_STEPS):
        kw = {}
        if f"lm/fmask{i}" in inp:
            kw = dict(features_mask=inp[f"lm/fmask{i}"],
                      labels_mask=inp[f"lm/lmask{i}"])
        net.fit(inp[f"lm/x{i}"], inp[f"lm/y{i}"], **kw)
        losses.append(net.score())
    return losses


def lm_cases(inp, res, log):
    for mode in MODES:
        net = nano_net(inp, mode)
        res[f"lm/{mode}/output"] = net.output(inp["lm/x0"]).numpy()
        log[f"lm/{mode}/losses"] = fit_steps(net, inp)
        put(res, f"lm/{mode}/params", net.params)
        ds = type("DS", (), dict(features=inp["lm/x2"],
                                 labels=inp["lm/y2"],
                                 features_mask=inp["lm/fmask2"],
                                 labels_mask=inp["lm/lmask2"]))
        log[f"lm/{mode}/score"] = net.score(ds)
    net = nano_net(inp, "ring", CLIP)
    log["lm/clip/losses"] = fit_steps(net, inp)
    put(res, "lm/clip/params", net.params)
    # a frozen prefix under the context: the FrozenLayer-wrapped blocks
    # keep their sequence_parallel mode (the network's mode check and
    # the position-mixing check read it through the wrapper); l2 on the
    # rest, and then weight noise on one block too
    net = frozen_net(inp, "zigzag_ring")
    log["lm/frozen/mode"] = net._seq_parallel()[1]
    put(res, "lm/frozen/start", net.params)
    log["lm/frozen/losses"] = fit_steps(net, inp)
    put(res, "lm/frozen/params", net.params)
    net = frozen_net(inp, "zigzag_ring", noise=True)
    log["lm/noise/losses"] = fit_steps(net, inp)
    put(res, "lm/noise/params", net.params)
    # tests/test_gpt.py:183: the LM trains under the context
    net = GPTNano(**NANO, sequence_parallel="ring").init(16, device="cpu")
    tokens = np.arange(17) % 5 + 1
    x = np.tile(tokens[:16], (4, 1)).astype(np.int32)
    y = np.tile(tokens[1:17], (4, 1)).astype(np.int32)
    losses = []
    for _ in range(TRAINS):
        net.fit(x, y)
        losses.append(net.score())
    log["trains/losses"] = losses


def dropout_cases(inp, res):
    """An embedding, ``DropoutLayer(0.5)`` and a causal ring encoder
    block: the dropout layer's kept positions on this rank's shard in
    the first of two ``fit`` steps, and the parameters after them."""
    from deeplearning4j_tpu_torch.nn import layers
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(layers.EmbeddingSequenceLayer(n_in=16, n_out=16))
            .layer(layers.DropoutLayer(dropout=0.5))
            .layer(layers.TransformerEncoderBlock(n_heads=4, causal=True,
                                                  sequence_parallel="ring"))
            .layer(layers.RnnOutputLayer(n_out=16, activation="softmax",
                                         loss="sparse_mcxent"))
            .set_input_type(InputType.recurrent(1, LM_T)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    drop, seen = net.layers[1], []
    apply = drop.apply

    def record(*a, **kw):
        y, st = apply(*a, **kw)
        seen.append(y.detach())
        return y, st
    drop.apply = record
    net.fit(inp["lm/x0"], inp["lm/y0"])
    net.fit(inp["lm/x1"], inp["lm/y1"])
    res["dropout/kept"] = (seen[0] != 0).numpy()
    put(res, "dropout/params", net.params)


def _rank_loss(y, co, m):
    """The rank's share of ``sum(y · co)`` over a replicated ``y``: the
    whole on the first rank, 0 elsewhere (the tail rule of
    ``parallel/mesh.py``)."""
    return (y * co).sum() * (1.0 if m == 0 else 0.0)


def _summed(grads):
    return [all_reduce_sum(g.contiguous().clone()) for g in grads]


def pool_layer(kind, layers, vertices):
    """The layer or vertex of a ``pool_cases`` case, from either
    package's layer and vertex modules, and its parameter names."""
    if kind in POOL_TYPES:
        return layers.GlobalPoolingLayer(pooling_type=kind), ()
    if kind == "cls":
        return layers.ClsTokenPoolLayer(), ()
    if kind == "cls_pooler":
        return layers.ClsTokenPoolLayer(pooler=True), ("W", "b")
    if kind == "learned":
        return layers.LearnedSelfAttentionLayer(**LEARNED), ("Q", "Wk",
                                                             "Wv")
    if kind == "dense":
        return layers.DenseLayer(n_out=4, activation="tanh"), ("W", "b")
    return vertices.LastTimeStepVertex(), ()


#: the reduction cases: (kind, masked) — every pooling type masked and
#: not, the CLS pool with and without its pooler, the learned queries
#: masked and not, the flattening dense layer, the last step masked and
#: not — each in every mode
POOL_CASES = ([(pt, mk) for pt in POOL_TYPES for mk in (False, True)]
              + [("cls", False), ("cls_pooler", True), ("learned", False),
                 ("learned", True), ("dense", False), ("last", False),
                 ("last", True)])


def pool_cases(inp, ctx, n, m, res):
    """Each of :data:`POOL_CASES` in each mode on this rank's shard of
    the global [B, T, F], the context's layout set as a network sets it:
    the pooled output, the gradient of ``sum(y · co)`` (counted on the
    first rank) for the rank's tokens, and the parameters' gradients
    summed over the group."""
    from deeplearning4j_tpu_torch.nn import layers, vertices
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    x, mask = inp["pool/x"], inp["pool/mask"]
    for kind, masked in POOL_CASES:
        layer, names = pool_layer(kind, layers, vertices)
        params = {k: torch.tensor(inp[f"pool/{kind}/{k}"]).requires_grad_()
                  for k in names}
        co = torch.tensor(inp[f"pool/{kind}/co"])
        for mode in MODES:
            xs = shard_sequence(torch.tensor(x), mode, n,
                                m).requires_grad_()
            ms = shard_sequence(torch.tensor(mask), mode, n,
                                m) if masked else None
            with MultiLayerNetwork._layout((ctx, mode)):
                if kind == "last":
                    y = layer.apply([xs], mask=ms)
                else:
                    y, _ = layer.apply(params, {}, xs, mask=ms)
            leaves = [xs] + [params[k] for k in names]
            grads = torch.autograd.grad(_rank_loss(y, co, m), leaves)
            key = f"pool/{kind}/{int(masked)}/{mode}"
            res[f"{key}/out"] = y.detach().numpy()
            res[f"{key}/dx"] = grads[0].numpy()
            for k, g in zip(names, _summed(grads[1:])):
                res[f"{key}/d{k}"] = g.numpy()


def pool_net_conf(builder, layers, upd, input_type):
    """``tests/test_parallel.py:621``'s net, from either package's
    builder, layer and updater modules."""
    return (builder().seed(3).updater(upd.Adam(learning_rate=0.01)).list()
            .layer(layers.TransformerEncoderBlock(n_heads=8, causal=True,
                                                  sequence_parallel="ring"))
            .layer(layers.GlobalPoolingLayer(pooling_type="avg"))
            .layer(layers.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(input_type("rnn", (POOLNET_T, 16))).build())


def pool_net_case(inp, mesh, res, log):
    """The pooled net from the JAX weights, fit on the same batch outside
    the context, inside it and outside again (:data:`POOLNET_FITS`): the
    losses and the parameters after."""
    from deeplearning4j_tpu_torch.nn import layers
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = jax_weights(MultiLayerNetwork(pool_net_conf(
        NeuralNetConfiguration.builder, layers, upd, InputType)).init(
            device="cpu"), inp, "poolnet/weights")
    losses = []
    for inside in POOLNET_FITS:
        if inside:
            with distributed_context(mesh):
                net.fit(inp["poolnet/x"], inp["poolnet/y"])
        else:
            net.fit(inp["poolnet/x"], inp["poolnet/y"])
        losses.append(net.score())
    log["poolnet/losses"] = losses
    put(res, "poolnet/params", net.params)


def td_case(inp, mesh, res, log):
    """:func:`pool_net_conf`'s net with a ``TimeDistributed`` dense layer
    between the block and the pool, which feeds its dense layer the
    rank's [B·T_loc, F] rows, from the port's own init: ``fit`` and then
    ``output`` of the pooled net's batch under the context, and on a copy
    outside it."""
    from deeplearning4j_tpu_torch.nn import layers
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater(Adam(learning_rate=0.01)).list()
            .layer(layers.TransformerEncoderBlock(n_heads=8, causal=True,
                                                  sequence_parallel="ring"))
            .layer(layers.TimeDistributed(
                underlying=layers.DenseLayer(n_out=16, activation="tanh")))
            .layer(layers.GlobalPoolingLayer(pooling_type="avg"))
            .layer(layers.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(InputType("rnn", (POOLNET_T, 16))).build())
    x, y = inp["poolnet/x"], inp["poolnet/y"]
    for where in ("ctx", "local"):
        net = MultiLayerNetwork(conf).init(device="cpu")
        with (distributed_context(mesh) if where == "ctx"
              else contextlib.nullcontext()):
            net.fit(x, y)
            log[f"td/{where}/loss"] = net.score()
            res[f"td/{where}/output"] = net.output(x).numpy()
        put(res, f"td/{where}/params", net.params)


def bert_conf(bert_cls, mode):
    """The BERT classifier (:data:`BERT`) over ``BERT_T`` tokens, from
    either package's ``Bert``, its encoder blocks in ``mode``."""
    conf = bert_cls(**BERT).conf_classifier(2, BERT_T)
    for node in conf.nodes:
        if type(node.obj).__name__ == "TransformerEncoderBlock":
            node.obj.sequence_parallel = mode
    return conf


def bert_cases(inp, res, log):
    """The BERT classifier graph from the JAX weights in each of
    :data:`BERT_MODES`: ``output`` of the first batch (unmasked, as the
    JAX ``output`` takes no masks), ``fit`` on the padded batches, then
    ``score`` and the parameters."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.bert import Bert
    for mode in BERT_MODES:
        net = jax_weights(ComputationGraph(bert_conf(Bert, mode)).init(
            device="cpu"), inp, "bert/weights")
        res[f"bert/{mode}/output"] = net.output(
            inp["bert/tok0"], inp["bert/seg0"])[0].numpy()
        losses = []
        for i in range(BERT_STEPS):
            m = inp[f"bert/mask{i}"]
            net.fit([inp[f"bert/tok{i}"], inp[f"bert/seg{i}"]],
                    [inp[f"bert/y{i}"]], features_masks=[m, m])
            losses.append(net.score())
        log[f"bert/{mode}/losses"] = losses
        log[f"bert/{mode}/score"] = net.score()
        put(res, f"bert/{mode}/params", net.params)


def refusals(inp, mesh, n):
    """The message of every refused use."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        ClsTokenPoolLayer, DenseLayer, LearnedSelfAttentionLayer, OutputLayer,
        RnnOutputLayer, TransformerDecoderBlock, TransformerEncoderBlock)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.preprocessors import \
        RnnToFeedForwardPreProcessor
    from deeplearning4j_tpu_torch.nn.vertices import (
        AttentionVertex, FlattenVertex, MergeVertex, ReshapeVertex,
        ReverseTimeSeriesVertex)
    out = {}

    def expect(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
        else:
            out[name] = "no error"

    expect("batch_axis",
           lambda: distributed_context(mesh, batch_axis="data"))
    expect("head_axis",
           lambda: distributed_context(mesh, head_axis="tensor"))
    wide = make_mesh({"data": 1, "seq": n})
    expect("multi_axis", lambda: distributed_context(wide))
    expect("ring_batch_axis", lambda: ring_self_attention(
        *(torch.zeros(1, 8, 2, 4),) * 3, mesh, batch_axis="data"))
    x = np.zeros((2, 8 * n, 16), np.float32)
    y = np.zeros((2, 2), np.float32)
    after = (NeuralNetConfiguration.builder().seed(3).list()
             .layer(TransformerEncoderBlock(n_heads=2, causal=True,
                                            sequence_parallel="ring"))
             .layer(LearnedSelfAttentionLayer(n_out=16, n_heads=2,
                                              n_queries=2))
             .layer(TransformerEncoderBlock(n_heads=2, causal=True,
                                            sequence_parallel="ring"))
             .layer(OutputLayer(n_out=2, activation="softmax",
                                loss="mcxent"))
             .set_input_type(InputType("rnn", (8 * n, 16))).build())
    tail = MultiLayerNetwork(after).init(device="cpu")
    per_row = (NeuralNetConfiguration.builder().seed(3).list()
               .layer(TransformerEncoderBlock(n_heads=2, causal=True,
                                              sequence_parallel="ring"))
               .layer(DenseLayer(n_out=4, activation="tanh"))
               .layer(OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
               .input_pre_processor(1, RnnToFeedForwardPreProcessor())
               .set_input_type(InputType("rnn", (8 * n, 16))).build())
    rows = MultiLayerNetwork(per_row).init(device="cpu")
    with distributed_context(mesh):
        expect("sp_after_pooling", lambda: tail.fit(x, y))
        expect("preprocessor_on_shard", lambda: rows.fit(x, y))

    def lm(*modes):
        b = (NeuralNetConfiguration.builder().seed(3).list())
        for mode in modes:
            b.layer(TransformerDecoderBlock(n_heads=2,
                                            sequence_parallel=mode))
        b.layer(RnnOutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
        return MultiLayerNetwork(b.set_input_type(
            InputType("rnn", (8 * n, 16))).build()).init(device="cpu")
    ys = np.zeros((2, 8 * n, 4), np.float32)
    with distributed_context(mesh):
        expect("modes_disagree", lambda: lm("ring", "zigzag_ring")
               .fit(x, ys))
        expect("local_beside_sp", lambda: lm("ring", None).fit(x, ys))
        expect("indivisible_t",
               lambda: lm("ring").fit(x[:, :8 * n - 1], ys[:, :8 * n - 1]))
        bad = MultiHeadAttention(n_in=16, n_out=16, n_heads=2,
                                 sequence_parallel="zigzag_ring")
        p, _, _ = bad.init(torch.Generator().manual_seed(0), (8, 16))
        expect("zigzag_not_causal",
               lambda: bad.apply(p, {}, torch.zeros(1, 8, 16)))
        three = torch.zeros(1, 16, 3, 8)
        expect("ulysses_heads", lambda: ulysses_self_attention(
            three, three, three, mesh))

        def graph(vertex, *extra):
            """An attention node, ``vertex`` on it (and ``extra`` of its
            inputs), a CLS pool where the vertex keeps the time axis, and
            an output."""
            b = (NeuralNetConfiguration.builder().seed(3).graph_builder()
                 .add_inputs("x")
                 .add_layer("att", MultiHeadAttention(
                     n_in=16, n_out=16, n_heads=2,
                     sequence_parallel="ring"), "x")
                 .add_vertex("v", vertex, "att", *extra))
            last = "v"
            if not isinstance(vertex, FlattenVertex):
                b.add_layer("pool", ClsTokenPoolLayer(), "v")
                last = "pool"
            b.add_layer("out", OutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), last)
            b.set_outputs("out").set_input_types(
                x=InputType("rnn", (8 * n, 16)))
            return ComputationGraph(b.build()).init(device="cpu")
        for name, vertex, extra in (
                ("reverse_vertex", ReverseTimeSeriesVertex(), ()),
                ("flatten_vertex", FlattenVertex(), ()),
                ("reshape_vertex", ReshapeVertex(shape=(8 * n, 16)), ()),
                ("attention_vertex", AttentionVertex(n_heads=2), ("att",)),
                ("merge_on_time", MergeVertex(axis=1), ("att",))):
            g = graph(vertex, *extra)
            expect(name, lambda: g.output(x))
        no_seq = (NeuralNetConfiguration.builder().seed(3).graph_builder()
                  .add_inputs("x")
                  .add_layer("att", MultiHeadAttention(
                      n_in=16, n_out=16, n_heads=2,
                      sequence_parallel="ring"), "x")
                  .add_layer("pool", ClsTokenPoolLayer(), "att")
                  .add_layer("out", OutputLayer(
                      n_out=2, activation="softmax", loss="mcxent"), "pool")
                  .set_outputs("out").build())
        g = ComputationGraph(no_seq).init({"x": (8 * n, 16)}, device="cpu")
        expect("graph_without_sequence_input", lambda: g.output(x))
    return out


def main():
    job, rank, world, out_dir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    initialize_distributed(f"file://{out_dir}/{job}{world}.rendezvous",
                           world, rank)
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = make_mesh({"seq": world})
    res, log = {}, {"backend": torch.distributed.get_backend(),
                    "index": mesh.index("seq")}
    with distributed_context(mesh) as ctx:
        log["context"] = [ctx.size, ctx.index]
        attn_cases(inp, mesh, world, rank, res, log)
        layer_cases(inp, mesh, world, rank, res)
        pos_cases(inp, res, log)
        lm_cases(inp, res, log)
        dropout_cases(inp, res)
        pool_cases(inp, ctx, world, rank, res)
        bert_cases(inp, res, log)
    pool_net_case(inp, mesh, res, log)
    td_case(inp, mesh, res, log)
    log["refused"] = refusals(inp, mesh, world)
    base = os.path.join(out_dir, f"{job}{world}-rank{rank}")
    np.savez(base + ".npz", **res)
    with open(base + ".json", "w") as f:
        json.dump(log, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
