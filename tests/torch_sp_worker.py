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
- a ring net with dropout on its embedding (:func:`dropout_cases`): the
  positions each rank kept in its first ``fit`` step, and its
  parameters after two;
- the refusals of the context, the network and the graph.

It writes ``DIR/sp<WORLD>-rank<R>.npz`` (arrays) and ``.json`` (losses,
checksums, messages).
"""
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


def put(res, prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            put(res, f"{prefix}/{k}", v)
    else:
        res[prefix] = t.detach().cpu().numpy()


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


def refusals(inp, mesh, n):
    """The message of every refused use."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        ClsTokenPoolLayer, DenseLayer, OutputLayer, RnnOutputLayer,
        TransformerDecoderBlock, TransformerEncoderBlock)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
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
    pooled = (NeuralNetConfiguration.builder().seed(3).list()
              .layer(TransformerEncoderBlock(n_heads=2, causal=True,
                                             sequence_parallel="ring"))
              .layer(ClsTokenPoolLayer())
              .layer(OutputLayer(n_out=2, activation="softmax",
                                 loss="mcxent"))
              .set_input_type(InputType("rnn", (8 * n, 16))).build())
    net = MultiLayerNetwork(pooled).init(device="cpu")
    flat = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(TransformerEncoderBlock(n_heads=2, causal=True,
                                           sequence_parallel="ring"))
            .layer(DenseLayer(n_out=2))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType("rnn", (8 * n, 16))).build())
    dense = MultiLayerNetwork(flat).init(device="cpu")
    with distributed_context(mesh):
        expect("pooling", lambda: net.fit(x, y))
        expect("dense_flattens", lambda: dense.fit(x, y))

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
        graph_conf = (NeuralNetConfiguration.builder().seed(3)
                      .graph_builder().add_inputs("x")
                      .add_layer("att", MultiHeadAttention(
                          n_in=16, n_out=16, n_heads=2,
                          sequence_parallel="ring"), "x")
                      .add_layer("pool", ClsTokenPoolLayer(), "att")
                      .add_layer("out", OutputLayer(
                          n_out=2, activation="softmax", loss="mcxent"),
                          "pool")
                      .set_outputs("out")
                      .set_input_types(x=InputType("rnn", (8 * n, 16)))
                      .build())
        graph = ComputationGraph(graph_conf).init(device="cpu")
        expect("graph", lambda: graph.output(x))
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
    log["refused"] = refusals(inp, mesh, world)
    base = os.path.join(out_dir, f"{job}{world}-rank{rank}")
    np.savez(base + ".npz", **res)
    with open(base + ".json", "w") as f:
        json.dump(log, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
