"""One rank of the ZeRO and graph-under-the-wrapper port tests
(``tests/torch_zero_twins.py`` starts one process per rank). Imports
``torch`` and the port only, never ``jax``.

    python tests/torch_zero_worker.py zero RANK WORLD DIR

Every world size runs, from the carried-across weights and the batches
of ``DIR/inputs.npz`` (rank r fed its block of rows of each global
batch): the sharded update's trajectory beside replicated SYNC and the
overlap (``traj``), with AdamW's decay mask (``adamw``), and under a
warmup-into-cosine schedule (``sched``); the flat
reduce-scatter and all-gather against the all-reduce mean (``rs``); the
overlap against the end gather, reassigned params and a fit that raises
(``overlap``); per-layer chains (weight decay and a max-norm constraint
on the hidden layer, the output's own updater) and a frozen hidden
layer, sharded beside replicated (``chains``, ``frozen``); a resume inside the port and one from the JAX package's
optimizer state (``resume``); ``zero_dp_report``; the dropout masks of
the ranks and a one-rank group's seed (``c4``); and every refused
option. At world size 2 also the multi-input graph in every mode and
under the sharded update, the Spark facade over a graph, BertTiny's
classifier under the sharded update (``graph``, ``spark``, ``bert``),
and the batch-norm net of ``tests/torch_dp_worker.py`` under the sharded
update, with and without the overlap (``bn``).
Each rank writes ``DIR/zero-rank<R>.npz`` (arrays) and ``.json``
(losses, shapes, messages). The process group comes up through a file
under ``DIR``.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_dp_worker import nested, put, run_bn_wrappers  # noqa: E402

from deeplearning4j_tpu_torch import tree  # noqa: E402
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet  # noqa
from deeplearning4j_tpu_torch.nn import updaters as upd  # noqa: E402
from deeplearning4j_tpu_torch.nn.constraints import \
    MaxNormConstraint  # noqa: E402
from deeplearning4j_tpu_torch.nn.config import (  # noqa: E402
    InputType, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: E402
    DenseLayer, DropoutLayer, FrozenLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import \
    MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.obs.metrics import \
    OPT_STATE_BYTES  # noqa: E402
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    FlatShardLayout, ParallelWrapper, ParameterAveragingTrainingMaster,
    SharedTrainingMaster, SparkComputationGraph, data_parallel_mesh,
    initialize_distributed, per_device_bytes, zero_dp_report)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, all_reduce_sum)

#: the nets of the twins: the JAX tests' own (``tests/
#: test_sharded_update.py`` ``_net``, ``tests/test_fused_kernels.py``
#: ``_mlp_net``), the JAX weights carried across
MLP = dict(seed=42, features=4, hidden=16, classes=2, act="tanh", lr=0.05)
FK = dict(seed=7, features=16, hidden=32, classes=4, act="relu", lr=1e-3)
#: BertTiny's classifier, dropout 0 (the two packages draw other masks)
BERT_T = 16
GRAPH_EPOCHS = 1
#: the training masters over the graph: tests/test_parallel.py:345's
SPARK_EPOCHS = 3
GRAPH_MODES = ("sync", "encoded", "averaging", "async", "sharded")


#: per-layer chains under the wrapper: decay and a constraint on the
#: hidden layer and the output's own updater; a frozen hidden layer
CHAIN_CASES = {
    "chains": {"hidden_kw": {"weight_decay": 0.05, "constraints": [
        MaxNormConstraint(max_norm=0.5)]},
        "out_kw": {"updater": upd.Nesterovs(learning_rate=0.05,
                                            momentum=0.8)}},
    "frozen": {"frozen": True},
}


def sched_adamw(mod):
    """AdamW under a warmup into a cosine, from the updaters module
    ``mod`` (the port's here, the JAX package's in the twins): the
    schedule's own counter rides the sharded state."""
    return mod.AdamW(learning_rate=MLP["lr"], weight_decay=0.01,
                     schedule=mod.WarmupSchedule(
                         warmup_steps=4, base=mod.CosineSchedule(
                             initial=MLP["lr"], max_iter=12)))


def mlp_net(inp, key, kw, updater=None, gradient_normalization=None,
            dropout=None, hidden_kw=None, out_kw=None, frozen=False):
    """A dense net of ``kw`` (a hidden layer and a softmax output) with
    the JAX weights ``key/weights`` of ``inp`` (a dropout layer, if
    given, between the two; it holds no weights); ``hidden_kw`` and
    ``out_kw`` are per-layer options, and ``frozen`` wraps the hidden
    layer in ``FrozenLayer``."""
    b = (NeuralNetConfiguration.builder().seed(kw["seed"])
         .updater(updater or upd.Adam(learning_rate=kw["lr"])))
    if gradient_normalization:
        b = b.gradient_normalization(gradient_normalization)
    hidden = DenseLayer(n_out=kw["hidden"], activation=kw["act"],
                        **(hidden_kw or {}))
    b = b.list().layer(FrozenLayer(underlying=hidden) if frozen else hidden)
    if dropout:
        b = b.layer(DropoutLayer(dropout=dropout))
    conf = (b.layer(OutputLayer(n_out=kw["classes"], activation="softmax",
                                loss="mcxent", **(out_kw or {})))
            .set_input_type(InputType.feed_forward(kw["features"])).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    if dropout:
        return net
    return net.params_from_jax(
        tree.map_(lambda t: t.numpy(), nested(inp, f"{key}/weights")))


def rows(a, rank, world):
    """Rank ``rank``'s block of the rows of a global batch (the rows
    ``P("data")`` gives device ``rank`` in the JAX wrapper)."""
    return a[rank * len(a) // world:(rank + 1) * len(a) // world]


def batches(inp, key, rank, world, size):
    """The rank's rows of each global batch of ``size`` rows of
    ``key/x``, ``key/y``."""
    x, y = inp[f"{key}/x"], inp[f"{key}/y"]
    return [DataSet(rows(x[i:i + size], rank, world),
                    rows(y[i:i + size], rank, world))
            for i in range(0, len(x), size)]


def fit_losses(w, data, epochs):
    """``w.fit`` one batch a call for ``epochs`` epochs; the losses."""
    losses = []
    for _ in range(epochs):
        for ds in data:
            w.fit([ds])
            losses.append(w.net.score())
    return losses


def traj_cases(inp, mesh, res, log):
    """The twin of ``tests/test_sharded_update.py`` ``:69`` (12 steps,
    3 epochs of 4 global batches of 64), ``:124`` (the params every rank
    ends with) and ``:145`` (the rank's moments and bytes), with
    replicated SYNC and the overlap from the same weights; then AdamW
    with its decay mask by key, sharded and replicated; then AdamW under
    a schedule, sharded, with its gathered optimizer state."""
    r, n = mesh.index("data"), mesh.size("data")
    data = batches(inp, "mlp", r, n, 64)
    for name, kw in (("rep", {}), ("sh", {"sharded_update": True}),
                     ("ov", {"sharded_update": True,
                             "gather_overlap": True})):
        net = mlp_net(inp, "mlp", MLP)
        w = ParallelWrapper(net, mesh=mesh, **kw)
        log[f"traj/{name}/losses"] = fit_losses(w, data, 3)
        log[f"traj/{name}/iteration"] = net.iteration
        put(res, f"traj/{name}/params", net.params)
        if name == "sh":
            log["traj/sh/shards"] = list(tree.leaves(tree.map_with_path(
                lambda p, t: ["/".join(p), list(t.shape)], w._dp_state)))
            log["traj/sh/padded"] = w._layout().padded
            log["traj/sh/opt_bytes"] = per_device_bytes(w._dp_state)
            log["traj/sh/gauge"] = OPT_STATE_BYTES.snapshot()
            log["traj/sh/evicted_device"] = sorted(
                {str(t.device) for t in tree.leaves(net.opt_state)})
            put(res, "traj/sh/opt", w.gather_opt_state())
    for name, kw in (("rep", {}), ("sh", {"sharded_update": True})):
        net = mlp_net(inp, "mlp", MLP, updater=upd.AdamW(
            learning_rate=MLP["lr"], weight_decay=0.1,
            exclude_bias_and_norm=True))
        w = ParallelWrapper(net, mesh=mesh, **kw)
        fit_losses(w, data, 1)
        put(res, f"adamw/{name}/params", net.params)
    net = mlp_net(inp, "mlp", MLP, updater=sched_adamw(upd))
    w = ParallelWrapper(net, mesh=mesh, sharded_update=True)
    log["sched/sh/losses"] = fit_losses(w, data, 3)
    put(res, "sched/sh/params", net.params)
    put(res, "sched/sh/opt", w.gather_opt_state())
    for case, kw in CHAIN_CASES.items():
        for name, wkw in (("rep", {}), ("sh", {"sharded_update": True})):
            net = mlp_net(inp, "mlp", MLP, **kw)
            put(res, f"{case}/start", net.params)
            w = ParallelWrapper(net, mesh=mesh, **wkw)
            log[f"{case}/{name}/losses"] = fit_losses(w, data, 1)
            put(res, f"{case}/{name}/params", net.params)


def rs_cases(inp, mesh, res):
    """The twin of ``tests/test_sharded_update.py:93``: this rank's
    gradients reduce-scattered and all-gathered through the layout,
    beside their all-reduce mean."""
    group = mesh.group("data")
    g = nested(inp, f"rs/g/r{mesh.index('data')}")
    layout = FlatShardLayout(g, mesh.size("data"))
    put(res, "rs/roundtrip",
        layout.gather(layout.scatter_mean(g, group), group))
    put(res, "rs/pmean", tree.map_(
        lambda t: all_reduce_sum(t.clone(), group) / mesh.size("data"),
        g))


def overlap_cases(inp, mesh, res, log):
    """The twins of ``tests/test_fused_kernels.py:296`` (8 epochs of one
    global batch of 64, overlap against the end gather) and ``:322``
    (params assigned between fits), and a fit that raises at its third
    batch (too small) under the overlap: ``net.params`` is gathered on
    the way out."""
    r, n = mesh.index("data"), mesh.size("data")
    data = batches(inp, "fk", r, n, 64)
    for name, kw in (("sh", {}), ("ov", {"gather_overlap": True})):
        net = mlp_net(inp, "fk", FK)
        w = ParallelWrapper(net, mesh=mesh, sharded_update=True, **kw)
        w.fit(data, epochs=8)
        put(res, f"overlap/{name}/params", net.params)
    for reassign in (False, True):
        net = mlp_net(inp, "fk", FK)
        w = ParallelWrapper(net, mesh=mesh, sharded_update=True,
                            gather_overlap=True)
        w.fit(data, epochs=2)
        if reassign:
            net.params = tree.map_(torch.zeros_like, net.params)
        w.fit(data, epochs=1)
        log[f"overlap/reassign/{reassign}"] = float(
            net.params["layer_0"]["W"].abs().max())
    short = [data[0], data[0], DataSet(data[0].features[:1],
                                       data[0].labels[:1])]
    for name, kw in (("two", {}), ("raised", {"gather_overlap": True})):
        net = mlp_net(inp, "fk", FK)
        w = ParallelWrapper(net, mesh=mesh, sharded_update=True, **kw)
        try:
            w.fit(short if name == "raised" else short[:2])
        except ValueError as e:
            log["overlap/raised/error"] = f"ValueError: {e}"
        log[f"overlap/{name}/iteration"] = net.iteration
        log[f"overlap/{name}/stale"] = w._params_stale
        put(res, f"overlap/{name}/params", net.params)


def resume_cases(inp, mesh, res, log):
    """Resume: 8 steps without a break against 5, ``gather_opt_state``,
    a new net and wrapper from those params and moments, and 3 more;
    then 3 steps from the JAX package's params and optimizer state after
    5 sharded steps (``resume/jax/...`` of ``inp``, in the port's
    layout)."""
    r, n = mesh.index("data"), mesh.size("data")
    data = batches(inp, "mlp", r, n, 64)        # 4 batches
    steps = data + data

    def run(net, part):
        w = ParallelWrapper(net, mesh=mesh, sharded_update=True)
        w.fit(part)
        return w

    put(res, "resume/whole/params", run(mlp_net(inp, "mlp", MLP),
                                        steps).net.params)
    w = run(mlp_net(inp, "mlp", MLP), steps[:5])
    params = tree.map_(torch.clone, w.net.params)
    opt = tree.map_(torch.clone, w.gather_opt_state())
    net = mlp_net(inp, "mlp", MLP)
    net.params, net.opt_state = params, opt
    put(res, "resume/port/params", run(net, steps[5:]).net.params)
    net = mlp_net(inp, "mlp", MLP)
    net.params = nested(inp, "resume/jax/params")
    net.opt_state = nested(inp, "resume/jax/opt")
    w = run(net, steps[5:])
    put(res, "resume/jax_carried/params", net.params)
    put(res, "resume/jax_carried/opt", w.gather_opt_state())
    log["resume/iteration"] = net.iteration


def c4_cases(inp, mesh, res, log):
    """Dropout 0.5 under SYNC, every rank fed the same rows: the kept
    positions of the first step on each rank, and the params after two
    steps; then a one-rank group of this rank alone, whose wrapper step
    must be ``net.fit``'s to the bit (the seed is unchanged at world
    size 1)."""
    r = mesh.index("data")
    x = inp["c4/x"]
    y = inp["c4/y"]
    kw = dict(MLP, hidden=64)
    net = mlp_net(inp, None, kw, dropout=0.5)
    drop, seen = net.layers[1], []
    apply = drop.apply

    def record(*a, **k):
        out, st = apply(*a, **k)
        seen.append(out.detach())
        return out, st

    drop.apply = record
    w = ParallelWrapper(net, mesh=mesh)
    w.fit([DataSet(x, y)], epochs=2)
    res["c4/kept"] = (seen[0] != 0).numpy()
    put(res, "c4/params", net.params)
    # a group of this rank alone (every rank makes every group)
    groups = [dist.new_group([k]) for k in range(mesh.size("data"))]
    one = Mesh({"data": 1}, np.array([r]), {"data": groups[r]})
    a, b = (mlp_net(inp, None, kw, dropout=0.5) for _ in range(2))
    ParallelWrapper(a, mesh=one).fit([DataSet(x, y)], epochs=2)
    b.fit(x, y)
    b.fit(x, y)
    log["c4/one_rank_equal"] = all(
        torch.equal(p, q) for p, q in zip(tree.leaves(a.params),
                                          tree.leaves(b.params)))


def graph_net(inp, key, conf_fn):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    g = ComputationGraph(conf_fn()).init(device="cpu")
    return g.params_from_jax(
        tree.map_(lambda t: t.numpy(), nested(inp, f"{key}/weights")))


def multi_io_conf():
    """The 2-input, 2-output graph of ``tests/test_parallel.py``
    ``_multi_io_graph``."""
    from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
    return (NeuralNetConfiguration.builder().seed(1)
            .updater(upd.Adam(learning_rate=0.05))
            .graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_out=8, activation="tanh"), "a")
            .add_layer("db", DenseLayer(n_out=8, activation="tanh"), "b")
            .add_vertex("sum", ElementWiseVertex(op="add"), "da", "db")
            .add_layer("out1", OutputLayer(n_out=2, activation="softmax",
                                           loss="mcxent"), "sum")
            .add_layer("out2", OutputLayer(n_out=1, activation="identity",
                                           loss="mse"), "sum")
            .set_outputs("out1", "out2")
            .set_input_types(a=InputType.feed_forward(3),
                             b=InputType.feed_forward(3))
            .build())


def graph_data(inp, rank, world):
    """The rank's rows of each global batch of 32 (``_multi_io_data``)."""
    out = []
    for i in range(0, 256, 32):
        cut = lambda k: rows(inp[f"g/{k}"][i:i + 32], rank, world)
        out.append(MultiDataSet([cut("xa"), cut("xb")],
                                [cut("y1"), cut("y2")]))
    return out


def graph_cases(inp, mesh, res, log):
    """The twin of ``tests/test_parallel.py:328`` (every mode, and SYNC
    under the sharded update, on the multi-IO graph) and ``:345`` (both
    training masters through ``SparkComputationGraph``), and BertTiny's
    classifier under the sharded update and replicated SYNC."""
    r, n = mesh.index("data"), mesh.size("data")
    data = graph_data(inp, r, n)
    for mode in GRAPH_MODES:
        net = graph_net(inp, "g", multi_io_conf)
        kw = ({"sharded_update": True} if mode == "sharded"
              else {"mode": mode})
        w = ParallelWrapper(net, mesh=mesh, averaging_frequency=2, **kw)
        log[f"graph/{mode}/losses"] = fit_losses(w, data, GRAPH_EPOCHS)
        put(res, f"graph/{mode}/params", net.params)
        o1, o2 = net.output(data[0].features[0], data[0].features[1])
        log[f"graph/{mode}/out_shapes"] = [list(o1.shape), list(o2.shape)]
    for name, tm in (("averaging", ParameterAveragingTrainingMaster
                      .Builder(32).averaging_frequency(2).build()),
                     ("encoded", SharedTrainingMaster.Builder(32).build())):
        spark = SparkComputationGraph(graph_net(inp, "g", multi_io_conf),
                                      tm, mesh)
        net = spark.fit(data, epochs=SPARK_EPOCHS)
        log[f"spark/{name}/score"] = spark.score()
        put(res, f"spark/{name}/params", net.params)
    from deeplearning4j_tpu_torch.zoo.bert import BertTiny
    x = [rows(inp["bert/tok"], r, n), rows(inp["bert/seg"], r, n)]
    y = [rows(inp["bert/y"], r, n)]
    for name, kw in (("rep", {}), ("sh", {"sharded_update": True})):
        net = BertTiny(max_len=BERT_T, dropout=0.0).init_classifier(
            2, BERT_T, device="cpu")
        net.params_from_jax(tree.map_(lambda t: t.numpy(),
                                      nested(inp, "bert/weights")))
        w = ParallelWrapper(net, mesh=mesh, **kw)
        log[f"bert/{name}/losses"] = [
            w.fit([(x, y)]).score() for _ in range(3)]
        put(res, f"bert/{name}/params", net.params)


def refusals(inp, mesh):
    """The message of every option the JAX package refuses around the
    sharded update, and of a masked batch under the wrapper."""
    out = {}

    def expect(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
        else:
            out[name] = "no error"

    r, n = mesh.index("data"), mesh.size("data")
    data = batches(inp, "mlp", r, n, 64)
    clipped = mlp_net(inp, "mlp", MLP,
                      gradient_normalization="ClipL2PerParamType")
    expect("cross_leaf_norm", lambda: ParallelWrapper(
        clipped, mesh=mesh, sharded_update=True).fit(data[:1]))
    expect("not_sync", lambda: ParallelWrapper(
        mlp_net(inp, "mlp", MLP), mesh=mesh, mode="averaging",
        sharded_update=True))
    expect("overlap_alone", lambda: ParallelWrapper(
        mlp_net(inp, "mlp", MLP), mesh=mesh, gather_overlap=True))
    expect("overlap_constraints", lambda: ParallelWrapper(
        mlp_net(inp, "mlp", MLP, **CHAIN_CASES["chains"]), mesh=mesh,
        sharded_update=True, gather_overlap=True).fit(data[:1]))
    ds = data[0]
    masked = DataSet(ds.features, ds.labels,
                     labels_mask=np.ones(len(ds.features), np.float32))
    expect("masked_dataset", lambda: ParallelWrapper(
        mlp_net(inp, "mlp", MLP), mesh=mesh).fit([masked]))
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    z = np.zeros((4, 3), np.float32)
    mds = MultiDataSet([z, z], [np.eye(2, dtype=np.float32)[[0, 1, 0, 1]],
                                z[:, :1]],
                       features_masks=[np.ones((4, 3), np.float32), None])
    expect("masked_graph", lambda: ParallelWrapper(
        ComputationGraph(multi_io_conf()).init(device="cpu"), mesh=mesh,
        sharded_update=True).fit([mds]))
    return out


def main():
    job, rank, world, out_dir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    initialize_distributed(f"file://{out_dir}/{job}.rendezvous", world,
                           rank)
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = data_parallel_mesh()
    res, log = {}, {"world": mesh.size("data"), "rank": mesh.index("data")}
    traj_cases(inp, mesh, res, log)
    rs_cases(inp, mesh, res)
    overlap_cases(inp, mesh, res, log)
    resume_cases(inp, mesh, res, log)
    c4_cases(inp, mesh, res, log)
    report = zero_dp_report(steps=3, hidden=32, features=16, device="cpu")
    log["report"] = {k: v for k, v in report.items()}
    log["refused"] = refusals(inp, mesh)
    if world == 2:
        graph_cases(inp, mesh, res, log)
        run_bn_wrappers(inp, mesh, res, log, ("sharded", "overlap"))
    base = os.path.join(out_dir, f"{job}-rank{rank}")
    np.savez(base + ".npz", **res)
    with open(base + ".json", "w") as f:
        json.dump(log, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
