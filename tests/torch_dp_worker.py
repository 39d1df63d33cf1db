"""One rank of the data-parallel port tests (``tests/test_torch_parallel.py``
starts one process per rank). Imports ``torch`` and the port only, never
``jax``.

    python tests/torch_dp_worker.py JOB RANK WORLD DIR

JOB ``dp2`` (world 2) runs the accumulator's ``exchange``,
``exchange_async`` and ``exchange_packed`` on the per-rank gradients of
``DIR/inputs.npz``, ``ParallelWrapper`` in its four modes on GPTNano from
the carried-across weights there (rank r fed its rows of each global
batch), the training masters and the Spark facade, and every refused
option; JOB ``mesh4`` (world 4) builds a {"slice": 2, "data": 2} mesh and
runs ``exchange_hierarchical``; JOB ``fit2`` (world 2) trains the dense
net of ``tests/test_multiprocess.py`` through ``SparkDl4jMultiLayer`` on
its ``ShardedDataSetIterator`` shard of 7 batches (uneven: 4 and 3), then
calls ``fit`` on an unsized iterator. Each rank writes
``DIR/JOB-rank<R>.npz`` (arrays) and ``.json`` (losses, messages). The
process group comes up through a file under ``DIR``.
"""
import json
import os
import sys
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deeplearning4j_tpu_torch import tree  # noqa: E402
from deeplearning4j_tpu_torch.data import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    EncodedGradientsAccumulator, ParallelWrapper,
    ParameterAveragingTrainingMaster, SharedTrainingMaster,
    SparkDl4jMultiLayer, data_parallel_mesh, initialize_distributed,
    make_mesh, mesh as mesh_mod)
from deeplearning4j_tpu_torch.parallel import master as master_mod  # noqa
from deeplearning4j_tpu_torch.zoo.gpt import GPTNano  # noqa: E402

MODES = ("sync", "encoded", "averaging", "async")
NANO = dict(vocab_size=16, max_len=64, seed=5)


def nested(flat, prefix):
    """The nested dict of ``flat`` keys ``prefix/a/b`` as CPU tensors."""
    out = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.tensor(a)
    return out


def put(res, prefix, t):
    """``t`` (a tensor or a nested dict of them) into ``res`` under
    ``prefix/...`` keys."""
    if isinstance(t, dict):
        for k, v in t.items():
            put(res, f"{prefix}/{k}", v)
    else:
        res[prefix] = t.detach().cpu().numpy()


def run_exchanges(inp, rank, group, res):
    """Two steps of each exchange from this rank's gradients."""
    for method, init in (("exchange", "init_state"),
                         ("exchange_async", "init_async_state"),
                         ("exchange_packed", "init_state")):
        acc = EncodedGradientsAccumulator()
        state = None
        for step in range(2):
            grads = nested(inp, f"grads/s{step}/r{rank}")
            state = state or getattr(acc, init)(grads)
            out, state = getattr(acc, method)(grads, state, group)
            put(res, f"{method}/s{step}/out", out)
            put(res, f"{method}/s{step}/state", state)


def nano_net(inp):
    net = GPTNano(**NANO).init(24, device="cpu")
    return net.params_from_jax(
        tree.map_(lambda t: t.numpy(), nested(inp, "weights")))


def batches(inp, rank, world=2):
    """Rank ``rank``'s rows of the three global batches: the block of
    rows ``P("data")`` gives device ``rank`` in the JAX wrapper."""
    rows = lambda a: a[rank * len(a) // world:(rank + 1) * len(a) // world]
    return [DataSet(rows(inp[f"x{i}"]), rows(inp[f"y{i}"]))
            for i in range(3)]


def run_wrappers(inp, mesh, res, log):
    """Each mode, one ``fit`` call a batch (the loss of every step), then
    the Spark facade over both masters in one ``fit`` call."""
    rank = mesh.index("data")
    for mode in MODES:
        net = nano_net(inp)
        w = ParallelWrapper(net, mode=mode, averaging_frequency=2,
                            mesh=mesh)
        losses = []
        for ds in batches(inp, rank):
            w.fit([ds])
            losses.append(net.score())
        log[f"wrapper/{mode}/losses"] = losses
        log[f"wrapper/{mode}/iteration"] = net.iteration
        put(res, f"wrapper/{mode}/params", net.params)
        if mode == "encoded":
            put(res, "wrapper/encoded/residual", w._acc_state["residual"])
    shared = SharedTrainingMaster.Builder(2).threshold(1e-3).build()
    w = shared.make_wrapper(nano_net(inp), mesh)
    log["master/shared"] = [w.mode, w.accumulator.algo.initial,
                            w.accumulator.residual_clip, shared.to_json()]
    for name, tm in (("shared", shared),
                     ("averaging", ParameterAveragingTrainingMaster.Builder(2)
                      .averaging_frequency(2).collect_training_stats()
                      .build())):
        spark = SparkDl4jMultiLayer(nano_net(inp), tm, mesh)
        net = spark.fit_datasets(batches(inp, rank))
        log[f"spark/{name}/score"] = spark.score()
        log[f"spark/{name}/stats"] = spark.stats
        put(res, f"spark/{name}/params", net.params)


def refusals(inp, mesh):
    """The message of every option this slice refuses."""
    from deeplearning4j_tpu_torch.zoo.bert import BertTiny
    net = nano_net(inp)
    data = batches(inp, mesh.index("data"))
    out = {}

    def expect(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
        else:
            out[name] = "no error"

    w = ParallelWrapper(net, mesh=mesh)
    expect("sharded_update", lambda: ParallelWrapper(
        net, sharded_update=True, mesh=mesh))
    expect("gather_overlap", lambda: ParallelWrapper.builder(net)
           .gather_overlap().build())
    graph = BertTiny(max_len=16).init_classifier(2, 16, device="cpu")
    expect("graph", lambda: ParallelWrapper(graph, mesh=mesh))
    for meth in ("warmup", "gather_opt_state", "checkpoint_tree",
                 "checkpoint_target", "load_checkpoint_tree",
                 "load_gathered_tree"):
        args = () if meth in ("gather_opt_state", "checkpoint_tree",
                              "checkpoint_target") else ({},)
        expect(meth, lambda m=meth, a=args: getattr(w, m)(*a))
    w.elastic = object()
    expect("elastic", lambda: w.fit(data))
    w.elastic = None
    net._numerics = object()
    expect("numerics", lambda: w.fit(data))
    del net._numerics
    spark = SparkDl4jMultiLayer(nano_net(inp), SharedTrainingMaster(), mesh)
    expect("evaluate", lambda: spark.evaluate(data))
    expect("evaluate_regression", lambda: spark.evaluate_regression(data))
    expect("do_evaluation", lambda: spark.do_evaluation(data))
    expect("merge_across_processes",
           lambda: master_mod.merge_across_processes([]))
    expect("elastic_init", mesh_mod.initialize_distributed_elastic)
    expect("bad_mode", lambda: ParallelWrapper(net, mode="x", mesh=mesh))
    expect("mesh_size", lambda: make_mesh({"data": 3}))
    expect("workers", lambda: ParallelWrapper(net, workers=3))
    expect("cuda_in_gloo", lambda: mesh_mod.check_backend(
        types.SimpleNamespace(is_cuda=True), mesh.group("data")))
    return out


def run_sharded_fit(mesh, log):
    """The fit half of ``tests/test_multiprocess.py``'s worker: the same
    dense net and data, 7 batches of 64 dealt round-robin to the 2 ranks
    (4 and 3), ``ParameterAveragingTrainingMaster(64)`` averaging every 2
    steps, 8 epochs. Then ``fit`` on an iterator without ``len``."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.parallel import ShardedDataSetIterator
    conf = (NeuralNetConfiguration.builder().seed(42)
            .updater(upd.Adam(learning_rate=0.05)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(0)          # the same data on every rank
    x = rng.standard_normal((448, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    data = [DataSet(x[i:i + 64], y[i:i + 64]) for i in range(0, 448, 64)]
    master = (ParameterAveragingTrainingMaster.Builder(64)
              .averaging_frequency(2).build())
    trainer = SparkDl4jMultiLayer(net, master, mesh)
    shard = ShardedDataSetIterator(data)
    log["fit2/shard"] = [shard.shard_index, shard.num_shards, len(shard)]
    trainer.fit(shard, epochs=8)
    log["fit2/score"] = trainer.score()
    log["fit2/iteration"] = net.iteration
    res = {}
    put(res, "fit2/params", net.params)
    try:
        trainer.fit(iter(data))
    except ValueError as e:
        log["fit2/unsized"] = f"ValueError: {e}"
    else:
        log["fit2/unsized"] = "no error"
    return res


def main():
    job, rank, world, out_dir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    initialize_distributed(f"file://{out_dir}/{job}.rendezvous", world,
                           rank)
    res, log = {}, {"backend": torch.distributed.get_backend(),
                    "rank": torch.distributed.get_rank()}
    if job != "fit2":
        inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    if job == "dp2":
        mesh = data_parallel_mesh()
        log["mesh"] = [mesh.size(), mesh.index("data")]
        run_exchanges(inp, rank, mesh.group("data"), res)
        run_wrappers(inp, mesh, res, log)
        log["refused"] = refusals(inp, mesh)
    elif job == "fit2":
        res = run_sharded_fit(data_parallel_mesh(), log)
    else:
        mesh = make_mesh({"slice": 2, "data": 2})
        log["mesh"] = {a: [mesh.index(a), torch.distributed
                           .get_process_group_ranks(mesh.group(a))]
                       for a in mesh.axis_names}
        acc = EncodedGradientsAccumulator()
        state = None
        for step in range(2):
            grads = nested(inp, f"grads/s{step}/r{rank}")
            state = state or acc.init_state(grads)
            out, state = acc.exchange_hierarchical(
                grads, state, mesh.group("data"), mesh.group("slice"))
            put(res, f"exchange_hierarchical/s{step}/out", out)
            put(res, f"exchange_hierarchical/s{step}/state", state)
    base = os.path.join(out_dir, f"{job}-rank{rank}")
    np.savez(base + ".npz", **res)
    with open(base + ".json", "w") as f:
        json.dump(log, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
