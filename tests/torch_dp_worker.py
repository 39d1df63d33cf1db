"""One rank of the data-parallel port tests (``tests/test_torch_parallel.py``
starts one process per rank). Imports ``torch`` and the port only, never
``jax``.

    python tests/torch_dp_worker.py JOB RANK WORLD DIR

JOB ``dp2`` (world 2) runs the accumulator's ``exchange``,
``exchange_async`` and ``exchange_packed`` on the per-rank gradients of
``DIR/inputs.npz``, ``ParallelWrapper`` in its four modes on GPTNano from
the carried-across weights there (rank r fed its rows of each global
batch), the same four modes on a small conv net with batch norm
(:func:`bn_conf`, its weights from there too) with the bytes one SYNC
step all-reduces, the training masters and the Spark facade, and every
refused option; JOB ``mesh4`` (world 4) builds a {"slice": 2, "data": 2} mesh and
runs ``exchange_hierarchical``; JOB ``fit2`` (world 2) and ``fit4``
(world 4) train the dense net of ``tests/test_multiprocess.py`` through
``SparkDl4jMultiLayer`` on its ``ShardedDataSetIterator`` shard of 7
batches (uneven: 4 and 3; 2, 2, 2 and 1), call ``fit`` on an unsized
iterator, then evaluate: the evaluate half of that test and the merge
cases of :func:`run_eval_cases`, with BERT's weights and batches from
``DIR/inputs.npz``. Each rank writes ``DIR/JOB-rank<R>.npz`` (arrays) and
``.json`` (losses, messages). The process group comes up through a file
under ``DIR``.
"""
import json
import os
import pickle
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


#: the transferred net of the wrapper's per-layer case: the embedding and
#: blocks 1-2 frozen, a fine-tune chain at this rate with decay, and a
#: max-norm constraint on block 3
TRANSFER_LR = 1e-3


def transfer_net(net, tl, ftc, constraint):
    """``net`` transferred for the wrapper's per-layer case (the port's
    classes, or the JAX package's in the twin)."""
    new = (tl.builder(net).fine_tune_configuration(ftc(
        learning_rate=TRANSFER_LR, weight_decay=0.01))
        .set_feature_extractor(2).build())
    new.layers[3].constraints = [constraint(max_norm=1.0)]
    return new


#: the batch-norm twins (A15): a small conv net with two batch norms, one
#: over conv channels and one over dense features, trained 3 steps of
#: BN_ROWS global rows at Adam's BN_LR
BN_SHAPE = (8, 8, 3)
BN_ROWS, BN_CLASSES, BN_LR = 8, 3, 3e-4


def bn_conf(ns):
    """The batch-norm twins' configuration from ``ns`` — the port's
    classes here, the JAX package's in the twins: a 3×3 SAME convolution
    of 8 channels, batch norm, 2×2 max pooling, a dense layer of 64, batch
    norm, a softmax of ``BN_CLASSES``."""
    return (ns.NeuralNetConfiguration.builder().seed(3)
            .updater(ns.Adam(learning_rate=BN_LR)).list()
            .layer(ns.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                       padding="SAME", activation="relu"))
            .layer(ns.BatchNormalization())
            .layer(ns.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(ns.DenseLayer(n_out=64, activation="tanh"))
            .layer(ns.BatchNormalization())
            .layer(ns.OutputLayer(n_out=BN_CLASSES, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(ns.InputType.convolutional(*BN_SHAPE)).build())


def port_classes():
    """The port's classes :func:`bn_conf` reads."""
    from deeplearning4j_tpu_torch.nn import layers
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    return types.SimpleNamespace(
        NeuralNetConfiguration=NeuralNetConfiguration, InputType=InputType,
        Adam=Adam, **{k: getattr(layers, k) for k in (
            "ConvolutionLayer", "BatchNormalization", "SubsamplingLayer",
            "DenseLayer", "OutputLayer")})


def bn_net(inp):
    """The batch-norm net on the CPU with the JAX weights of ``inp``."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(bn_conf(port_classes())).init(device="cpu")
    weights = {name: {} for name in net.params}    # pooling holds none
    weights.update(nested(inp, "bn/weights"))
    return net.params_from_jax(tree.map_(lambda t: t.numpy(), weights))


def bn_batches(inp, rank, world):
    """Rank ``rank``'s rows of the batch-norm twins' three global
    batches."""
    rows = lambda a: a[rank * len(a) // world:(rank + 1) * len(a) // world]
    return [DataSet(rows(inp[f"bn/x{i}"]), rows(inp[f"bn/y{i}"]))
            for i in range(3)]


def run_bn_wrappers(inp, mesh, res, log, modes):
    """Each of ``modes`` (a wrapper mode, ``"sharded"`` for SYNC under the
    sharded update, ``"overlap"`` for it with the gather overlap) on the
    batch-norm net, one ``fit`` a batch: the losses, params and layer
    state."""
    kws = {"sharded": {"sharded_update": True},
           "overlap": {"sharded_update": True, "gather_overlap": True}}
    data = bn_batches(inp, mesh.index("data"), mesh.size("data"))
    for mode in modes:
        net = bn_net(inp)
        w = ParallelWrapper(net, mesh=mesh, averaging_frequency=2,
                            **kws.get(mode, {"mode": mode}))
        losses = []
        for ds in data:
            w.fit([ds])
            losses.append(net.score())
        log[f"bn/{mode}/losses"] = losses
        put(res, f"bn/{mode}/params", net.params)
        put(res, f"bn/{mode}/state", net.state)


def bn_volume(inp, mesh, log):
    """The bytes ``torch.distributed.all_reduce`` carries in one SYNC step
    of the batch-norm net (its second: the first places the replicas), and
    the gradient all-reduces among them (``all_reduce_sum`` of
    ``parallel/wrapper.py``): their count, their bytes, and the net's
    fp32 parameter leaves and bytes."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import wrapper as wmod
    net = bn_net(inp)
    w = ParallelWrapper(net, mesh=mesh)
    data = bn_batches(inp, mesh.index("data"), mesh.size("data"))
    w.fit(data[:1])
    seen = {"total": 0, "grad_calls": 0, "grad_bytes": 0}
    plain_ar, plain_sum, plain_step = dist.all_reduce, wmod.all_reduce_sum, \
        w._step
    recording = [False]

    def all_reduce(t, *a, **k):
        if recording[0]:
            seen["total"] += t.numel() * t.element_size()
        return plain_ar(t, *a, **k)

    def grad_sum(t, group=None):
        if recording[0]:
            seen["grad_calls"] += 1
            seen["grad_bytes"] += t.numel() * t.element_size()
        return plain_sum(t, group)

    def step(*a):
        recording[0] = True
        try:
            return plain_step(*a)
        finally:
            recording[0] = False

    dist.all_reduce, wmod.all_reduce_sum, w._step = all_reduce, grad_sum, step
    try:
        w.fit(data[1:2])
    finally:
        dist.all_reduce, wmod.all_reduce_sum = plain_ar, plain_sum
    leaves = list(tree.leaves(net.params))
    log["bn/volume"] = dict(seen, leaves=len(leaves),
                            param_bytes=4 * sum(t.numel() for t in leaves))


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
    from deeplearning4j_tpu_torch.nn import (FineTuneConfiguration,
                                             TransferLearning)
    from deeplearning4j_tpu_torch.nn.constraints import MaxNormConstraint
    net = transfer_net(nano_net(inp), TransferLearning,
                       FineTuneConfiguration, MaxNormConstraint)
    put(res, "wrapper/transfer/start", net.params)
    w = ParallelWrapper(net, mesh=mesh)
    losses = []
    for ds in batches(inp, rank):
        w.fit([ds])
        losses.append(net.score())
    log["wrapper/transfer/losses"] = losses
    put(res, "wrapper/transfer/params", net.params)
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


def warmup_case(inp, mesh, log):
    """``ParallelWrapper.warmup`` (the JAX wrapper's): the SYNC step
    declared at the global shape of the first batch before any fit
    changes no parameter, and the fit of that batch then adds no trace,
    its step served by the warmed signature; the step's counters, for
    the twin's comparison with the JAX wrapper's."""
    from deeplearning4j_tpu_torch.perf import WarmupSpec, sentry
    sentry.reset()
    net = nano_net(inp)
    data = batches(inp, mesh.index("data"))
    w = ParallelWrapper(net, mesh=mesh)
    before = {k: v.clone() for k, v in _flat(net.params).items()}
    report = w.warmup([WarmupSpec(features=inp["x0"].shape,
                                  labels=inp["y0"].shape,
                                  dtype=str(inp["x0"].dtype),
                                  labels_dtype=str(inp["y0"].dtype))])
    same = all(torch.equal(before[k], v)
               for k, v in _flat(net.params).items())
    traces = sentry.total_traces()
    w.fit(data[:1])
    st = sentry.stats()["ParallelWrapper.sync_step"]
    st.pop("compile_time_s")
    log["warmup"] = {"compiled": report["compiled"], "unchanged": same,
                     "traces_moved": sentry.total_traces() - traces,
                     "iteration": net.iteration}
    log["warmup/stats"] = st


def _flat(tree_, prefix=""):
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def refusals(inp, mesh):
    """The message of every option this slice refuses, and of the
    sharded update's bad arguments."""
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
    expect("sharded_not_sync", lambda: ParallelWrapper(
        net, mode="encoded", sharded_update=True, mesh=mesh))
    expect("overlap_alone", lambda: ParallelWrapper.builder(net)
           .gather_overlap().build())
    for meth in ("checkpoint_tree", "checkpoint_target",
                 "load_checkpoint_tree", "load_gathered_tree"):
        args = () if meth in ("checkpoint_tree",
                              "checkpoint_target") else ({},)
        expect(meth, lambda m=meth, a=args: getattr(w, m)(*a))
    w.elastic = object()
    expect("elastic", lambda: w.fit(data))
    w.elastic = None
    net._numerics = object()
    expect("numerics", lambda: w.fit(data))
    del net._numerics
    expect("elastic_init", mesh_mod.initialize_distributed_elastic)
    expect("bad_mode", lambda: ParallelWrapper(net, mode="x", mesh=mesh))
    expect("mesh_size", lambda: make_mesh({"data": 3}))
    expect("workers", lambda: ParallelWrapper(net, workers=3))
    expect("cuda_in_gloo", lambda: mesh_mod.check_backend(
        types.SimpleNamespace(is_cuda=True), mesh.group("data")))
    return out


def run_sharded_fit(mesh, log, job):
    """The fit half of ``tests/test_multiprocess.py``'s worker: the same
    dense net and data, 7 batches of 64 dealt round-robin to the ranks
    (4 and 3 at world 2), ``ParameterAveragingTrainingMaster(64)``
    averaging every 2 steps, 8 epochs. Then ``fit`` on an iterator
    without ``len``. Returns the arrays, the trainer and the batches."""
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
    log[f"{job}/shard"] = [shard.shard_index, shard.num_shards, len(shard)]
    trainer.fit(shard, epochs=8)
    log[f"{job}/score"] = trainer.score()
    log[f"{job}/iteration"] = net.iteration
    res = {}
    put(res, f"{job}/params", net.params)
    try:
        trainer.fit(iter(data))
    except ValueError as e:
        log[f"{job}/unsized"] = f"ValueError: {e}"
    else:
        log[f"{job}/unsized"] = "no error"
    return res, trainer, data


#: the seven evaluation classes, in ``eval_/evaluation.py``'s order
EVAL_CLASSES = ("Evaluation", "EvaluationBinary", "ROC", "ROCMultiClass",
                "ROCBinary", "EvaluationCalibration", "RegressionEvaluation")
#: the narrow BERT of the merge cases (weights from ``inputs.npz``)
BERT_KW = dict(vocab_size=100, hidden=64, n_layers=2, n_heads=2, max_len=16,
               dropout=0.0, seed=9)


def _pickled(obj):
    return np.frombuffer(pickle.dumps(obj), np.uint8)


def _raises(fn):
    """The ``ValueError`` or ``NotImplementedError`` ``fn`` raises, as
    "Type: message", or "no error"."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def run_eval_cases(inp, trainer, data, res, log):
    """The evaluate half of ``tests/test_multiprocess.py``'s worker
    (``trainer.evaluate`` of the rank's shard, ``net.evaluate`` of all the
    data) and the merge cases: the seven classes over the rank's shard
    (``uneven``: the payloads differ in size), ``evaluate`` with and
    without ``num_classes`` where only rank 0's shard has a sample
    (``empty``), a pinned class count against an observed one
    (``pinned``), a rank passing two evaluations where the others pass one
    (``count``), a masked batch in rank 0's shard alone (``masked``,
    through ``do_evaluation`` and ``evaluate``), and
    ``SparkComputationGraph.do_evaluation`` of the narrow BERT (``bert``). Each merged result goes into ``res`` pickled, so the
    ranks' bytes can be compared."""
    from deeplearning4j_tpu_torch.data import (ListDataSetIterator,
                                               MultiDataSet)
    from deeplearning4j_tpu_torch.eval_ import evaluation as ev
    from deeplearning4j_tpu_torch.nn.multilayer import evaluate_batches
    from deeplearning4j_tpu_torch.parallel import (ShardedDataSetIterator,
                                                   SparkComputationGraph)
    from deeplearning4j_tpu_torch.zoo.bert import Bert
    rank = torch.distributed.get_rank()
    net = trainer.net
    merged = trainer.evaluate(ShardedDataSetIterator(data))
    full = net.evaluate(ListDataSetIterator(data))
    log["eval/count"] = [merged.count, full.count]
    res["eval/confusion"] = merged.confusion
    res["eval/full_confusion"] = full.confusion
    res["eval/pickle"] = _pickled(merged)
    res["eval/probs"] = net.output(np.concatenate(
        [d.features for d in data])).numpy()

    fresh = lambda: [getattr(ev, c)() for c in EVAL_CLASSES]
    local = evaluate_batches(net, ShardedDataSetIterator(data), *fresh())
    log["uneven/local_bytes"] = len(pickle.dumps(local))
    res["uneven/pickle"] = _pickled(
        trainer.do_evaluation(ShardedDataSetIterator(data), *fresh()))

    one = data[:1]                           # rank 0's shard alone
    log["empty/local_count"] = net.evaluate(
        ShardedDataSetIterator(one)).count
    res["empty/pinned"] = _pickled(
        trainer.evaluate(ShardedDataSetIterator(one), num_classes=2))
    res["empty/unpinned"] = _pickled(
        trainer.evaluate(ShardedDataSetIterator(one)))

    pin = ev.Evaluation(n_classes=3 if rank == 0 else None)
    log["pinned/raised"] = _raises(lambda: trainer.do_evaluation(
        ShardedDataSetIterator(data), pin))
    evals = [ev.Evaluation() for _ in range(2 if rank == 0 else 1)]
    log["count/raised"] = _raises(lambda: trainer.do_evaluation(
        ShardedDataSetIterator(data), *evals))

    masked = [DataSet(d.features, d.labels,
                      labels_mask=np.ones(len(d.labels), np.float32))
              if i == 0 else d for i, d in enumerate(data)]
    log["masked/do_evaluation"] = _raises(lambda: trainer.do_evaluation(
        ShardedDataSetIterator(masked), ev.Evaluation()))
    log["masked/evaluate"] = _raises(
        lambda: trainer.evaluate(ShardedDataSetIterator(masked)))

    bert = Bert(**BERT_KW).init_classifier(2, 16, device="cpu")
    bert.params_from_jax(tree.map_(lambda t: t.numpy(),
                                   nested(inp, "bert/weights")))
    batches = [MultiDataSet([inp[f"bert/tok{i}"], inp[f"bert/seg{i}"]],
                            [inp[f"bert/y{i}"]])
               for i in range(int(inp["bert/n"]))]
    spark = SparkComputationGraph(bert, trainer.master, trainer.mesh)
    res["bert/pickle"] = _pickled(spark.do_evaluation(
        ShardedDataSetIterator(batches), ev.Evaluation(), ev.ROC()))
    res["bert/probs"] = np.concatenate(
        [bert.output(*b.features)[0].numpy() for b in batches])


def main():
    job, rank, world, out_dir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    initialize_distributed(f"file://{out_dir}/{job}.rendezvous", world,
                           rank)
    res, log = {}, {"backend": torch.distributed.get_backend(),
                    "rank": torch.distributed.get_rank()}
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    if job == "dp2":
        mesh = data_parallel_mesh()
        log["mesh"] = [mesh.size(), mesh.index("data")]
        run_exchanges(inp, rank, mesh.group("data"), res)
        run_wrappers(inp, mesh, res, log)
        run_bn_wrappers(inp, mesh, res, log, MODES)
        bn_volume(inp, mesh, log)
        log["refused"] = refusals(inp, mesh)
        warmup_case(inp, mesh, log)
    elif job in ("fit2", "fit4"):
        res, trainer, data = run_sharded_fit(data_parallel_mesh(), log, job)
        run_eval_cases(inp, trainer, data, res, log)
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
