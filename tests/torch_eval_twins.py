"""The multi-rank evaluation twins, shared by
``tests/test_torch_multiprocess.py`` (n = 2) and
``tests/test_torch_multiprocess_4.py`` (n = 4), which import these checks
and give the module fixture ``world``. One spawn of gloo ranks for each
world size (``tests/torch_dp_worker.py`` job ``fit<n>``, torch on one
thread, no ``jax``): each rank trains the dense net of
``tests/test_multiprocess.py`` on its ``ShardedDataSetIterator`` shard,
then runs the evaluate half of that test and the merge cases of
``run_eval_cases``. The JAX side is the JAX package's evaluation classes
over the full data, in this process (no JAX multi-process run): fed the
ranks' own probabilities for the dense net, and the JAX BERT's for the
narrow BERT, whose weights both sides share.

Checks, on every rank:
- the reference's [``tests/test_multiprocess.py:66-73``]:
  ``trainer.evaluate(ShardedDataSetIterator(data))`` and
  ``net.evaluate(ListDataSetIterator(data))`` have equal ``count`` and
  ``confusion``, equal to the JAX ``Evaluation`` of all the data;
- the merged objects pickle to the same bytes on every rank;
- uneven payloads: the seven classes over the rank's shard (payloads of
  different sizes) merge to the JAX classes over all the data: counts,
  confusion matrices and every integer statistic exact; float sums and
  AUCs within 1e-12 relative (another order of the same sums);
- ``evaluate`` with and without ``num_classes`` where only rank 0's
  shard has a sample: the full-data evaluation of that batch;
- a pinned class count against an observed one raises ``ValueError`` on
  every rank, and so does a rank passing two evaluations where the
  others pass one; a masked batch in rank 0's shard alone raises
  ``NotImplementedError`` on every rank, through ``do_evaluation`` and
  ``evaluate``; the ranks then go on to the BERT case, so none was left
  in a collective;
- ``SparkComputationGraph.do_evaluation`` of the narrow BERT (2 layers,
  width 64, f32, dropout 0): the merged ``Evaluation`` equals the JAX
  one of all the batches, the ranks' probabilities are within 1e-5 of
  the JAX BERT's (``tests/test_torch_bert.py``'s f32 band) and the
  merged ROC's scores are those probabilities.
"""
import os
import pickle

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.eval_ import evaluation as J
from deeplearning4j_tpu.zoo.bert import Bert as JBert

from test_torch_parallel import _collect, _flat, _spawn
from torch_dp_worker import BERT_KW, EVAL_CLASSES

FLOAT_RTOL = 1e-12
PROB_TOL = 1e-5
BERT_B, BERT_T, BERT_BATCHES = 4, 16, 5


def _data():
    """``tests/test_multiprocess.py``'s data: 448 rows, 7 batches of 64."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((448, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return x, y


def _bert_inputs():
    """The JAX narrow BERT's weights and its batches of sentence pairs."""
    jnet = JBert(**BERT_KW).init_classifier(2, BERT_T)
    inp = _flat(jax.tree.map(np.asarray, jnet.params), "bert/weights")
    rng = np.random.default_rng(21)
    for i in range(BERT_BATCHES):
        inp[f"bert/tok{i}"] = rng.integers(
            0, BERT_KW["vocab_size"], (BERT_B, BERT_T)).astype(np.int32)
        split = rng.integers(1, BERT_T, BERT_B)
        inp[f"bert/seg{i}"] = (np.arange(BERT_T)[None, :]
                               >= split[:, None]).astype(np.int32)
        inp[f"bert/y{i}"] = np.eye(2, dtype=np.float32)[
            rng.integers(0, 2, BERT_B)]
    inp["bert/n"] = np.asarray(BERT_BATCHES)
    return jnet, inp


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):
    """Each rank's (arrays, log), and the JAX BERT's evaluation of the
    batches (computed while the ranks run)."""
    job = f"fit{world}"
    out_dir = str(tmp_path_factory.mktemp(job))
    jnet, inp = _bert_inputs()
    np.savez(os.path.join(out_dir, "inputs.npz"), **inp)
    procs = _spawn(job, world, out_dir)
    batches = [JMDS([inp[f"bert/tok{i}"], inp[f"bert/seg{i}"]],
                    [inp[f"bert/y{i}"]]) for i in range(BERT_BATCHES)]
    jev, jroc = J.Evaluation(), J.ROC()
    probs = []
    for b in batches:
        out = np.asarray(jnet.output(*b.features)[0])
        probs.append(out)
        for e in (jev, jroc):
            e.eval(b.labels[0], out)
    return _Ranks(_collect(procs, job, out_dir, timeout=300), jev, jroc,
                  np.concatenate(probs))


class _Ranks(list):
    """The ranks' results (a list, as ``_collect`` gives it) with the JAX
    BERT's evaluation beside them."""

    def __init__(self, ranks_, jev, jroc, probs):
        super().__init__(ranks_)
        self.jax_bert = (jev, jroc, probs)


def _summary(e):
    """What an evaluation's statistics must agree on whatever the order
    the batches came in: integer statistics, float sums, AUCs."""
    name = type(e).__name__
    if name == "Evaluation":
        return {"confusion": e.confusion, "count": e.count,
                "top_n_correct": e.top_n_correct, "n": e.n_classes}
    if name == "EvaluationBinary":
        return {k: getattr(e, k) for k in ("tp", "fp", "tn", "fn")}
    if name == "ROC":
        s, l = e._collect()
        return {"auc": e.calculate_auc(), "auprc": e.calculate_auprc(),
                "n": s.size, "pos": int(l.sum())}
    if name in ("ROCMultiClass", "ROCBinary"):
        return {c: _summary(r) for c, r in sorted(e.rocs.items())}
    if name == "EvaluationCalibration":
        return {"counts": e.bin_counts, "correct": e.bin_correct,
                "prob_sum": e.bin_prob_sum}
    assert name == "RegressionEvaluation", name
    return {"n": e.n, **e._sums}


def _assert_summary(ours, theirs, path):
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys(), path
        for k in theirs:
            _assert_summary(ours[k], theirs[k], f"{path}.{k}")
        return
    a, b = np.asarray(ours), np.asarray(theirs)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, atol=0,
                                   err_msg=path)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def _same_bytes(ranks, key):
    """The merged objects of ``key`` pickle to the same bytes on every
    rank; returns them unpickled."""
    blobs = [res[key].tobytes() for res, _ in ranks]
    assert all(b == blobs[0] for b in blobs[1:]), key
    return pickle.loads(blobs[0])


def _jax_full(classes, y, probs):
    evs = [getattr(J, c)() for c in classes]
    for e in evs:
        e.eval(y, probs)
    return evs


def test_sharded_evaluate_equals_full_data(ranks, world):
    """The evaluate half of ``tests/test_multiprocess.py``."""
    x, y = _data()
    for res, log in ranks:
        merged, full = log["eval/count"]
        assert merged == full == 448
        np.testing.assert_array_equal(res["eval/confusion"],
                                      res["eval/full_confusion"])
        np.testing.assert_array_equal(res["eval/probs"],
                                      ranks[0][0]["eval/probs"])
    ev = _same_bytes(ranks, "eval/pickle")
    jev, = _jax_full(("Evaluation",), y, ranks[0][0]["eval/probs"])
    _assert_summary(_summary(ev), _summary(jev), "eval")
    assert ev.stats() == jev.stats()


def test_uneven_payloads_merge_to_the_full_data(ranks, world):
    sizes = [log["uneven/local_bytes"] for _, log in ranks]
    assert len(set(sizes)) > 1, sizes
    merged = _same_bytes(ranks, "uneven/pickle")
    _, y = _data()
    theirs = _jax_full(EVAL_CLASSES, y, ranks[0][0]["eval/probs"])
    assert [type(e).__name__ for e in merged] == list(EVAL_CLASSES)
    for ours, jax_e in zip(merged, theirs):
        _assert_summary(_summary(ours), _summary(jax_e),
                        type(ours).__name__)


def test_empty_shard_evaluates_with_and_without_pinned_classes(ranks,
                                                               world):
    counts = [log["empty/local_count"] for _, log in ranks]
    assert counts == [64] + [0] * (world - 1), counts
    _, y = _data()
    jev, = _jax_full(("Evaluation",), y[:64], ranks[0][0]["eval/probs"][:64])
    for key in ("empty/pinned", "empty/unpinned"):
        ev = _same_bytes(ranks, key)
        _assert_summary(_summary(ev), _summary(jev), key)


def test_class_count_mismatch_raises_on_every_rank(ranks, world):
    for _, log in ranks:
        assert log["pinned/raised"] == \
            "ValueError: merge: class-count mismatch 3 vs 2", \
            log["pinned/raised"]


def test_mismatched_number_of_evaluations_raises_on_every_rank(ranks,
                                                               world):
    for _, log in ranks:
        msg = log["count/raised"]
        assert msg.startswith("ValueError: rank 1 contributed 1 "
                              "evaluation objects, expected 2"), msg


def test_masked_batch_on_one_rank_raises_on_every_rank(ranks, world):
    for case in ("masked/do_evaluation", "masked/evaluate"):
        for rank, (_, log) in enumerate(ranks):
            msg = log[case]
            head = ("NotImplementedError: " if rank == 0 else
                    "NotImplementedError: rank 0 refused its batches: ")
            assert msg.startswith(head + "evaluate: a batch with features "
                                  "or labels masks"), (case, rank, msg)


def test_bert_do_evaluation_merges_to_the_jax_evaluation(ranks, world):
    jev, jroc, jprobs = ranks.jax_bert
    for res, _ in ranks:
        np.testing.assert_allclose(res["bert/probs"], jprobs,
                                   atol=PROB_TOL, rtol=0)
    ev, roc = _same_bytes(ranks, "bert/pickle")
    assert ev.count == BERT_B * BERT_BATCHES
    _assert_summary(_summary(ev), _summary(jev), "bert")
    # the merged scores are the ranks' probabilities, in rank order
    order = [i for r in range(world)
             for i in range(r, BERT_BATCHES, world)]
    probs = ranks[0][0]["bert/probs"].reshape(BERT_BATCHES, BERT_B, 2)
    np.testing.assert_array_equal(np.concatenate(roc.scores),
                                  probs[order, :, 1].ravel())
    assert roc.calculate_auc() == pytest.approx(jroc.calculate_auc(),
                                                abs=FLOAT_RTOL)
