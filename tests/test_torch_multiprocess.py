"""The port's twin of the fit half of ``tests/test_multiprocess.py::
test_two_process_distributed_training``, on the CPU: two gloo ranks
(``tests/torch_dp_worker.py`` job ``fit2``, spawned the way
``tests/test_torch_parallel.py`` spawns it, torch on one thread) train
the same dense net on the same data through ``SparkDl4jMultiLayer`` with
``ParameterAveragingTrainingMaster(64)`` averaging every 2 steps, each
rank on its ``ShardedDataSetIterator`` shard of 7 batches: 4 batches on
rank 0 and 3 on rank 1. The ranks agree 3 steps an epoch (the minimum),
so both return, with the same parameters to the bit and a score under
0.4, the reference's bar. An unsized iterator at world size 2 raises,
naming the reason. The evaluate half waits for the ``eval_`` merge.
"""
import numpy as np
import pytest

from test_torch_parallel import _collect, _spawn


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("fit2"))
    return _collect(_spawn("fit2", 2, out_dir), "fit2", out_dir,
                    timeout=300)


def test_uneven_shards_train_in_lockstep(ranks):
    (p0, log0), (p1, log1) = ranks
    # round-robin shards of 7 batches: 4 and 3
    assert log0["fit2/shard"] == [0, 2, 4]
    assert log1["fit2/shard"] == [1, 2, 3]
    # 8 epochs of the agreed 3 steps on both ranks
    assert log0["fit2/iteration"] == log1["fit2/iteration"] == 24
    for log in (log0, log1):
        assert log["fit2/score"] < 0.4, log["fit2/score"]
    assert set(p0) == set(p1) and p0
    for key in p0:
        np.testing.assert_array_equal(p0[key], p1[key], err_msg=key)


def test_unsized_iterator_raises_naming_the_reason(ranks):
    for _, log in ranks:
        msg = log["fit2/unsized"]
        assert msg.startswith("ValueError") and "sized iterator" in msg \
            and "step count" in msg, msg
