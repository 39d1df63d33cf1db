"""The port's data slice on the CPU (``data/iterators.py``,
``data/normalizers.py``, ``data/mnist.py``, ``data/digits.py``) against
the JAX package's: twins of ``tests/test_data.py``'s normaliser, async
iterator and Iris tests and of ``tests/test_real_digits.py``; the
synthetic MNIST and the real-digits split equal to the JAX package's,
byte for byte; and the ``iterator`` fault site (ROADMAP C5): the same
plan raises at the same batch in both packages, moves
``FAULTS_INJECTED{site="iterator"}`` by one, and with no plan the site
costs no evaluation.

Tolerances: the host numpy statistics and transforms are the same
numpy code on the same data — equal to the bit; the real-digits CNN
trains in the port alone and is held to the JAX test's bar (≥ 0.95).
"""
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import digits as jdigits
from deeplearning4j_tpu.data import mnist as jmnist
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu_torch.data import (
    AsyncDataSetIterator, DataSet, ImagePreProcessingScaler,
    IrisDataSetIterator, IteratorDataSetIterator, ListDataSetIterator,
    MnistDataSetIterator, NormalizerMinMaxScaler, NormalizerStandardize,
    RealDigitsDataSetIterator, load_real_digits, normalizer_from_state)
from deeplearning4j_tpu_torch.data import mnist as pmnist
from deeplearning4j_tpu_torch.eval_ import Evaluation
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import metrics
from deeplearning4j_tpu_torch.resilience import faults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the CNN test trains real convolutions, and
    test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- normalisers ---------------------------------------------------------------
def test_normalizer_standardize_fit_transform_revert():
    rng = np.random.default_rng(0)
    x = rng.normal(5.0, 3.0, (500, 4)).astype(np.float32)
    ds = DataSet(x, np.zeros((500, 1)))
    n = NormalizerStandardize().fit(ds)
    t = n.transform(x)
    np.testing.assert_allclose(t.mean(0), 0, atol=1e-4)
    np.testing.assert_allclose(t.std(0), 1, atol=1e-3)
    np.testing.assert_allclose(n.revert(t), x, rtol=1e-4)
    n2 = NormalizerStandardize().fit(
        iter(ListDataSetIterator(ds, batch_size=100)))
    np.testing.assert_allclose(n.mean, n2.mean, rtol=1e-5)
    j = jnorm.NormalizerStandardize().fit(JDataSet(x, np.zeros((500, 1))))
    np.testing.assert_array_equal(n.mean, j.mean)
    np.testing.assert_array_equal(n.std, j.std)
    np.testing.assert_array_equal(t, j.transform(x))


def test_normalizer_minmax_and_image():
    x = np.array([[0.0, 5.0], [10.0, 15.0]], np.float32)
    n = NormalizerMinMaxScaler().fit(DataSet(x, x))
    t = n.transform(x)
    assert t.min() == 0 and t.max() == 1
    np.testing.assert_allclose(n.revert(t), x)
    img = ImagePreProcessingScaler()
    np.testing.assert_allclose(
        img.transform(np.array([0, 255], np.uint8)), [0.0, 1.0])
    j = jnorm.NormalizerMinMaxScaler(-1.0, 2.0).fit(JDataSet(x, x))
    p = NormalizerMinMaxScaler(-1.0, 2.0).fit(DataSet(x, x))
    np.testing.assert_array_equal(p.transform(x), j.transform(x))


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_normalizer_state_is_the_jax_packages(kind):
    """Twin of ``test_normalizer_serialization_roundtrip``, across the
    packages: each side's ``state_dict`` loads in the other."""
    x = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    make = {"standardize": "NormalizerStandardize",
            "minmax": "NormalizerMinMaxScaler",
            "image": "ImagePreProcessingScaler"}[kind]
    j = getattr(jnorm, make)().fit(JDataSet(x, x))
    p = normalizer_from_state(j.state_dict())
    assert p.state_dict() == j.state_dict()
    np.testing.assert_array_equal(p.transform(x), j.transform(x))
    back = jnorm.normalizer_from_state(p.state_dict())
    np.testing.assert_array_equal(back.transform(x), p.transform(x))


def test_set_pre_processor_transforms_every_batch():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    ds = DataSet(x, np.zeros((10, 2), np.float32))
    norm = NormalizerStandardize().fit(ds)
    it = ListDataSetIterator(ds, batch_size=4)
    it.set_pre_processor(norm)
    got = np.concatenate([b.features for b in it])
    np.testing.assert_array_equal(got, norm.transform(x))
    jit = JListIt(JDataSet(x, np.zeros((10, 2), np.float32)), batch_size=4)
    jit.set_pre_processor(jnorm.normalizer_from_state(norm.state_dict()))
    np.testing.assert_array_equal(
        np.concatenate([b.features for b in jit]), got)


# -- iterators -----------------------------------------------------------------
def test_async_iterator_matches_sync():
    ds = DataSet(np.arange(40, dtype=np.float32).reshape(10, 4),
                 np.zeros((10, 2), np.float32))
    sync = [b.features.sum() for b in ListDataSetIterator(ds, batch_size=3)]
    it = AsyncDataSetIterator(ListDataSetIterator(ds, batch_size=3))
    assert [b.features.sum() for b in it] == sync
    assert len(it) == 4 and it.batch_size == 3
    assert [b.features.sum() for b in it] == sync     # re-iterable


def test_async_iterator_propagates_errors():
    class Bad(ListDataSetIterator):
        def __iter__(self):
            yield DataSet(np.ones((2, 2)), np.ones((2, 1)))
            raise RuntimeError("boom")
    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for b in AsyncDataSetIterator(Bad(None)):
            got.append(b)
    assert len(got) == 1


def test_async_iterator_tracks_etl_wait():
    class SlowBase:
        batch_size = 4

        def __iter__(self):
            for _ in range(3):
                time.sleep(0.02)
                yield DataSet(np.zeros((4, 2), np.float32),
                              np.zeros((4, 2), np.float32))

    before = metrics.PREFETCH_WAIT.labels().get()
    it = AsyncDataSetIterator(SlowBase(), queue_size=1)
    assert sum(1 for _ in it) == 3
    assert it.etl_wait_seconds > 0.01
    assert metrics.PREFETCH_WAIT.labels().get() - before >= \
        it.etl_wait_seconds - 1e-9


def test_async_iterator_consumer_leaving_early_stops_the_worker():
    produced = []

    class Endless:
        def __iter__(self):
            i = 0
            while True:
                produced.append(i)
                yield DataSet(np.full((1, 1), i, np.float32),
                              np.zeros((1, 1), np.float32))
                i += 1

    it = AsyncDataSetIterator(Endless(), queue_size=2)
    src = iter(it)
    assert [float(next(src).features[0, 0]) for _ in range(3)] == [0, 1, 2]
    src.close()                            # the worker thread is joined
    n = len(produced)
    time.sleep(0.05)
    assert len(produced) == n and n <= 3 + 2 + 1


def test_iterator_dataset_iterator_batches_examples():
    pairs = [(np.full(3, i, np.float32), np.eye(2)[i % 2])
             for i in range(7)]
    batches = list(IteratorDataSetIterator(iter(pairs), batch_size=3))
    assert [b.features.shape[0] for b in batches] == [3, 3, 1]
    np.testing.assert_array_equal(batches[1].features[:, 0], [3, 4, 5])


def test_iris_matches_jax_and_trains():
    """Twin of ``tests/test_data.py::test_iris_trains``: the same 150 rows
    as the JAX package, and a small MLP fits them."""
    from deeplearning4j_tpu.data.mnist import IrisDataSetIterator as JIris
    ir = IrisDataSetIterator(batch_size=50)
    for a, b in zip(ir, JIris(batch_size=50)):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    conf = (NeuralNetConfiguration.builder().seed(2)
            .updater(pupd.Adam(learning_rate=0.05)).list()
            .layer(pl.DenseLayer(n_out=16, activation="tanh"))
            .layer(pl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    net.fit(ir, epochs=60)
    assert net.evaluate(ir).accuracy() > 0.9


# -- MNIST and the real digits -------------------------------------------------
@pytest.mark.parametrize("train,n", [(True, 64), (False, 512),
                                     (True, 2048)])
def test_synthetic_mnist_is_the_jax_packages_bytes(train, n):
    ji, jl = jmnist._synthetic_mnist(n, train)
    pi, plab = pmnist._synthetic_mnist(n, train)
    assert pi.dtype == ji.dtype == np.uint8 and pi.tobytes() == ji.tobytes()
    np.testing.assert_array_equal(plab, jl)
    p = MnistDataSetIterator(batch_size=64, train=train, n_examples=n,
                             seed=5, data_dir="/nonexistent")
    j = jmnist.MnistDataSetIterator(batch_size=64, train=train,
                                    n_examples=n, seed=5,
                                    data_dir="/nonexistent")
    assert p.synthetic and j.synthetic
    assert p.total_examples() == n
    for _ in range(2):                     # two epochs: the shuffles agree
        for a, b in zip(p, j):
            assert a.features.tobytes() == b.features.tobytes()
            np.testing.assert_array_equal(a.labels, b.labels)


def test_mnist_reads_idx_files(tmp_path):
    """The IDX reader: a real-format (here gzipped) file pair takes
    precedence over the synthetic fallback."""
    import gzip
    import struct
    imgs = np.random.default_rng(0).integers(0, 256, (5, 28, 28)).astype(
        np.uint8)
    labels = np.array([3, 1, 4, 1, 5], np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 5, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 0x801, 5) + labels.tobytes())
    it = MnistDataSetIterator(batch_size=5, train=False,
                              data_dir=str(tmp_path))
    assert not it.synthetic
    (b,) = list(it)
    np.testing.assert_array_equal(b.features[..., 0],
                                  imgs.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(b.labels.argmax(1), labels)


def test_synthetic_mnist_labels_itself():
    """Twin of ``tests/test_real_digits.py::
    test_synthetic_mnist_labels_itself``."""
    it = MnistDataSetIterator(batch_size=32, train=True, n_examples=64,
                              data_dir="/nonexistent")
    assert it.synthetic is True


def test_real_digits_are_real():
    """Twin of ``tests/test_real_digits.py::test_real_digits_are_real``,
    and the split is the JAX package's."""
    x, y = load_real_digits(train=True)
    xt, yt = load_real_digits(train=False)
    assert len(x) + len(xt) == 1797
    assert x.shape[1:] == (8, 8, 1) and y.shape[1] == 10
    assert set(y.argmax(1)) == set(range(10))
    assert set(yt.argmax(1)) == set(range(10))
    jx, jy = jdigits.load_real_digits(train=False)
    np.testing.assert_array_equal(xt, jx)
    np.testing.assert_array_equal(yt, jy)


def test_small_cnn_reaches_95pct_on_real_digits():
    """Twin of ``tests/test_real_digits.py::
    test_small_cnn_reaches_95pct_on_real_digits``: the same CNN, in the
    port, to the same bar."""
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater(pupd.Adam(learning_rate=2e-3))
            .weight_init_fn("xavier").list()
            .layer(pl.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                       padding="SAME", activation="relu"))
            .layer(pl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(pl.DenseLayer(n_out=64, activation="relu"))
            .layer(pl.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    it = RealDigitsDataSetIterator(batch_size=64, train=True)
    for _ in range(30):
        net.fit(it)
    xt, yt = load_real_digits(train=False)
    ev = Evaluation()
    ev.eval(yt, net.output(xt).numpy())
    assert ev.accuracy() >= 0.95, ev.accuracy()


# -- the iterator fault site (ROADMAP C5) --------------------------------------
def _injected(site):
    return metrics.FAULTS_INJECTED.labels(site=site).get()


def test_iterator_plan_fires_at_the_same_batch_in_both_packages():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.zeros((6, 2), np.float32)
    plan = "iterator:error=OSError:nth=2:max=1"
    seen = {}
    for name, it, fmod in (
            ("jax", JListIt(JDataSet(x, y), batch_size=2), jfaults),
            ("port", ListDataSetIterator(DataSet(x, y), batch_size=2),
             faults)):
        seen[name] = []
        before = _injected("iterator")
        with fmod.active(plan):
            with pytest.raises(OSError, match="iterator"):
                for b in it:
                    seen[name].append(float(b.features[0, 0]))
        if name == "port":
            assert _injected("iterator") == before + 1
    assert seen == {"jax": [0.0], "port": [0.0]}
    faults.reset()
    for it in (ListDataSetIterator(DataSet(x, y), batch_size=2),
               AsyncDataSetIterator(IteratorDataSetIterator(
                   zip(x, y), batch_size=2)),
               MnistDataSetIterator(batch_size=8, n_examples=16,
                                    data_dir="/nonexistent"),
               RealDigitsDataSetIterator(batch_size=512)):
        assert sum(1 for _ in it) > 0
    assert faults.evaluations() == 0       # no plan: zero evaluations


def test_etl_flake_plan_fires_in_a_port_fit():
    """The named ``etl-flake`` plan (ninth batch) reaches the port's
    fit through the iterator, behind the prefetch thread too."""
    x = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.arange(40) % 2]
    conf = (NeuralNetConfiguration.builder().list()
            .layer(pl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    for wrap in (lambda it: it, AsyncDataSetIterator):
        net = MultiLayerNetwork(conf).init(device="cpu")
        with faults.active("etl-flake"):
            with pytest.raises(OSError):
                net.fit(wrap(ListDataSetIterator(DataSet(x, y),
                                                 batch_size=4)), epochs=2)
        assert net.iteration == 8
    faults.reset()
