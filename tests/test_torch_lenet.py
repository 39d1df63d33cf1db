"""LeNet end to end on the CPU (``zoo/lenet.py`` over ``nn/layers/conv.py``,
``data/mnist.py``, ``serialization.py``): the port's LeNet at its
published widths against the JAX package's with the JAX weights carried
across — so a dense layer reading the convolutions' activations in
another order than H, W, C would fail here — and the path of
``tests/test_lenet_e2e.py`` in the port: synthetic MNIST → LeNet → ``fit``
with listeners → ``evaluate`` → ``ModelSerializer`` write and restore.

Tolerances (float32):
- the loss of one batch: 1e-5 relative;
- every gradient tensor: 1e-3 of its largest magnitude (f32 sums of
  up to 2 450 terms in another order; measured 2.2e-6);
- the output before and after one Nesterovs step: 2e-3 absolute,
  ``train_agree``'s band for outputs (measured 4.5e-8);
- the restored network's output: 1e-5 relative, as the JAX test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.mnist import MnistDataSetIterator as JMnist
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                           MnistDataSetIterator)
from deeplearning4j_tpu_torch.resilience import checkpoint
from deeplearning4j_tpu_torch.serialization import ModelSerializer
from deeplearning4j_tpu_torch.train import (CheckpointListener,
                                            CollectScoresListener,
                                            EvaluativeListener)
from deeplearning4j_tpu_torch.zoo import LeNet

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
OUT_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """LeNet trains real convolutions here: one intra-op thread, so
    that test workers running side by side do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    jnet = JLeNet(num_classes=10, seed=123).init()
    pnet = LeNet(num_classes=10, seed=123).init(device="cpu")
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    return jnet, pnet


def _batch(n=16):
    it = JMnist(batch_size=n, train=True, n_examples=n,
                data_dir="/nonexistent")
    b = next(iter(it))
    return b.features, b.labels


def test_entry_points_default_to_the_card():
    import inspect
    from deeplearning4j_tpu_torch.zoo.pretrained import ZooModel
    for fn in (LeNet.init, ModelSerializer.restore_multi_layer_network,
               ModelSerializer.restore_computation_graph,
               ZooModel.init_pretrained):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn


def test_lenet_has_the_published_widths():
    jnet, pnet = _pair()
    assert pnet.num_params() == jnet.num_params() == 1_256_080
    assert pnet._layer_shapes == [tuple(s) for s in jnet._layer_shapes]
    assert pnet.conf.to_json() == jnet.conf.to_json()
    assert type(pnet.conf.updater).__name__ == "Nesterovs"


def test_lenet_step_matches_jax_from_jax_weights():
    jnet, pnet = _pair()
    x, y = _batch()
    (jloss, _), jgrads = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None,
        None, jax.random.PRNGKey(0))
    ploss, pgrads, _ = pnet._loss_and_grads(torch.tensor(x),
                                            torch.tensor(y))
    assert abs(float(ploss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jg = jax.tree.map(np.asarray, jgrads)
    for name, leaves in pgrads.items():
        for k, g in leaves.items():
            want = jg[name][k]
            err = np.abs(g.numpy() - want).max() / np.abs(want).max()
            assert err <= GRAD_TOL, (name, k, err)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=OUT_TOL,
                               rtol=0)
    jnet.fit(x, y)
    pnet.fit(x, y)
    assert np.isclose(pnet.score(), jnet.score(), rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=OUT_TOL,
                               rtol=0)


def test_lenet_mnist_end_to_end(tmp_path):
    """Twin of ``tests/test_lenet_e2e.py::test_lenet_mnist_end_to_end``
    (2048 training and 512 test examples, 2 epochs), with the prefetch
    iterator, the listeners of the card's ``lenet`` phase and a
    checkpoint a epoch."""
    train_it = AsyncDataSetIterator(MnistDataSetIterator(
        batch_size=64, train=True, n_examples=2048,
        data_dir="/nonexistent"), queue_size=4)
    test_it = MnistDataSetIterator(batch_size=256, train=False,
                                   n_examples=512, data_dir="/nonexistent")
    net = LeNet(num_classes=10, seed=123).init(device="cpu")
    assert net.num_params() > 100_000
    scores = CollectScoresListener()
    evals = []
    net.set_listeners(scores, EvaluativeListener(test_it,
                                                 callback=evals.append),
                      CheckpointListener(tmp_path, save_every_n_epochs=1,
                                         keep_last=1))
    net.fit(train_it, epochs=2)
    assert net.iteration == 64 and len(scores.scores) == 64
    first = np.mean([s for _, s in scores.scores[:4]])
    last = np.mean([s for _, s in scores.scores[-4:]])
    assert np.isfinite(last) and last < first
    e = net.evaluate(test_it)
    assert e.accuracy() > 0.97, e.stats()
    assert [ev.accuracy() for ev in evals][-1] == e.accuracy()

    (ckpt,) = list(tmp_path.glob("checkpoint_*.zip"))
    assert ckpt.name == "checkpoint_epoch_1.zip"
    assert checkpoint.verify_checkpoint(ckpt) == (True, "ok")
    path = tmp_path / "lenet.zip"
    ModelSerializer.write_model(net, path)
    net2 = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    x = next(iter(test_it)).features[:8]
    np.testing.assert_allclose(net.output(x).numpy(),
                               net2.output(x).numpy(), rtol=1e-5)
    for a, b in zip(tree.leaves(net.opt_state), tree.leaves(net2.opt_state)):
        assert torch.equal(a, b)
