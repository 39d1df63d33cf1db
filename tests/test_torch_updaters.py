"""The port's learning-rate schedules and updaters against the JAX
package's (``deeplearning4j_tpu/nn/updaters.py``, optax 0.2.6 under
it), on the CPU, from the same numpy inputs.

Bands:
- schedules: f32, 1e-6 relative over steps 0..50 (measured: equal, or
  one f32 rounding apart where jnp and torch evaluate ``pow`` or
  ``exp`` in their own code);
- updaters: 1e-6 absolute on the parameters after each of five steps,
  the band of the Adam twin in ``tests/test_torch_layers.py`` (measured:
  equal to the bit, but RmsProp and AdaGrad, whose ``rsqrt`` differs by
  an ulp);
- ``opt_state_from_jax``: the loaded state equals the JAX state to the
  bit; one more step of a two-layer net then agrees within 1e-5 (the
  two packages' f32 forward and backward sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu_torch import tree
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

SCHED_RTOL = 1e-6
UPD_TOL = 1e-6
LOAD_STEP_TOL = 1e-5

UPDATER_SPECS = {
    "Sgd": dict(learning_rate=0.1),
    "Adam": dict(learning_rate=1e-3, beta1=0.85),
    "AdamW": dict(learning_rate=1e-3, weight_decay=0.02),
    "AdaMax": dict(learning_rate=1e-3),
    "Nadam": dict(learning_rate=1e-3),
    "AMSGrad": dict(learning_rate=1e-3),
    "Nesterovs": dict(learning_rate=0.1, momentum=0.95),
    "Momentum": dict(learning_rate=0.1),
    "RmsProp": dict(learning_rate=1e-3),
    "AdaGrad": dict(learning_rate=0.05),
    "AdaDelta": dict(),
    "NoOp": dict(),
}

SCHEDULE_SPECS = {
    "FixedSchedule": dict(value=0.1),
    "StepSchedule": dict(initial=0.1, decay_rate=0.5, step=10),
    "ExponentialSchedule": dict(initial=0.1, gamma=0.99),
    "InverseSchedule": dict(initial=0.1, gamma=0.01, power=1.0),
    "PolySchedule": dict(initial=0.1, power=2.0, max_iter=100),
    "SigmoidSchedule": dict(initial=0.1, gamma=0.1, step_center=50),
    "CosineSchedule": dict(initial=0.1, max_iter=100),
    "WarmupSchedule": dict(warmup_steps=10),
}

#: the schedules as the smoke run and the twins use them: warmup into a
#: cosine, and each other schedule over a short horizon
SCHEDULES = dict(SCHEDULE_SPECS, **{
    "StepSchedule": dict(initial=0.1, decay_rate=0.5, step=7),
    "PolySchedule": dict(initial=0.1, power=2.0, max_iter=40),
    "SigmoidSchedule": dict(initial=0.1, gamma=0.1, step_center=20),
    "CosineSchedule": dict(initial=0.1, max_iter=40,
                           final_fraction=0.1),
})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warmup(mod, warmup_steps=3, max_iter=8):
    return mod.WarmupSchedule(warmup_steps=warmup_steps,
                              base=mod.CosineSchedule(initial=0.05,
                                                      max_iter=max_iter))


def _pair_schedule(name, kw):
    return getattr(jupd, name)(**kw), getattr(pupd, name)(**kw)


# -- schedules --------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SCHEDULES) + ["WarmupCosine"])
def test_schedule_matches_jax_over_fifty_steps(name):
    if name == "WarmupCosine":
        js, ps = _warmup(jupd, 5, 30), _warmup(pupd, 5, 30)
    else:
        js, ps = _pair_schedule(name, SCHEDULES[name])
    steps = jnp.arange(51, dtype=jnp.int32)
    want = np.asarray(jax.vmap(lambda s: jnp.asarray(js(s), jnp.float32))(
        steps))
    got = np.array([ps(torch.tensor(s, dtype=torch.int32)).item()
                    for s in range(51)], np.float32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0,
                               err_msg=name)


def test_schedule_is_computed_on_the_count_device():
    """A schedule of a count tensor is an f32 tensor on the count's
    device: nothing is read back to the host."""
    t = torch.tensor(3, dtype=torch.int32)
    out = _warmup(pupd)(t)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.device == t.device and out.ndim == 0


# -- updaters ---------------------------------------------------------------
def _upd_tree(rng):
    return {"W": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "ln": {"gamma": (1 + rng.normal(size=(4,))).astype(np.float32)},
            "mha": {"Wq": rng.normal(size=(4, 4)).astype(np.float32),
                    "bo": rng.normal(size=(4,)).astype(np.float32)}}


def _to_torch(t):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), t)


def _close(ours, theirs, tol, what):
    ours = jax.tree.map(lambda t: t.detach().float().numpy(), ours,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    jax.tree.map(lambda o, t: np.testing.assert_allclose(
        o, np.asarray(t, np.float32), atol=tol, rtol=0, err_msg=what),
        ours, theirs)


def _beans(name, scheduled, **extra):
    kw = dict(UPDATER_SPECS[name], **extra)
    ju, pu = getattr(jupd, name)(**kw), getattr(pupd, name)(**kw)
    if scheduled:
        ju.schedule, pu.schedule = _warmup(jupd), _warmup(pupd)
    return ju, pu


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["constant", "warmup_cosine"])
@pytest.mark.parametrize("name", sorted(UPDATER_SPECS) + ["AdamW_masked"])
def test_updater_matches_optax_over_five_steps(name, scheduled):
    extra = {}
    if name == "AdamW_masked":
        name, extra = "AdamW", {"exclude_bias_and_norm": True}
    ju, pu = _beans(name, scheduled, **extra)
    rng = np.random.default_rng(0)
    p0 = _upd_tree(rng)
    grads = [_upd_tree(rng) for _ in range(5)]
    tx = ju.to_optax()
    jp = jax.tree.map(jnp.asarray, p0)
    st = tx.init(jp)
    pp = _to_torch(p0)
    pst = pu.init_state(pp)
    for i, g in enumerate(grads):
        u, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, u)
        pu_, pst = pu.update(_to_torch(g), pst, pp)
        pp = jax.tree.map(lambda a, d: a + d, pp, pu_)
        _close(pp, jp, UPD_TOL, f"{name} step {i}")
    if scheduled and name not in ("AdaDelta", "NoOp"):
        assert int(pst["schedule_count"]) == 5
    else:
        assert "schedule_count" not in pst


def test_adamw_schedule_scales_the_decay():
    """Under a schedule the decay is added before the scheduled rate
    scales the update: with a zero gradient the applied decay is
    ``lr_t·wd·p``."""
    p = _to_torch(_upd_tree(np.random.default_rng(1)))
    zero = jax.tree.map(torch.zeros_like, p)
    sched = pupd.FixedSchedule(value=0.3)
    opt = pupd.AdamW(learning_rate=0.1, weight_decay=0.5, schedule=sched)
    u, st = opt.update(zero, opt.init_state(p), p)
    torch.testing.assert_close(u["W"], -0.3 * 0.5 * p["W"])
    assert int(st["schedule_count"]) == 1 and int(st["count"]) == 1


# -- the registry (twins of tests/test_updater_registry_roundtrip.py) ------
def _all_subclasses(cls):
    out = []
    for c in cls.__subclasses__():
        out.append(c)
        out.extend(_all_subclasses(c))
    return out


def test_every_updater_and_schedule_has_spec():
    """[``test_updater_registry_roundtrip.py:44``] and every bean of the
    JAX package exists in the port."""
    names_u = {c.__name__ for c in _all_subclasses(pupd.Updater)}
    assert names_u == set(UPDATER_SPECS)
    assert names_u == {c.__name__ for c in _all_subclasses(jupd.Updater)}
    names_s = {c.__name__ for c in pupd.Schedule.__subclasses__()}
    assert names_s == set(SCHEDULE_SPECS)
    assert names_s == {c.__name__ for c in jupd.Schedule.__subclasses__()}


@pytest.mark.parametrize("name", sorted(UPDATER_SPECS))
def test_updater_roundtrip(name):
    """[``:54``] ``to_dict`` → ``updater_from_dict`` gives the same bean,
    the JAX bean's dict, and the same update on a fixed gradient."""
    u = getattr(pupd, name)(**UPDATER_SPECS[name])
    d = u.to_dict()
    back = pupd.updater_from_dict(d)
    assert type(back) is type(u)
    assert back.to_dict() == d
    assert d == getattr(jupd, name)(**UPDATER_SPECS[name]).to_dict()
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 0.5)}
    probes = [bean.update(grads, bean.init_state(params), params)[0]["w"]
              for bean in (u, back)]
    assert torch.equal(probes[0], probes[1])


@pytest.mark.parametrize("name", sorted(SCHEDULE_SPECS))
def test_schedule_roundtrip(name):
    """[``:75``]"""
    s = getattr(pupd, name)(**SCHEDULE_SPECS[name])
    d = s.to_dict()
    back = pupd.schedule_from_dict(d)
    assert type(back) is type(s)
    assert d == getattr(jupd, name)(**SCHEDULE_SPECS[name]).to_dict()
    for step in (0, 7, 55, 99):
        np.testing.assert_allclose(float(s(step)), float(back(step)),
                                   rtol=1e-7, err_msg=f"{name}@{step}")


@pytest.mark.parametrize("name", sorted(set(UPDATER_SPECS) - {"NoOp"}))
def test_updater_with_schedule_roundtrip(name):
    """[``:86``]"""
    u = getattr(pupd, name)(**UPDATER_SPECS[name])
    u.schedule = pupd.StepSchedule(initial=0.1, decay_rate=0.5, step=5)
    back = pupd.updater_from_dict(u.to_dict())
    assert isinstance(back.schedule, pupd.StepSchedule)
    assert back.to_dict() == u.to_dict()


def test_warmup_schedule_nested_base_roundtrip():
    """[``:99``] warmup over a nested schedule serialises with @class
    and rehydrates; the default base is usable."""
    w = pupd.WarmupSchedule(warmup_steps=4,
                            base=pupd.CosineSchedule(initial=0.2,
                                                     max_iter=50))
    back = pupd.schedule_from_dict(w.to_dict())
    assert isinstance(back.base, pupd.CosineSchedule)
    for step in (0, 3, 10):
        np.testing.assert_allclose(float(w(step)), float(back(step)),
                                   rtol=1e-7)
    assert float(pupd.WarmupSchedule(warmup_steps=2)(0)) > 0


# -- opt_state_from_jax -----------------------------------------------------
def _nets(ju, pu):
    jconf = (JaxConf.builder().seed(3).updater(ju).list()
             .layer(JaxDense(n_out=6, activation="tanh"))
             .layer(JaxOutput(n_out=3, activation="softmax",
                              loss="mcxent"))
             .set_input_type(JaxInputType.feed_forward(5)).build())
    pconf = (NeuralNetConfiguration.builder().seed(3).updater(pu).list()
             .layer(pl.DenseLayer(n_out=6, activation="tanh"))
             .layer(pl.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
             .set_input_type(InputType.feed_forward(5)).build())
    return JaxMLN(jconf).init(), MultiLayerNetwork(pconf).init(
        device="cpu")


def _mlp_batches(n, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["constant", "warmup_cosine"])
@pytest.mark.parametrize("name", sorted(UPDATER_SPECS))
def test_opt_state_from_jax_then_one_more_step(name, scheduled):
    jnet, pnet = _nets(*_beans(name, scheduled))
    (x0, y0), (x1, y1), (x2, y2) = _mlp_batches(3)
    jnet.fit(x0, y0)
    jnet.fit(x1, y1)
    pnet.params_from_jax(jax.tree.map(np.asarray, jnet.params))
    pnet.opt_state_from_jax(jax.tree.map(np.asarray, jnet.opt_state))
    pnet.iteration = jnet.iteration
    # the loaded state is the JAX state, leaf for leaf
    jleaves = [np.asarray(a) for a in jax.tree.leaves(jnet.opt_state)]
    pleaves = [t.numpy() for t in tree.leaves(pnet.opt_state)]
    assert len(pleaves) == len(jleaves)
    assert sorted(a.tobytes() for a in pleaves) == \
        sorted(a.tobytes() for a in jleaves)
    if scheduled and name not in ("AdaDelta", "NoOp"):
        for group in pnet.opt_state.values():
            assert int(group["schedule_count"]) == 2
    jnet.fit(x2, y2)
    pnet.fit(x2, y2)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jnet.params)
    _close(pnet.params, jp, LOAD_STEP_TOL, name)


def test_opt_state_from_jax_refuses_a_foreign_state():
    jnet, _ = _nets(*_beans("Adam", False))
    _, pnet = _nets(*_beans("RmsProp", False))
    with pytest.raises(ValueError, match="not in the JAX"):
        pnet.opt_state_from_jax(jax.tree.map(np.asarray, jnet.opt_state))
