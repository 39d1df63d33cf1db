"""Recurrent layers (port of ``deeplearning4j_tpu/nn/layers/recurrent.py``),
[B, T, F] layout.

Reference classes (deeplearning4j-nn): LSTM, GravesLSTM,
GravesBidirectionalLSTM, SimpleRnn, recurrent.Bidirectional,
recurrent.LastTimeStep, util.MaskZeroLayer, misc.TimeDistributed,
RnnOutputLayer and RnnLossLayer; the GRU of libnd4j's ``gruCell``; and
the Keras ConvLSTM2D. The math is the JAX package's, in torch ops:

- the input projection of every time step is one GEMM,
  ``[B·T, F] @ [F, G·H] + b``; only the recurrent part runs in the time
  loop, a Python loop over T of torch ops (the JAX layers' ``lax.scan``);
- the LSTM's gates are packed [i, f, o, g] with one bias; GravesLSTM adds
  the peepholes ``P[3, H]``, on i and f from ``c_{t−1}`` and on o from
  ``c_t``. cuDNN's cell has two biases, another gate order and no
  peepholes, so it is not used;
- a masked step holds the carries (h, c) and emits zeros;
- ``initial_state`` goes in and the final carries ``{"h"[, "c"]}`` come
  out as the layer's second result, so truncated BPTT and
  ``MultiLayerNetwork.rnn_time_step`` resume from them.

A recurrent layer cannot run on a rank's shard of the time axis under a
sequence-parallel context: its carry would have to pass from rank to
rank (``ROADMAP.md`` C9, a difference by design).

The wrappers of a recurrent layer (Bidirectional, LastTimeStep,
MaskZeroLayer) return its carries as their second result, as the JAX
wrappers do; the networks keep such a layer's state as it was
(:func:`returns_carries`), where the JAX networks store the carries as
the wrapper's layer state (``ROADMAP.md`` C10).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, register_layer,
                                                     split_seed)
from deeplearning4j_tpu_torch.nn.layers.conv import _conv
from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer, LossLayer,
                                                     OutputLayer)
from deeplearning4j_tpu_torch.ops import activations

#: why a layer with a time loop stays refused under a sequence-parallel
#: context (``Layer.mixes_positions``)
SEQ_REFUSAL = "ROADMAP.md C9"


def _time_mask(mask, dtype):
    """The [B, T] mask as [B, T, 1] in ``dtype``, or None."""
    return None if mask is None else mask.to(dtype)[..., None]


def _hold(mt, new, old):
    """A masked step's carry: ``new`` where ``mt`` is 1, ``old`` where 0."""
    return new if mt is None else mt * new + (1 - mt) * old


def _emit(mt, y):
    return y if mt is None else y * mt


class BaseRecurrentLayer(Layer):
    """Common recurrent machinery: a recurrent layer returns (y[B,T,H], its
    final carries) so truncated BPTT can resume from them."""
    #: scans the sequence
    mixes_positions = SEQ_REFUSAL


@register_layer
@dataclass
class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes (reference LSTM). Gate order [i, f, o, g]
    like the reference LSTMHelpers; the forget gate's bias starts at
    ``forget_gate_bias_init``."""
    n_in: Optional[int] = None
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    peephole: bool = field(default=False, repr=False)

    def init(self, gen, input_shape, dtype=torch.float32):
        n_in = self.n_in or input_shape[-1]
        h = self.n_out
        wi = winit.get(self.weight_init or "xavier")
        params = {
            "W": wi(gen, (n_in, 4 * h), dtype),   # input → gates
            "U": wi(gen, (h, 4 * h), dtype),      # recurrent → gates
            "b": torch.cat([
                torch.zeros((h,), dtype=dtype),
                torch.full((h,), self.forget_gate_bias_init, dtype=dtype),
                torch.zeros((2 * h,), dtype=dtype)]),
        }
        if self.peephole:
            params["P"] = torch.zeros((3, h), dtype=dtype)  # pi, pf, po
        t = input_shape[0] if len(input_shape) == 2 else None
        return params, {}, (t, h)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None,
              initial_state=None):
        b, t, _ = x.shape
        h = self.n_out
        gate_act = activations.get(self.gate_activation)
        act = self._act("tanh")
        if initial_state is None:
            hp = x.new_zeros((b, h))
            cp = x.new_zeros((b, h))
        else:
            hp, cp = initial_state["h"], initial_state["c"]
        # one GEMM for every time step's input projection
        xg = (x.reshape(b * t, -1) @ params["W"] + params["b"]).reshape(
            b, t, 4 * h)
        m = _time_mask(mask, x.dtype)
        U, P = params["U"], params.get("P")
        ys = []
        for s in range(t):
            z = xg[:, s] + hp @ U
            zi, zf, zo, zg = z.split(h, dim=-1)
            if P is not None:      # Graves peepholes on i, f from c_{t-1}
                zi = zi + cp * P[0]
                zf = zf + cp * P[1]
            i = gate_act(zi)
            f = gate_act(zf)
            c = f * cp + i * act(zg)
            if P is not None:      # the peephole on o from c_t
                zo = zo + c * P[2]
            hh = gate_act(zo) * act(c)
            mt = None if m is None else m[:, s]
            cp, hp = _hold(mt, c, cp), _hold(mt, hh, hp)
            ys.append(_emit(mt, hh))
        y = torch.stack(ys, dim=1)
        return self._maybe_dropout(y, train, rng), {"h": hp, "c": cp}


@register_layer
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference GravesLSTM, per Graves
    2013)."""
    peephole: bool = field(default=True, repr=False)


@register_layer
@dataclass
class SimpleRnn(BaseRecurrentLayer):
    """Elman RNN: h_t = act(x W + b + h_{t-1} U) (reference SimpleRnn)."""
    n_in: Optional[int] = None
    n_out: int = 0

    def init(self, gen, input_shape, dtype=torch.float32):
        n_in = self.n_in or input_shape[-1]
        wi = winit.get(self.weight_init or "xavier")
        params = {"W": wi(gen, (n_in, self.n_out), dtype),
                  "U": wi(gen, (self.n_out, self.n_out), dtype),
                  "b": torch.zeros((self.n_out,), dtype=dtype)}
        t = input_shape[0] if len(input_shape) == 2 else None
        return params, {}, (t, self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None,
              initial_state=None):
        b, t, _ = x.shape
        act = self._act("tanh")
        hp = (x.new_zeros((b, self.n_out)) if initial_state is None
              else initial_state["h"])
        xg = x @ params["W"] + params["b"]
        m = _time_mask(mask, x.dtype)
        U = params["U"]
        ys = []
        for s in range(t):
            hh = act(xg[:, s] + hp @ U)
            mt = None if m is None else m[:, s]
            hp = _hold(mt, hh, hp)
            ys.append(_emit(mt, hh))
        y = torch.stack(ys, dim=1)
        return self._maybe_dropout(y, train, rng), {"h": hp}


@register_layer
@dataclass
class GRU(BaseRecurrentLayer):
    """GRU (reference libnd4j ``gruCell`` op / samediff GRU), gates packed
    [r, z, n].

    ``reset_after=False`` (default, the paper/libnd4j formulation):
    ``n = act(x·Wn + (r ⊙ h)·Un + bn)``. ``reset_after=True`` (the
    cuDNN-compatible variant, Keras default): ``n = act(x·Wn +
    r ⊙ (h·Un + rbn))`` with a separate recurrent bias ``rb``.
    """
    n_in: Optional[int] = None
    n_out: int = 0
    gate_activation: str = "sigmoid"
    reset_after: bool = False

    def init(self, gen, input_shape, dtype=torch.float32):
        n_in = self.n_in or input_shape[-1]
        h = self.n_out
        wi = winit.get(self.weight_init or "xavier")
        params = {"W": wi(gen, (n_in, 3 * h), dtype),
                  "U": wi(gen, (h, 3 * h), dtype),
                  "b": torch.zeros((3 * h,), dtype=dtype)}
        if self.reset_after:
            params["rb"] = torch.zeros((3 * h,), dtype=dtype)
        t = input_shape[0] if len(input_shape) == 2 else None
        return params, {}, (t, h)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None,
              initial_state=None):
        b, t, _ = x.shape
        h = self.n_out
        gact = activations.get(self.gate_activation)
        act = self._act("tanh")
        hp = (x.new_zeros((b, h)) if initial_state is None
              else initial_state["h"])
        xg = (x.reshape(b * t, -1) @ params["W"] + params["b"]).reshape(
            b, t, 3 * h)
        m = _time_mask(mask, x.dtype)
        U = params["U"]
        Urz, Un = U[:, :2 * h], U[:, 2 * h:]
        ys = []
        for s in range(t):
            xr, xz, xn = xg[:, s].split(h, dim=-1)
            if self.reset_after:
                hr, hz, hn_ = (hp @ U + params["rb"]).split(h, dim=-1)
                r = gact(xr + hr)
                z = gact(xz + hz)
                n = act(xn + r * hn_)
            else:
                hr, hz = (hp @ Urz).split(h, dim=-1)
                r = gact(xr + hr)
                z = gact(xz + hz)
                n = act(xn + (r * hp) @ Un)
            hh = (1 - z) * n + z * hp
            mt = None if m is None else m[:, s]
            hp = _hold(mt, hh, hp)
            ys.append(_emit(mt, hh))
        y = torch.stack(ys, dim=1)
        return self._maybe_dropout(y, train, rng), {"h": hp}


def returns_carries(layer) -> bool:
    """Does ``layer`` return recurrent carries where other layers return
    their new layer state: a recurrent layer, or a wrapper of one? The
    networks keep such a layer's state unchanged."""
    if isinstance(layer, BaseRecurrentLayer):
        return True
    inner = (layer.fwd if isinstance(layer, Bidirectional)
             else layer.underlying if isinstance(layer, (LastTimeStep,
                                                         MaskZeroLayer))
             else None)
    return inner is not None and returns_carries(inner)


def _lengths(mask):
    """Each row's count of valid steps in a [B, T] mask."""
    return mask.to(torch.int64).sum(dim=1)


def _take_steps(x, idx):
    """``x[b, idx[b, j]]`` along axis 1 for every row b: ``idx`` [B, J]."""
    shape = idx.shape + (1,) * (x.ndim - 2)
    return torch.gather(x, 1, idx.reshape(shape).expand(
        idx.shape + x.shape[2:]))


def _reverse_padded(x, lengths):
    """Reverse each sequence's valid prefix, keeping padding in place."""
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    rev = lengths[:, None] - 1 - idx
    return _take_steps(x, torch.where(idx < lengths[:, None], rev, idx))


@register_layer
@dataclass
class Bidirectional(Layer):
    """Bidirectional wrapper (reference recurrent.Bidirectional; covers
    GravesBidirectionalLSTM as Bidirectional(GravesLSTM)). Modes: concat,
    add, mul, average (reference Bidirectional.Mode). Under a mask the
    backward pass reverses only each row's valid prefix."""
    fwd: Optional[Layer] = None
    mode: str = "concat"
    mixes_positions = SEQ_REFUSAL

    def init(self, gen, input_shape, dtype=torch.float32):
        pf, sf, of = self.fwd.init(gen, input_shape, dtype)
        pb, sb, _ = self.fwd.init(gen, input_shape, dtype)
        out = of
        if self.mode == "concat":
            out = of[:-1] + (of[-1] * 2,)
        return {"fwd": pf, "bwd": pb}, {"fwd": sf, "bwd": sb}, out

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        r1, r2 = split_seed(rng) if rng is not None else (None, None)
        yf, sf = self.fwd.apply(params["fwd"], state.get("fwd", {}), x,
                                train=train, rng=r1, mask=mask)
        if mask is not None:
            lengths = _lengths(mask)
            xr = _reverse_padded(x, lengths)
        else:
            xr = torch.flip(x, dims=(1,))
        yb, sb = self.fwd.apply(params["bwd"], state.get("bwd", {}), xr,
                                train=train, rng=r2, mask=mask)
        # back to forward time, unless the wrapped layer collapsed the
        # time axis (LastTimeStep)
        if yb.ndim >= 3:
            yb = (_reverse_padded(yb, lengths) if mask is not None
                  else torch.flip(yb, dims=(1,)))
        if self.mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == "add":
            y = yf + yb
        elif self.mode == "mul":
            y = yf * yb
        elif self.mode == "average":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(f"unknown Bidirectional mode {self.mode!r}")
        return y, {"fwd": sf, "bwd": sb}


@register_layer
@dataclass
class LastTimeStep(Layer):
    """Wraps a recurrent layer and emits only the last *valid* time step
    (reference recurrent.LastTimeStep)."""
    underlying: Optional[Layer] = None
    mixes_positions = SEQ_REFUSAL

    def init(self, gen, input_shape, dtype=torch.float32):
        p, s, out = self.underlying.init(gen, input_shape, dtype)
        return p, s, (out[-1],)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y, s = self.underlying.apply(params, state, x, train=train, rng=rng,
                                     mask=mask)
        if mask is not None:
            last = torch.clamp_min(_lengths(mask) - 1, 0)
            return _take_steps(y, last[:, None])[:, 0], s
        return y[:, -1], s

    def propagate_mask(self, mask, input_shape):
        return None


@register_layer
@dataclass
class MaskZeroLayer(Layer):
    """Derives a time mask from the input rows not all equal to
    ``mask_value`` and applies the underlying layer with it (reference
    util.MaskZeroLayer)."""
    underlying: Optional[Layer] = None
    mask_value: float = 0.0
    mixes_positions = SEQ_REFUSAL

    def init(self, gen, input_shape, dtype=torch.float32):
        return self.underlying.init(gen, input_shape, dtype)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        derived = (x != self.mask_value).any(dim=-1).to(x.dtype)
        if mask is not None:
            derived = derived * mask
        return self.underlying.apply(params, state, x, train=train, rng=rng,
                                     mask=derived)


@register_layer
@dataclass
class TimeDistributed(Layer):
    """Applies a feed-forward layer to each time step alone (reference
    misc.TimeDistributed): time folded into the batch around one call.
    The underlying layer sees single positions as rows, so on the rank's
    shard of a sequence it runs with the context's layout cleared
    (``parallel.mesh.unsharded``): a dense layer does not gather them as
    a sequence. It mixes positions where the underlying layer mixes rows
    (batch norm)."""
    underlying: Optional[Layer] = None

    @property
    def mixes_positions(self):
        return self.underlying.mixes_positions

    def init(self, gen, input_shape, dtype=torch.float32):
        p, s, out = self.underlying.init(gen, input_shape[1:], dtype)
        return p, s, (input_shape[0],) + tuple(out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b, t = x.shape[:2]
        flat = x.reshape((b * t,) + tuple(x.shape[2:]))
        from deeplearning4j_tpu_torch.parallel.mesh import unsharded
        with unsharded():
            y, s = self.underlying.apply(params, state, flat, train=train,
                                         rng=rng)
        return y.reshape((b, t) + tuple(y.shape[1:])), s


@register_layer
@dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + loss head over [B, T, F] (reference
    RnnOutputLayer)."""
    mixes_positions = False
    pools_sequence = False

    def init(self, gen, input_shape, dtype=torch.float32):
        n_in = self.n_in or input_shape[-1]
        params, state, _ = DenseLayer.init(self, gen, (n_in,), dtype)
        t = input_shape[0] if len(input_shape) == 2 else None
        return params, state, (t, self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return self._act()(z), state


@register_layer
@dataclass
class RnnLossLayer(LossLayer):
    """Loss-only over sequences (reference RnnLossLayer)."""


@register_layer
@dataclass
class GravesBidirectionalLSTM(Bidirectional):
    """Reference GravesBidirectionalLSTM: forward and backward GravesLSTM
    passes SUMMED (the output width stays ``n_out``, unlike
    Bidirectional's default concat)."""
    n_in: Optional[int] = None
    n_out: int = 0
    mode: str = "add"

    def __post_init__(self):
        if self.fwd is None:
            self.fwd = GravesLSTM(
                n_in=self.n_in, n_out=self.n_out,
                activation=self.activation,
                weight_init=self.weight_init, dropout=self.dropout,
                l1=self.l1, l2=self.l2, bias_init=self.bias_init)


@register_layer
@dataclass
class ConvLSTM2D(Layer):
    """Convolutional LSTM over [B, T, H, W, C] (Keras ConvLSTM2D): every
    gate is a convolution — the input path convolves each frame (one
    convolution of all B·T frames, ``padding`` and ``stride`` as given),
    the recurrent path the hidden state (stride 1, SAME, so the spatial
    size holds) inside the time loop. Gates packed [i, f, c, o] as Keras
    packs them. XLA's padding is made explicit, as the port's
    convolution layers make it (``nn/layers/conv.py``). No mask."""
    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: tuple = (3, 3)
    stride: tuple = (1, 1)
    padding: str = "VALID"
    gate_activation: str = "hardsigmoid_keras"
    return_sequences: bool = True
    forget_gate_bias_init: float = 1.0
    mixes_positions = SEQ_REFUSAL

    def _out_hw(self, h, w):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        if self.padding.upper() == "SAME":
            return -(-h // sh), -(-w // sw)
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def init(self, gen, input_shape, dtype=torch.float32):
        t, h, w, c = input_shape
        c = self.n_in or c
        f = self.n_out
        kh, kw = self.kernel_size
        wi = winit.get(self.weight_init or "xavier")
        bias = torch.cat([
            torch.zeros((f,), dtype=dtype),
            torch.full((f,), self.forget_gate_bias_init, dtype=dtype),
            torch.zeros((2 * f,), dtype=dtype)])
        params = {"Wx": wi(gen, (kh, kw, c, 4 * f), dtype),
                  "Wh": wi(gen, (kh, kw, f, 4 * f), dtype),
                  "b": bias}
        oh, ow = self._out_hw(h, w)
        out = (t, oh, ow, f) if self.return_sequences else (oh, ow, f)
        return params, {}, out

    def apply(self, params, state, x, *, train=False, rng=None,
              mask=None):
        b, t, h, w, c = x.shape
        f = self.n_out
        k = tuple(self.kernel_size)
        gate = activations.get(self.gate_activation)
        act = self._act("tanh")
        xg = _conv(x.reshape(b * t, h, w, c), params["Wx"], k,
                   tuple(self.stride), (1, 1), self.padding.upper(),
                   1) + params["b"]
        oh, ow = xg.shape[1:3]
        xg = xg.reshape(b, t, oh, ow, 4 * f)
        hp = x.new_zeros((b, oh, ow, f))
        cp = hp
        ys = []
        for s in range(t):
            z = xg[:, s] + _conv(hp, params["Wh"], k, (1, 1), (1, 1),
                                 "SAME", 1)
            zi, zf, zc, zo = z.split(f, dim=-1)       # Keras order
            cp = gate(zf) * cp + gate(zi) * act(zc)
            hp = gate(zo) * act(cp)
            ys.append(hp)
        if not self.return_sequences:
            return hp, state
        return torch.stack(ys, dim=1), state
