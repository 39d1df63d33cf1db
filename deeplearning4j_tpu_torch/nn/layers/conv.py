"""Convolution, pooling and spatial layers (port of
``deeplearning4j_tpu/nn/layers/conv.py``): the 1-, 2- and 3-D
convolutions, the transposed, depthwise and separable 2-D convolutions,
1-, 2- and 3-D pooling, global pooling, upsampling, zero padding,
cropping, and space-to-depth and back.

The API is the JAX package's: activations are channels-last ([B, T, C],
[B, H, W, C], [B, D, H, W, C]) and kernels are stored spatial-first,
[*k, in/groups, out] (HWIO), under the same names (``W``, ``b``;
``depthW``, ``pointW``), so a JAX network's weights load as a plain
copy. The JAX layers leave the convolution and the pooling to XLA
(``lax.conv_general_dilated``, ``lax.conv_transpose``,
``lax.reduce_window``), not to a Pallas kernel; the port leaves them to
PyTorch's convolution (cuDNN on the card) and pooling ops. Inside
``apply`` a channels-last tensor is viewed as channels-first in the
channels-last memory format (a permute, no copy, :func:`_torch_perms`),
and the result is viewed back, so the flatten of a following dense
layer reads the axes in the JAX package's order.

Padding is XLA's: ``VALID``, or ``SAME`` with ``ceil(size / stride)``
outputs and ``total // 2`` of the padding before, the rest after — which
is asymmetric where the padding is odd, so the port pads explicitly
(:func:`_same_pads`) instead of using PyTorch's own padding. SAME max
pooling pads with −inf; SAME average pooling divides each window by the
count of its unpadded elements (not PyTorch's ``count_include_pad``
rule); sum and pnorm pooling pad with zeros. The transposed convolution
is ``lax.conv_transpose``'s: the input dilated by the stride, padded by
XLA's transpose padding and correlated with the kernel as stored (not
flipped), which the port computes as PyTorch's transposed convolution
of the flipped kernel, cut or zero-extended to XLA's padding.

``GlobalPoolingLayer`` pools a [B, T, F] sequence under its [B, T] mask
(masked steps left out of every pooling type), and always collapses the
pooled axes, as the JAX layer does. Under a sequence-parallel context it
is refused (``Layer.mixes_positions``): pooling there, as an all-reduce
of each rank's partial pool, comes with ROADMAP item A10.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer

_PADDINGS = ("VALID", "SAME")


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    if len(t) != n:
        raise ValueError(f"expected {n}-tuple, got {t}")
    return t


def _conv_dims(n_spatial):
    """The JAX layers' channels-last ``dimension_numbers`` for a 1-, 2-
    or 3-D convolution: the layouts of this module's inputs, kernels and
    outputs."""
    return {1: ("NWC", "WIO", "NWC"),
            2: ("NHWC", "HWIO", "NHWC"),
            3: ("NDHWC", "DHWIO", "NDHWC")}[n_spatial]


def _torch_perms(n_spatial):
    """The permutations from :func:`_conv_dims`' layouts to PyTorch's
    channels-first ones and back: (input → N C *spatial, kernel →
    O I *spatial, N C *spatial → output). Applied to a contiguous
    channels-last tensor, the first is a view in the channels-last
    memory format, which cuDNN takes as it is."""
    lhs, rhs, out = _conv_dims(n_spatial)
    first = "NC" + lhs[1:-1]
    return (tuple(lhs.index(c) for c in first),
            tuple(rhs.index(c) for c in "OI" + lhs[1:-1]),
            tuple(first.index(c) for c in out))


def _out_spatial(size, k, s, d, padding):
    eff = (k - 1) * d + 1
    if padding == "SAME":
        return -(-size // s)
    return (size - eff) // s + 1


def _check_padding(padding: str) -> None:
    if padding not in _PADDINGS:
        raise ValueError(f"padding {padding!r}: expected one of "
                         f"{_PADDINGS}")


def _same_pads(sizes, k, s, d, padding) -> Tuple[int, ...]:
    """``F.pad``'s tuple (last spatial axis first, before then after) for
    XLA's ``padding`` over spatial ``sizes`` with kernel ``k``, stride
    ``s`` and dilation ``d``: zeros for VALID; for SAME the total that
    gives ``ceil(size / s)`` outputs, ``total // 2`` before."""
    pads = []
    for n, kk, ss, dd in zip(sizes, k, s, d):
        if padding == "SAME":
            total = max((-(-n // ss) - 1) * ss + (kk - 1) * dd + 1 - n, 0)
        else:
            total = 0
        pads.append((total // 2, total - total // 2))
    return tuple(p for before_after in reversed(pads) for p in before_after)




#: PyTorch's convolution by spatial rank
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(x, w, k, s, d, padding, groups):
    """XLA's channels-last convolution of ``x`` [B, *spatial, C] with the
    spatial-first kernel ``w`` [*k, C / groups, out]: ``padding`` made
    explicit, the correlation by PyTorch's convolution on channels-first
    views."""
    n = len(k)
    to_first, kernel, back = _torch_perms(n)
    pads = _same_pads(x.shape[1:1 + n], k, s, d, padding)
    xc = x.permute(to_first)
    if any(pads):
        xc = F.pad(xc, pads)
    y = _CONV[n](xc, w.permute(kernel), stride=s, dilation=d,
                 groups=groups)
    return y.permute(back)


def _transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding (before, after) of the dilated
    input along one axis, for kernel ``k`` and stride ``s``."""
    if padding == "SAME":
        total = k + s - 2
        before = k - 1 if s > k - 1 else -(-total // 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        before = k - 1
    return before, total - before


@register_layer
@dataclass
class ConvolutionLayer(Layer):
    """2-D convolution (reference ConvolutionLayer): [B, H, W, C_in] →
    [B, H', W', n_out], kernel ``W`` [kh, kw, C_in / groups, n_out]; the
    1-D and 3-D subclasses change ``_spatial``."""
    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Sequence[int] = (3, 3)
    stride: Sequence[int] = (1, 1)
    padding: str = "VALID"            # reference ConvolutionMode
    dilation: Sequence[int] = (1, 1)
    has_bias: bool = True
    groups: int = 1
    _spatial: int = field(default=2, repr=False)

    def _geometry(self):
        """(kernel, stride, dilation) as ``_spatial``-tuples, after the
        padding mode is checked."""
        _check_padding(self.padding)
        n = self._spatial
        return (_tup(self.kernel_size, n), _tup(self.stride, n),
                _tup(self.dilation, n))

    def _kshape(self, c_in):
        return _tup(self.kernel_size, self._spatial) + (
            c_in // self.groups, self.n_out)

    def _bias(self, params, dtype):
        """``params`` with the bias ``b`` added when the layer has one."""
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype)
        return params

    def init(self, gen, input_shape, dtype=torch.float32):
        k, s, d = self._geometry()
        c_in = self.n_in or input_shape[-1]
        params = self._bias({"W": winit.get(self.weight_init or "xavier")(
            gen, self._kshape(c_in), dtype)}, dtype)
        out_sp = tuple(_out_spatial(input_shape[i], k[i], s[i], d[i],
                                    self.padding)
                       for i in range(self._spatial))
        return params, {}, out_sp + (self.n_out,)

    def _conv(self, x, w):
        k, s, d = self._geometry()
        return _conv(x, w, k, s, d, self.padding, self.groups)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        z = self._conv(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        y = self._act()(z)
        return self._maybe_dropout(y, train, rng), state


@register_layer
@dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1-D convolution over [B, T, C] (reference Convolution1DLayer); a
    VALID convolution keeps the mask of each output's first input
    step."""
    kernel_size: Sequence[int] = (3,)
    stride: Sequence[int] = (1,)
    dilation: Sequence[int] = (1,)
    _spatial: int = field(default=1, repr=False)

    def propagate_mask(self, mask, input_shape):
        if mask is None or self.padding == "SAME":
            return mask
        (k,), (s,), (d,) = self._geometry()
        t_out = _out_spatial(mask.shape[1], k, s, d, self.padding)
        return mask[:, :t_out * s:s]


@register_layer
@dataclass
class Convolution3DLayer(ConvolutionLayer):
    """3-D convolution over [B, D, H, W, C] (reference Convolution3D)."""
    kernel_size: Sequence[int] = (3, 3, 3)
    stride: Sequence[int] = (1, 1, 1)
    dilation: Sequence[int] = (1, 1, 1)
    _spatial: int = field(default=3, repr=False)


@register_layer
@dataclass
class Deconvolution2DLayer(ConvolutionLayer):
    """Transposed 2-D convolution (reference Deconvolution2D), kernel
    ``W`` [kh, kw, C_in, n_out]: ``lax.conv_transpose`` with the layer's
    stride and padding (its dilation unused, as in the JAX layer)."""

    def init(self, gen, input_shape, dtype=torch.float32):
        _check_padding(self.padding)
        c_in = self.n_in or input_shape[-1]
        k, s = _tup(self.kernel_size, 2), _tup(self.stride, 2)
        params = self._bias({"W": winit.get(self.weight_init or "xavier")(
            gen, k + (c_in, self.n_out), dtype)}, dtype)
        if self.padding == "SAME":
            out_sp = tuple(input_shape[i] * s[i] for i in range(2))
        else:
            out_sp = tuple((input_shape[i] - 1) * s[i] + k[i]
                           for i in range(2))
        return params, {}, out_sp + (self.n_out,)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        _check_padding(self.padding)
        k, s = _tup(self.kernel_size, 2), _tup(self.stride, 2)
        to_first, _, back = _torch_perms(2)
        # PyTorch's transposed convolution correlates the dilated input,
        # padded k - 1 each side, with the flipped kernel: flip it back,
        # then keep XLA's window of that full result
        w = params["W"].permute(2, 3, 0, 1).flip((2, 3))
        full = F.conv_transpose2d(x.permute(to_first), w, stride=s)
        cut, extend = [], []
        for i in range(2):
            before, after = _transpose_pads(k[i], s[i], self.padding)
            n_out = (x.shape[1 + i] - 1) * s[i] + before + after + 2 - k[i]
            start = k[i] - 1 - before
            cut.append(slice(start, start + n_out))
            extend.append(max(start + n_out - full.shape[2 + i], 0))
        z = full[:, :, cut[0], cut[1]]
        if any(extend):          # windows over the padding alone: zeros
            z = F.pad(z, (0, extend[1], 0, extend[0]))
        z = z.permute(back)
        if self.has_bias:
            z = z + params["b"]
        return self._act()(z), state


@register_layer
@dataclass
class DepthwiseConvolution2DLayer(ConvolutionLayer):
    """Depthwise 2-D convolution (reference DepthwiseConvolution2D):
    ``depth_multiplier`` output channels per input channel, kernel ``W``
    [kh, kw, 1, C_in · depth_multiplier]. ``init`` sets ``n_out``, as the
    JAX layer does."""
    depth_multiplier: int = 1

    def init(self, gen, input_shape, dtype=torch.float32):
        k, s, d = self._geometry()
        c_in = self.n_in or input_shape[-1]
        self.n_out = c_in * self.depth_multiplier
        params = self._bias({"W": winit.get(self.weight_init or "xavier")(
            gen, k + (1, self.n_out), dtype)}, dtype)
        out_sp = tuple(_out_spatial(input_shape[i], k[i], s[i], d[i],
                                    self.padding) for i in range(2))
        return params, {}, out_sp + (self.n_out,)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k, s, d = self._geometry()
        z = _conv(x, params["W"], k, s, d, self.padding, x.shape[-1])
        if self.has_bias:
            z = z + params["b"]
        return self._act()(z), state


@register_layer
@dataclass
class SeparableConvolution2DLayer(ConvolutionLayer):
    """Depthwise then pointwise 2-D convolution (reference
    SeparableConvolution2D): ``depthW`` [kh, kw, 1, C_in · m], then
    ``pointW`` [1, 1, C_in · m, n_out]."""
    depth_multiplier: int = 1

    def init(self, gen, input_shape, dtype=torch.float32):
        k, s, d = self._geometry()
        c_in = self.n_in or input_shape[-1]
        wi = winit.get(self.weight_init or "xavier")
        mid = c_in * self.depth_multiplier
        params = self._bias({
            "depthW": wi(gen, k + (1, mid), dtype),
            "pointW": wi(gen, (1, 1, mid, self.n_out), dtype)}, dtype)
        out_sp = tuple(_out_spatial(input_shape[i], k[i], s[i], d[i],
                                    self.padding) for i in range(2))
        return params, {}, out_sp + (self.n_out,)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k, s, d = self._geometry()
        z = _conv(x, params["depthW"], k, s, d, self.padding, x.shape[-1])
        z = _conv(z, params["pointW"], (1, 1), (1, 1), (1, 1), "VALID", 1)
        if self.has_bias:
            z = z + params["b"]
        return self._act()(z), state


@register_layer
@dataclass
class SubsamplingLayer(Layer):
    """2-D pooling (reference SubsamplingLayer, PoolingType MAX, AVG,
    PNORM and SUM) over [B, H, W, C]; the 1-D and 3-D subclasses change
    ``_spatial`` (1-D pooling runs as 2-D pooling over a unit axis)."""
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: str = "VALID"
    pooling_type: str = "max"
    pnorm: int = 2
    _spatial: int = field(default=2, repr=False)

    def _geometry(self):
        _check_padding(self.padding)
        n = self._spatial
        return _tup(self.kernel_size, n), _tup(self.stride, n)

    def init(self, gen, input_shape, dtype=torch.float32):
        k, s = self._geometry()
        out_sp = tuple(_out_spatial(input_shape[i], k[i], s[i], 1,
                                    self.padding)
                       for i in range(self._spatial))
        return {}, {}, out_sp + (input_shape[-1],)

    @staticmethod
    def _window_sum(xc, k, s, pads):
        """The sum over each window of ``xc`` [B, C, *spatial] padded
        with zeros by ``pads``."""
        if any(pads):
            xc = F.pad(xc, pads)
        pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
        return pool(xc, k, s, divisor_override=1)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k, s = self._geometry()
        if self._spatial == 1:           # [B, T, C] as [B, 1, T, C]
            x = x.unsqueeze(1)
            k, s = (1,) + k, (1,) + s
        n = len(k)
        to_first, _, back = _torch_perms(n)
        pads = _same_pads(x.shape[1:1 + n], k, s, (1,) * n, self.padding)
        xc = x.permute(to_first)
        pt = self.pooling_type.lower()
        if pt == "max":
            if any(pads):
                xc = F.pad(xc, pads, value=-math.inf)
            y = (F.max_pool2d if n == 2 else F.max_pool3d)(xc, k, s)
        elif pt in ("avg", "mean"):
            total = self._window_sum(xc, k, s, pads)
            ones = torch.ones((1, 1) + tuple(x.shape[1:1 + n]),
                              dtype=x.dtype, device=x.device)
            y = total / self._window_sum(ones, k, s, pads)
        elif pt == "pnorm":
            p = float(self.pnorm)
            y = self._window_sum(xc.abs() ** p, k, s, pads) ** (1.0 / p)
        elif pt == "sum":
            y = self._window_sum(xc, k, s, pads)
        else:
            raise ValueError(f"unknown pooling type {self.pooling_type!r}")
        y = y.permute(back)
        return (y.squeeze(1) if self._spatial == 1 else y), state


@register_layer
@dataclass
class Subsampling1DLayer(SubsamplingLayer):
    """1-D pooling over [B, T, C] (reference Subsampling1DLayer)."""
    kernel_size: Sequence[int] = (2,)
    stride: Sequence[int] = (2,)
    _spatial: int = field(default=1, repr=False)


@register_layer
@dataclass
class Subsampling3DLayer(SubsamplingLayer):
    """3-D pooling over [B, D, H, W, C] (reference Subsampling3DLayer)."""
    kernel_size: Sequence[int] = (2, 2, 2)
    stride: Sequence[int] = (2, 2, 2)
    _spatial: int = field(default=3, repr=False)


@register_layer
@dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over every spatial or time axis (reference
    GlobalPoolingLayer, MAX, AVG, SUM and PNORM): [B, *axes, C] → [B, C].
    A [B, T, F] input with a [B, T] mask pools its unmasked steps only
    (an all-masked row averages to 0); the mask ends here."""
    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True
    #: pools the whole sequence: under a sequence-parallel context that is
    #: an all-reduce of the ranks' partial pools
    mixes_positions = "ROADMAP item A10"

    def init(self, gen, input_shape, dtype=torch.float32):
        return {}, {}, (input_shape[-1],)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        pt = self.pooling_type.lower()
        if mask is not None and x.ndim == 3:
            m = mask[..., None].to(x.dtype)
            if pt == "max":
                y = torch.where(m > 0, x, -math.inf).amax(dim=1)
            elif pt in ("avg", "mean"):
                y = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1),
                                                        1e-9)
            elif pt == "sum":
                y = (x * m).sum(dim=1)
            elif pt == "pnorm":
                p = float(self.pnorm)
                y = ((x.abs() * m) ** p).sum(dim=1) ** (1 / p)
            else:
                raise ValueError(self.pooling_type)
            return y, state
        axes = tuple(range(1, x.ndim - 1))
        if pt == "max":
            y = x.amax(dim=axes)
        elif pt in ("avg", "mean"):
            y = x.mean(dim=axes)
        elif pt == "sum":
            y = x.sum(dim=axes)
        elif pt == "pnorm":
            p = float(self.pnorm)
            y = (x.abs() ** p).sum(dim=axes) ** (1 / p)
        else:
            raise ValueError(self.pooling_type)
        return y, state

    def propagate_mask(self, mask, input_shape):
        return None                       # pooled away


@register_layer
@dataclass
class Upsampling2DLayer(Layer):
    """Nearest-neighbour upsampling (reference Upsampling2D)."""
    size: Sequence[int] = (2, 2)
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        s = _tup(self.size, 2)
        return {}, {}, (input_shape[0] * s[0], input_shape[1] * s[1],
                        input_shape[2])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        s = _tup(self.size, 2)
        return x.repeat_interleave(s[0], dim=1).repeat_interleave(
            s[1], dim=2), state


@register_layer
@dataclass
class ZeroPaddingLayer(Layer):
    """Spatial zero padding (reference ZeroPaddingLayer): ``padding`` is
    (top, bottom, left, right)."""
    padding: Sequence[int] = (1, 1, 1, 1)

    def init(self, gen, input_shape, dtype=torch.float32):
        t, b, l, r = self.padding
        return {}, {}, (input_shape[0] + t + b, input_shape[1] + l + r,
                        input_shape[2])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        t, b, l, r = self.padding
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_layer
@dataclass
class CroppingLayer(Layer):
    """Spatial cropping (reference Cropping2D): ``cropping`` is (top,
    bottom, left, right)."""
    cropping: Sequence[int] = (0, 0, 0, 0)

    def init(self, gen, input_shape, dtype=torch.float32):
        t, b, l, r = self.cropping
        return {}, {}, (input_shape[0] - t - b, input_shape[1] - l - r,
                        input_shape[2])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        t, b, l, r = self.cropping
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :], state


@register_layer
@dataclass
class SpaceToDepthLayer(Layer):
    """Space-to-depth (reference SpaceToDepthLayer): each
    ``block_size``² patch of [B, H, W, C] becomes C · block_size²
    channels, in the JAX layer's order."""
    block_size: int = 2

    def init(self, gen, input_shape, dtype=torch.float32):
        b = self.block_size
        h, w, c = input_shape
        return {}, {}, (h // b, w // b, c * b * b)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b = self.block_size
        n, h, w, c = x.shape
        y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h // b, w // b, c * b * b), state


@register_layer
@dataclass
class DepthToSpaceLayer(Layer):
    """The inverse of ``SpaceToDepthLayer`` (the reference's
    depth_to_space op), in the JAX layer's order."""
    block_size: int = 2

    def init(self, gen, input_shape, dtype=torch.float32):
        b = self.block_size
        h, w, c = input_shape
        return {}, {}, (h * b, w * b, c // (b * b))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b = self.block_size
        n, h, w, c = x.shape
        y = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h * b, w * b, c // (b * b)), state


@register_layer
@dataclass
class Upsampling1DLayer(Layer):
    """Nearest-neighbour upsampling over time (reference Upsampling1D),
    [B, T, C] → [B, T · size, C], the mask stretched with it."""
    size: int = 2
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        t = input_shape[0]
        return {}, {}, (None if t is None else t * self.size,
                        input_shape[1])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.repeat_interleave(self.size, dim=1), state

    def propagate_mask(self, mask, input_shape):
        return (None if mask is None
                else mask.repeat_interleave(self.size, dim=1))


@register_layer
@dataclass
class Upsampling3DLayer(Layer):
    """Nearest-neighbour upsampling (reference Upsampling3D),
    [B, D, H, W, C]."""
    size: Sequence[int] = (2, 2, 2)
    mixes_positions = False

    def init(self, gen, input_shape, dtype=torch.float32):
        s = _tup(self.size, 3)
        return {}, {}, (input_shape[0] * s[0], input_shape[1] * s[1],
                        input_shape[2] * s[2], input_shape[3])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        for ax, r in zip((1, 2, 3), _tup(self.size, 3)):
            x = x.repeat_interleave(r, dim=ax)
        return x, state
