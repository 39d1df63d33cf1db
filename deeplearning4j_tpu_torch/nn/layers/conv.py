"""Convolution and pooling layers (port of the 2-D ``ConvolutionLayer``
and ``SubsamplingLayer`` of ``deeplearning4j_tpu/nn/layers/conv.py``).

The API is the JAX package's: activations are channels-last [B, H, W, C]
and kernels are stored [kh, kw, in/groups, out] (HWIO) under the same
names (``W``, ``b``), so a JAX network's weights load as a plain copy.
The JAX layers leave the convolution and the pooling to XLA
(``lax.conv_general_dilated``, ``lax.reduce_window``), not to a Pallas
kernel; the port leaves them to PyTorch's convolution (cuDNN on the
card) and pooling ops. Inside ``apply`` an NHWC tensor is viewed as
NCHW in the channels-last memory format (a permute, no copy,
:func:`_torch_perms`), and the result is viewed back, so the flatten of
a following dense layer reads H, W, C in the JAX package's order.

Padding is XLA's: ``VALID``, or ``SAME`` with ``ceil(size / stride)``
outputs and ``total // 2`` of the padding before, the rest after — which
is asymmetric where the padding is odd, so the port pads explicitly
(:func:`_same_pads`) instead of using PyTorch's own padding. SAME max
pooling pads with −inf; SAME average pooling divides each window by the
count of its unpadded elements (not PyTorch's ``count_include_pad``
rule); sum and pnorm pooling pad with zeros.

The 1-D and 3-D variants, the depthwise, separable and transposed
convolutions, global pooling, upsampling, padding, cropping and
batch normalisation come with ROADMAP A10.
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


@register_layer
@dataclass
class ConvolutionLayer(Layer):
    """2-D convolution (reference ConvolutionLayer): [B, H, W, C_in] →
    [B, H', W', n_out], kernel ``W`` [kh, kw, C_in / groups, n_out]."""
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
        if self._spatial != 2:
            raise NotImplementedError(
                f"{type(self).__name__}: {self._spatial}-D convolution "
                "comes with ROADMAP A10")
        _check_padding(self.padding)
        return (_tup(self.kernel_size, 2), _tup(self.stride, 2),
                _tup(self.dilation, 2))

    def _kshape(self, c_in):
        return _tup(self.kernel_size, self._spatial) + (
            c_in // self.groups, self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32):
        k, s, d = self._geometry()
        c_in = self.n_in or input_shape[-1]
        params = {"W": winit.get(self.weight_init or "xavier")(
            gen, self._kshape(c_in), dtype)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype)
        out_sp = tuple(_out_spatial(input_shape[i], k[i], s[i], d[i],
                                    self.padding) for i in range(2))
        return params, {}, out_sp + (self.n_out,)

    def _conv(self, x, w):
        k, s, d = self._geometry()
        to_first, kernel, back = _torch_perms(2)
        pads = _same_pads(x.shape[1:3], k, s, d, self.padding)
        xc = x.permute(to_first)
        if any(pads):
            xc = F.pad(xc, pads)
        y = F.conv2d(xc, w.permute(kernel), stride=s, dilation=d,
                     groups=self.groups)
        return y.permute(back)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        z = self._conv(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        y = self._act()(z)
        return self._maybe_dropout(y, train, rng), state


@register_layer
@dataclass
class SubsamplingLayer(Layer):
    """2-D pooling (reference SubsamplingLayer, PoolingType MAX, AVG,
    PNORM and SUM) over [B, H, W, C]."""
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: str = "VALID"
    pooling_type: str = "max"
    pnorm: int = 2
    _spatial: int = field(default=2, repr=False)

    def _geometry(self):
        if self._spatial != 2:
            raise NotImplementedError(
                f"{type(self).__name__}: {self._spatial}-D pooling comes "
                "with ROADMAP A10")
        _check_padding(self.padding)
        return _tup(self.kernel_size, 2), _tup(self.stride, 2)

    def init(self, gen, input_shape, dtype=torch.float32):
        k, s = self._geometry()
        out_sp = tuple(_out_spatial(input_shape[i], k[i], s[i], 1,
                                    self.padding) for i in range(2))
        return {}, {}, out_sp + (input_shape[-1],)

    def _window_sum(self, xc, k, s, pads):
        """The sum over each window of ``xc`` [B, C, H, W] padded with
        zeros by ``pads``."""
        if any(pads):
            xc = F.pad(xc, pads)
        return F.avg_pool2d(xc, k, s, divisor_override=1)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k, s = self._geometry()
        to_first, _, back = _torch_perms(2)
        pads = _same_pads(x.shape[1:3], k, s, (1, 1), self.padding)
        xc = x.permute(to_first)
        pt = self.pooling_type.lower()
        if pt == "max":
            if any(pads):
                xc = F.pad(xc, pads, value=-math.inf)
            y = F.max_pool2d(xc, k, s)
        elif pt in ("avg", "mean"):
            total = self._window_sum(xc, k, s, pads)
            ones = torch.ones((1, 1) + tuple(x.shape[1:3]),
                              dtype=x.dtype, device=x.device)
            y = total / self._window_sum(ones, k, s, pads)
        elif pt == "pnorm":
            p = float(self.pnorm)
            y = self._window_sum(xc.abs() ** p, k, s, pads) ** (1.0 / p)
        elif pt == "sum":
            y = self._window_sum(xc, k, s, pads)
        else:
            raise ValueError(f"unknown pooling type {self.pooling_type!r}")
        return y.permute(back), state
