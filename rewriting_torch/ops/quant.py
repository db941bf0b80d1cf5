"""Symmetric int8 quantization for the int8 serving tier.

Counterpart of the JAX package's ``ops/quant.py``: the W8A8 recipe, with
static per-output-channel weight scales, a dynamic per-tensor activation
scale, int32 accumulation and a float dequantize.  The rounding is the
JAX package's: round half to even, clip to +-127, scales floored at
``_EPS``, the dequantize in fp32.

The JAX package computes the integer convolution with
``lax.conv_general_dilated`` on int8 operands, outside any Pallas kernel.
Here it is an im2col of the int8 map (zero-dilated for the up-conv) and
one library integer GEMM, ``torch._int_mm``, on the card and on the CPU
alike; its operands are zero-padded to that op's shape rules (more than
16 rows, a multiple of 8 columns), which adds nothing to the sums.
:func:`int_conv_reference` is the plain version: a float64 convolution of
the same integers, exact while every sum stays below 2**53.  Nothing here
falls back to a float convolution.

Under the JAX package's sharded samplers the compiler keeps one device's
semantics, so a per-tensor or per-channel max spans the whole tensor
however it is split.  The port's sharded paths hold a share of it on each
rank, and say so with :func:`whole_tensor_scales`: within it the
activation scale is the max over every rank's share (an all-reduce the
caller supplies, ``parallel/comm.max_over``); an empty share adds 0, and
the ``_EPS`` floor applies to the whole max.  A weight split over its
input channels (tp's row layers) takes its per-output-channel scale the
same way, through ``reduce_max`` of :func:`quantize_weight_per_channel`.
Outside the scope nothing changes.

Layout: NCHW maps, OIHW weights.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# -128 is left out so that negation stays in range
_QMAX = 127.0
# the least scale: an all-zero tensor quantizes to zeros, not inf or nan
_EPS = 1e-12

Reduce = Callable[[torch.Tensor], torch.Tensor]
# the max over the ranks holding the other shares of an activation, set by
# whole_tensor_scales
_REDUCE_MAX: contextvars.ContextVar = contextvars.ContextVar(
    "quant_reduce_max", default=None)


@contextlib.contextmanager
def whole_tensor_scales(reduce_max: Reduce):
    """Within, every map :func:`quantize_activation` sees is this rank's
    share of a map split across ranks, and ``reduce_max(t)`` returns the
    elementwise max of `t` over the ranks holding the shares (an
    all-reduce every one of them makes at the same point): the scale is
    the whole map's, as one device computes it."""
    token = _REDUCE_MAX.set(reduce_max)
    try:
        yield
    finally:
        _REDUCE_MAX.reset(token)


def quantize_weight_per_channel(w: torch.Tensor, axis: int = 0,
                                reduce_max: Optional[Reduce] = None):
    """``(w_i8, scale)``: `w` in int8 with one fp32 scale for each slice of
    `axis`; ``scale`` keeps the other axes as size 1, so ``w_i8 * scale``
    broadcasts back to the dequantized weight.  With ``reduce_max`` `w` is
    one rank's share of a weight split along another axis, and each slice's
    max is taken over every share."""
    w = w.float()
    axis = axis % w.dim()
    dims = tuple(i for i in range(w.dim()) if i != axis)
    peak = torch.amax(torch.abs(w), dim=dims, keepdim=True)
    if reduce_max is not None:
        peak = reduce_max(peak.contiguous())
    scale = torch.clamp_min(peak, _EPS) / _QMAX
    w_i8 = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX).to(torch.int8)
    return w_i8, scale


def quantize_activation(x: torch.Tensor):
    """``(x_i8, scale)``: dynamic symmetric per-tensor quantization, the
    scale an fp32 scalar tensor; within :func:`whole_tensor_scales` the
    whole split map's."""
    # an empty share adds 0 to the max
    peak = (torch.amax(torch.abs(x)).float() if x.numel()
            else x.new_zeros((), dtype=torch.float32))
    reduce_max = _REDUCE_MAX.get()
    if reduce_max is not None:
        peak = reduce_max(peak.reshape(1))[0]
    scale = torch.clamp_min(peak, _EPS) / _QMAX
    x_i8 = torch.clamp(torch.round(x.float() / scale), -_QMAX,
                       _QMAX).to(torch.int8)
    return x_i8, scale


def dequantize(w_i8: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """The inverse of :func:`quantize_weight_per_channel` (up to its
    rounding)."""
    return w_i8.to(dtype) * scale.to(dtype)


def _pad_and_dilate(x: torch.Tensor, padding, lhs_dilation) -> torch.Tensor:
    """`x` zero-dilated by ``lhs_dilation`` (zeros between samples) and
    padded by ``padding = ((top, bottom), (left, right))``."""
    if lhs_dilation is not None and tuple(lhs_dilation) != (1, 1):
        dy, dx = lhs_dilation
        b, c, h, w = x.shape
        xd = x.new_zeros((b, c, (h - 1) * dy + 1, (w - 1) * dx + 1))
        xd[:, :, ::dy, ::dx] = x
        x = xd
    (pt, pb), (pl, pr) = padding
    return F.pad(x, (pl, pr, pt, pb))


def _im2col(xp: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B·Ho·Wo, C·kh·kw) rows of the padded map's kh x kw windows, in the
    order of an OIHW weight's (I, kh, kw)."""
    b, c, hp, wp = xp.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    cols = torch.stack([xp[:, :, dy:dy + ho, dx:dx + wo]
                        for dy in range(kh) for dx in range(kw)], dim=-1)
    return cols.permute(0, 2, 3, 1, 4).reshape(b * ho * wo, c * kh * kw)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_conv(x_i8: torch.Tensor, w_i8: torch.Tensor,
             padding=((1, 1), (1, 1)), lhs_dilation=None) -> torch.Tensor:
    """The int32 stride-1 convolution of an int8 NCHW map by an int8 OIHW
    weight: an im2col and ``torch._int_mm``."""
    xp = _pad_and_dilate(x_i8, padding, lhs_dilation)
    o, i, kh, kw = w_i8.shape
    b, _, hp, wp = xp.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    cols = _im2col(xp, kh, kw)
    m, k = cols.shape
    mp = 32 if m <= 16 else m
    kp, n_p = _round_up(k, 8), _round_up(o, 8)
    if (mp, kp) != (m, k):
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    wm = F.pad(w_i8.reshape(o, k), (0, kp - k, 0, n_p - o))   # (N, K)
    acc = torch._int_mm(cols.contiguous(), wm.contiguous().t())
    return acc[:m, :o].reshape(b, ho, wo, o).permute(0, 3, 1, 2).contiguous()


def int_conv_reference(x_i8: torch.Tensor, w_i8: torch.Tensor,
                       padding=((1, 1), (1, 1)),
                       lhs_dilation=None) -> torch.Tensor:
    """The plain version of :func:`int_conv`: the same integers convolved
    in float64 (exact below 2**53), returned as int32."""
    xp = _pad_and_dilate(x_i8.double(), padding, lhs_dilation)
    return F.conv2d(xp, w_i8.double()).to(torch.int32)


def conv2d_w8a8(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                *, window_strides: Sequence[int] = (1, 1),
                padding: Tuple = ((1, 1), (1, 1)),
                lhs_dilation: Optional[Sequence[int]] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """A convolution with an int8 core and a float epilogue.  `x` is a
    float NCHW map, quantized here (dynamic range); ``w_i8``/``w_scale``
    come from :func:`quantize_weight_per_channel` of an OIHW weight
    (axis 0).  The int32 sums are dequantized by ``x_scale * w_scale[o]``
    in fp32."""
    if tuple(window_strides) != (1, 1):
        raise ValueError("conv2d_w8a8 takes stride 1, got "
                         f"{tuple(window_strides)}")
    x_i8, x_scale = quantize_activation(x)
    acc = int_conv(x_i8, w_i8, padding, lhs_dilation)
    rescale = x_scale * w_scale.reshape(-1).float()
    return (acc.float() * rescale[None, :, None, None]).to(out_dtype)
