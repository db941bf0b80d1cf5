"""The FIR blur kernel (K2): CUDA on the card, plain PyTorch beside it.

Replaces the JAX package's TPU kernels ``ops/pallas_upfirdn.py::
blur2d_pallas`` (:85) and ``::blur2d_pallas_bs`` (:230).  Both compute the
depthwise correlation of a padded NCHW map with a flipped k x k FIR, i.e.
``upfirdn2d(x, k, up=1, down=1, pad)``; the source, its design and what
bounds it are described in ``csrc/blur2d.cu``.

- :func:`blur2d_cuda` launches the kernel on a CUDA tensor or raises.  It
  counts its launches in the module attribute ``launches``.
- :class:`Blur2dFunction` gives the kernel a gradient.  The adjoint of a
  correlation with taps ``kflip`` and pads ``(p0, p1)`` is the correlation
  of the output gradient with the 180-degree-rotated taps and pads
  ``(k-1-p0, k-1-p1)``, whose output has the input's shape; the backward
  (:func:`blur2d_backward_cuda`) launches the same kernel with those taps
  and pads and counts in ``backward_launches``.
- :func:`blur2d_reference` is the plain version: the same taps in the same
  order as shifted adds, and :func:`blur2d_backward_reference` the adjoint
  through it.  The CPU path and the tests use them; on the card they are
  what the kernel is held against.

All take ``kflip``: the spatially flipped kernel with any gain applied, a
host float32 (k, k) array.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import _build

MAX_TAPS = 8

# launches of the CUDA kernel since the counters were last set to 0: the
# forward blur, and the adjoint the backward runs
launches = 0
backward_launches = 0


def output_shape(x_shape, k: int, pad: Tuple[int, int]):
    n, c, h, w = x_shape
    return (n, c, h + pad[0] + pad[1] - k + 1, w + pad[0] + pad[1] - k + 1)


def adjoint(kflip, pad: Tuple[int, int]):
    """(taps, pad) of the blur's adjoint: the taps rotated by 180 degrees
    and the pads (k-1-p0, k-1-p1)."""
    kflip = np.asarray(kflip, np.float32)
    k = kflip.shape[0]
    return (np.ascontiguousarray(np.flip(kflip, (0, 1))),
            (k - 1 - pad[0], k - 1 - pad[1]))


def blur2d_reference(x: torch.Tensor, kflip, pad: Tuple[int, int]
                     ) -> torch.Tensor:
    """Plain PyTorch: pad (negative crops), then sum kflip[i, j] times the
    (i, j)-shifted window, in row-major tap order."""
    kflip = np.asarray(kflip, np.float32)
    kh, kw = kflip.shape
    p0, p1 = pad
    xp = torch.nn.functional.pad(x, (p0, p1, p0, p1))
    ho = xp.shape[2] - kh + 1
    wo = xp.shape[3] - kw + 1
    out = torch.zeros(x.shape[:2] + (ho, wo), dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            out = out + float(kflip[i, j]) * xp[:, :, i:i + ho, j:j + wo]
    return out


def blur2d_backward_reference(grad: torch.Tensor, kflip,
                              pad: Tuple[int, int]) -> torch.Tensor:
    """The gradient of :func:`blur2d_reference` with respect to its input,
    by the adjoint formula the CUDA backward uses."""
    taps, apad = adjoint(kflip, pad)
    return blur2d_reference(grad, taps, apad)


@functools.lru_cache(maxsize=None)
def library():
    """The built and loaded launcher ``blur2d_f32``."""
    lib = _build.load("blur2d")
    fn = lib.blur2d_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, kflip, pad: Tuple[int, int]) -> torch.Tensor:
    """One launch of the kernel on an NCHW float32 CUDA tensor; raises on
    anything the kernel does not take and when the launch fails."""
    if x.device.type != "cuda":
        raise ValueError(f"blur2d_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"blur2d_cuda takes float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("blur2d_cuda takes a contiguous NCHW tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    taps = np.ascontiguousarray(kflip, np.float32)
    k = taps.shape[0]
    if taps.shape != (k, k) or not 1 <= k <= MAX_TAPS:
        raise ValueError(f"blur2d_cuda takes a square kernel of at most "
                         f"{MAX_TAPS} taps, got {taps.shape}")
    shape = output_shape(x.shape, k, pad)
    if min(shape) < 1:
        raise ValueError(f"blur2d_cuda: empty output {shape} for input "
                         f"{tuple(x.shape)}, kernel {k}, pad {pad}")
    n, c, h, w = x.shape
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, shape[2], shape[3],
                pad[0], k, taps.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"blur2d kernel launch failed: CUDA error {rc}")
    return y


def blur2d_cuda(x: torch.Tensor, kflip, pad: Tuple[int, int]
                ) -> torch.Tensor:
    """The CUDA kernel on an NCHW float32 CUDA tensor (no gradient: use
    :class:`Blur2dFunction` for a tensor that requires one)."""
    global launches
    y = _launch(x, kflip, pad)
    launches += 1
    return y


def blur2d_backward_cuda(grad: torch.Tensor, kflip, pad: Tuple[int, int]
                         ) -> torch.Tensor:
    """The input gradient of the blur from its output gradient: the same
    kernel with the adjoint's taps and pads."""
    global backward_launches
    taps, apad = adjoint(kflip, pad)
    dx = _launch(grad.contiguous(), taps, apad)
    backward_launches += 1
    return dx


class Blur2dFunction(torch.autograd.Function):
    """``blur2d_cuda`` with the adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, x, kflip, pad):
        ctx.kflip, ctx.pad = kflip, pad
        return blur2d_cuda(x, kflip, pad)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return blur2d_backward_cuda(grad, ctx.kflip, ctx.pad), None, None
