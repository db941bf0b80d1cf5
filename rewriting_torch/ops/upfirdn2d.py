"""upfirdn2d — upsample, pad, FIR filter, downsample — and the FIR blur.

Counterpart of the JAX package's ``ops/upfirdn2d.py``: ``make_kernel``
(:36), ``upfirdn2d`` (:46-175) and ``upfirdn2d_general`` (:94, separate x
and y factors and pads), ``upsample2d`` (:211-239) and ``blur2d``
(:244-251).  The semantics are the reference ``upfirdn2d_native``:

    1. insert (up-1) zeros after every input sample (incl. trailing zeros),
    2. pad by (pad0, pad1) on each spatial edge (a negative pad crops),
    3. correlate with the spatially flipped FIR kernel,
    4. keep every down-th sample.

Layout: NCHW; the FIR kernel is shared by all channels (depthwise).

``upfirdn2d`` is plain PyTorch.  ``upsample2d`` sends maps of 64 or more
channels (a multiple of 8) whose output is exactly 2x to the polyphase
upsample of ``ops/upsample2x.py`` (K3), as the JAX package does
(:221-224), with its taps prepared once (``upsample_taps``); narrower
maps, such as the model's 3-channel RGB skip, stay on ``upfirdn2d``.
``blur2d`` and K3 dispatch on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor the hand-written kernel (``ops/blur2d.py``,
K2, with its backward for a tensor that requires a gradient).
``blur_taps`` prepares a blur's taps once and ``apply_blur`` runs them, the
short path the model's layers take.

``upfirdn2d_matmul`` is the JAX package's separable banded-matmul form
(:128-176): the upfirdn of a rank-1 kernel as ``My @ x @ Mxᵀ`` with the
1-D operator matrices ``_upfirdn1d_matrix`` builds on the host by pushing
an identity through the 1-D upfirdn.  The JAX package sends its narrow
(<= 8 channel) upsamples there; ``upsample2d`` here keeps its dispatch,
and ``chip_smoke.py`` times both forms at the RGB skip.  It computes in
fp32 at every tier, like the blur.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import blur2d as _blur
from . import upsample2x as _up2


def make_kernel(k) -> np.ndarray:
    """Normalized 2-d FIR kernel (float32, host) from a 1-d or 2-d tap list."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """upfirdn of an NCHW tensor with a (kh, kw) FIR kernel; pad = (pad0,
    pad1) on both axes, negative values crop."""
    return upfirdn2d_general(x, kernel, up_x=up, up_y=up, down_x=down,
                             down_y=down, pad_x=pad, pad_y=pad)


def upfirdn2d_general(x: torch.Tensor, kernel, up_x: int = 1, up_y: int = 1,
                      down_x: int = 1, down_y: int = 1,
                      pad_x: Tuple[int, int] = (0, 0),
                      pad_y: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """upfirdn of an NCHW tensor with a (kh, kw) FIR kernel and separate
    factors and pads along the width (x) and the height (y)."""
    n, c, h, w = x.shape
    kflip = np.ascontiguousarray(np.flip(np.asarray(kernel, np.float32),
                                         (0, 1)))
    kh, kw = kflip.shape
    if up_x > 1 or up_y > 1:
        xd = x.new_zeros((n, c, h * up_y, w * up_x))
        xd[:, :, ::up_y, ::up_x] = x
        x = xd
    x = F.pad(x, (pad_x[0], pad_x[1], pad_y[0], pad_y[1]))
    wdw = torch.from_numpy(kflip).to(x.device, x.dtype).expand(c, 1, kh, kw)
    return F.conv2d(x, wdw, stride=(down_y, down_x), groups=c)


@functools.lru_cache(maxsize=256)
def _upfirdn1d_matrix(n: int, taps: tuple, up: int, down: int,
                      pad0: int, pad1: int) -> np.ndarray:
    """(out_n, n) matrix of the 1-D upfirdn of `n` samples (float32,
    host): zero-insert, pad (a negative pad crops), correlate with the
    flipped taps, keep every `down`-th sample."""
    k = np.asarray(taps, np.float32)
    eye = np.eye(n, dtype=np.float32)
    upd = np.zeros((n, n * up), np.float32)
    upd[:, ::up] = eye
    if pad0 >= 0 and pad1 >= 0:
        padded = np.pad(upd, ((0, 0), (pad0, pad1)))
    else:
        padded = upd[:, max(-pad0, 0): upd.shape[1] - max(-pad1, 0)]
        padded = np.pad(padded, ((0, 0), (max(pad0, 0), max(pad1, 0))))
    kf = k[::-1]
    out_n = (padded.shape[1] - len(k)) // down + 1
    op = np.zeros((n, out_n), np.float32)
    for o in range(out_n):
        op[:, o] = padded[:, o * down: o * down + len(k)] @ kf
    return op.T


def upfirdn2d_matmul(x: torch.Tensor, kernel_taps_y, kernel_taps_x,
                     up: int = 1, down: int = 1, pad=(0, 0),
                     gain: float = 1.0) -> torch.Tensor:
    """Separable upfirdn of an NCHW map by two matmuls; the kernel is the
    outer product of the 1-D taps times `gain`."""
    _, _, h, w = x.shape

    def matrix(n, taps):
        return torch.from_numpy(_upfirdn1d_matrix(
            n, tuple(float(t) for t in taps), up, down, pad[0], pad[1])
        ).to(x.device)

    out = torch.einsum("oh,nchw->ncow", matrix(h, kernel_taps_y), x)
    out = torch.einsum("pw,ncow->ncop", matrix(w, kernel_taps_x), out)
    return out * gain


def separable_taps(kernel_1d) -> tuple:
    """Normalized 1-D taps whose outer product is ``make_kernel(
    kernel_1d)``."""
    k = np.asarray(kernel_1d, np.float64)
    k = k / k.sum()
    return tuple(float(v) for v in k)


def upsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """FIR upsample (reference Upsample): gain factor**2, pad
    ((p+1)//2 + factor - 1, p//2) with p = kh - factor (for factor 2 the
    output is always exactly 2x)."""
    kernel = np.asarray(kernel, np.float32)
    kh = kernel.shape[0]
    p = kh - factor
    pad = ((p + 1) // 2 + factor - 1, p // 2)
    c = x.shape[1]
    if (factor == 2 and c >= 64 and c % 8 == 0 and kernel.shape == (kh, kh)
            and kh <= _up2.MAX_TAPS):
        taps = upsample_taps(kernel, pad)
        if x.device.type == "cuda":
            return _up2.upsample2x_cuda(x, taps, pad)
        if x.device.type == "cpu":
            return _up2.upsample2x_reference(x, taps, pad)
        raise RuntimeError(f"upsample2d has no path for device {x.device}")
    return upfirdn2d(x, kernel * (factor ** 2), up=factor, down=1, pad=pad)


def upsample_taps(kernel, pad: Tuple[int, int]) -> _up2.Up2Taps:
    """The prepared taps of K3 for the 2x upsample (``kernel * 4``,
    flipped) with ``pad``: made once per kernel and pad."""
    k = np.ascontiguousarray(kernel, np.float32)
    return _up2_scaled_taps(k.tobytes(), k.shape, (int(pad[0]), int(pad[1])))


@functools.lru_cache(maxsize=None)
def _up2_scaled_taps(data: bytes, shape, pad) -> _up2.Up2Taps:
    kernel = np.frombuffer(data, np.float32).reshape(shape) * 4.0
    return _up2.up2_taps(np.flip(kernel, (0, 1)), pad)


def blur_taps(kernel, pad: Tuple[int, int], upsample_factor: int = 1
              ) -> _blur.BlurTaps:
    """The prepared taps of the FIR blur (reference Blur): ``kernel *
    factor**2``, flipped, for ``pad``; made once per kernel, pad and
    factor, so that a layer can hold its own (``models/stylegan2.py``)."""
    k = np.ascontiguousarray(kernel, np.float32)
    return _scaled_taps(k.tobytes(), k.shape, (int(pad[0]), int(pad[1])),
                        int(upsample_factor))


@functools.lru_cache(maxsize=None)
def _scaled_taps(data: bytes, shape, pad, upsample_factor: int):
    kernel = np.frombuffer(data, np.float32).reshape(shape)
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    return _blur.blur_taps(np.flip(kernel, (0, 1)), pad)


def apply_blur(x: torch.Tensor, taps: _blur.BlurTaps) -> torch.Tensor:
    """The blur with taps from :func:`blur_taps`.  A CUDA tensor goes to
    the hand-written kernel, which launches or raises (through its
    autograd Function when the tensor requires a gradient); a CPU tensor
    goes to the plain version."""
    if x.device.type == "cuda":
        if x.requires_grad and torch.is_grad_enabled():
            return _blur.Blur2dFunction.apply(x, taps, taps.pad)
        return _blur.blur2d_cuda(x, taps, taps.pad)
    if x.device.type == "cpu":
        return _blur.blur2d_reference(x, taps, taps.pad)
    raise RuntimeError(f"blur2d has no path for device {x.device}")


def blur2d(x: torch.Tensor, kernel, pad: Tuple[int, int],
           upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (reference Blur): ``upfirdn2d(x, kernel * factor**2,
    pad)``, through :func:`apply_blur`."""
    return apply_blur(x, blur_taps(kernel, pad, upsample_factor))
