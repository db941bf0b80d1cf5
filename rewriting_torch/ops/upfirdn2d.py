"""upfirdn2d — upsample, pad, FIR filter, downsample — and the FIR blur.

Counterpart of the JAX package's ``ops/upfirdn2d.py``: ``make_kernel``
(:36), ``upfirdn2d`` (:46-175), ``upsample2d`` (:211-239) and ``blur2d``
(:244-251).  The semantics are the reference ``upfirdn2d_native``:

    1. insert (up-1) zeros after every input sample (incl. trailing zeros),
    2. pad by (pad0, pad1) on each spatial edge (a negative pad crops),
    3. correlate with the spatially flipped FIR kernel,
    4. keep every down-th sample.

Layout: NCHW; the FIR kernel is shared by all channels (depthwise).

``upfirdn2d`` and ``upsample2d`` are plain PyTorch: the model upsamples
only the 3-channel RGB skip, which no TPU kernel served either.
``blur2d`` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel of ``ops/blur2d.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import blur2d as _blur


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
    n, c, h, w = x.shape
    kflip = np.ascontiguousarray(np.flip(np.asarray(kernel, np.float32),
                                         (0, 1)))
    kh, kw = kflip.shape
    if up > 1:
        xd = x.new_zeros((n, c, h * up, w * up))
        xd[:, :, ::up, ::up] = x
        x = xd
    p0, p1 = pad
    x = F.pad(x, (p0, p1, p0, p1))
    wdw = torch.from_numpy(kflip).to(x.device, x.dtype).expand(c, 1, kh, kw)
    return F.conv2d(x, wdw, stride=down, groups=c)


def upsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """FIR upsample (reference Upsample): gain factor**2, pad
    ((p+1)//2 + factor - 1, p//2) with p = kh - factor."""
    kernel = np.asarray(kernel, np.float32)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * (factor ** 2), up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def blur2d(x: torch.Tensor, kernel, pad: Tuple[int, int],
           upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (reference Blur): ``upfirdn2d(x, kernel * factor**2, pad)``.

    A CUDA tensor goes to the hand-written kernel, which launches or
    raises; a CPU tensor goes to the plain version."""
    kernel = np.asarray(kernel, np.float32)
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    kflip = np.ascontiguousarray(np.flip(kernel, (0, 1)))
    if x.device.type == "cuda":
        return _blur.blur2d_cuda(x, kflip, pad)
    if x.device.type == "cpu":
        return _blur.blur2d_reference(x, kflip, pad)
    raise RuntimeError(f"blur2d has no path for device {x.device}")
