"""upfirdn2d — upsample, pad, FIR filter, downsample — and the FIR blur.

Counterpart of the JAX package's ``ops/upfirdn2d.py``: ``make_kernel``
(:36), ``upfirdn2d`` (:46-175), ``upsample2d`` (:211-239) and ``blur2d``
(:244-251).  The semantics are the reference ``upfirdn2d_native``:

    1. insert (up-1) zeros after every input sample (incl. trailing zeros),
    2. pad by (pad0, pad1) on each spatial edge (a negative pad crops),
    3. correlate with the spatially flipped FIR kernel,
    4. keep every down-th sample.

Layout: NCHW; the FIR kernel is shared by all channels (depthwise).

``upfirdn2d`` is plain PyTorch.  ``upsample2d`` sends maps of 64 or more
channels (a multiple of 8) whose output is exactly 2x to the polyphase
upsample of ``ops/upsample2x.py`` (K3), as the JAX package does
(:221-224); narrower maps, such as the model's 3-channel RGB skip, stay on
``upfirdn2d``.  ``blur2d`` and K3 dispatch on the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor the hand-written kernel
(``ops/blur2d.py``, K2, with its backward for a tensor that requires a
gradient).
"""

from __future__ import annotations

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
    kernel = np.asarray(kernel, np.float32) * (factor ** 2)
    kh = kernel.shape[0]
    p = kh - factor
    pad = ((p + 1) // 2 + factor - 1, p // 2)
    c = x.shape[1]
    if (factor == 2 and c >= 64 and c % 8 == 0 and kernel.shape == (kh, kh)
            and kh <= _up2.MAX_TAPS and _up2.is_2x(kh, pad)):
        kflip = np.ascontiguousarray(np.flip(kernel, (0, 1)))
        if x.device.type == "cuda":
            return _up2.upsample2x_cuda(x, kflip, pad)
        if x.device.type == "cpu":
            return _up2.upsample2x_reference(x, kflip, pad)
        raise RuntimeError(f"upsample2d has no path for device {x.device}")
    return upfirdn2d(x, kernel, up=factor, down=1, pad=pad)


def blur2d(x: torch.Tensor, kernel, pad: Tuple[int, int],
           upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (reference Blur): ``upfirdn2d(x, kernel * factor**2, pad)``.

    A CUDA tensor goes to the hand-written kernel, which launches or
    raises (through its autograd Function when the tensor requires a
    gradient); a CPU tensor goes to the plain version."""
    kernel = np.asarray(kernel, np.float32)
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    kflip = np.ascontiguousarray(np.flip(kernel, (0, 1)))
    if x.device.type == "cuda":
        if x.requires_grad and torch.is_grad_enabled():
            return _blur.Blur2dFunction.apply(x, kflip, pad)
        return _blur.blur2d_cuda(x, kflip, pad)
    if x.device.type == "cpu":
        return _blur.blur2d_reference(x, kflip, pad)
    raise RuntimeError(f"blur2d has no path for device {x.device}")
