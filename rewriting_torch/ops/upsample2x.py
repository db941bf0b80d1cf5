"""The 2x polyphase FIR upsample kernel (K3): CUDA on the card, plain
PyTorch beside it.

Replaces the JAX package's TPU kernel ``ops/pallas_upfirdn.py::
upsample2x_pallas`` (:150): ``upfirdn2d(x, k, up=2, down=1, pad)`` for
the pads whose output is exactly (2H, 2W).  ``ops/upfirdn2d.py::
upsample2d`` sends it maps of 64 or more channels (a multiple of 8), as
the JAX package does; the source, its design and what bounds it are
described in ``csrc/upsample2x.cu``.

- :func:`upsample2x_cuda` launches the kernel on a CUDA tensor or raises,
  and counts its launches in the module attribute ``launches``.  It has no
  backward: it raises on a tensor that requires a gradient.
- :func:`upsample2x_reference` is the plain version: per output phase, the
  taps that phase reads summed as shifted adds of the undilated input, in
  the kernel's tap order.  The CPU path and the tests use it; on the card
  it is what the kernel is held against.

Both take ``kflip``: the spatially flipped kernel with the gain applied,
a host float32 (k, k) array.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

MAX_TAPS = 8

# launches of the CUDA kernel since the counter was last set to 0
launches = 0


def is_2x(k: int, pad: Tuple[int, int]) -> bool:
    """True if zero-insertion, ``pad`` and a k-tap FIR give exactly twice
    the input's size (2h + p0 + p1 - k + 1 == 2h, whatever h)."""
    return pad[0] + pad[1] == k - 1


def phase_offsets(k: int, pad0: int) -> Dict[int, List[Tuple[int, int]]]:
    """{phase a: [(tap i, input offset d)]}: output row 2y + a takes
    kflip[i] * x[y + d] with d = (a + i - pad0) / 2, for the taps i that
    land on a sample (JAX package ``_phase_taps``, pallas_upfirdn.py:101)."""
    return {a: [(i, (a + i - pad0) // 2) for i in range(k)
                if (a + i - pad0) % 2 == 0] for a in (0, 1)}


def upsample2x_reference(x: torch.Tensor, kflip, pad: Tuple[int, int]
                         ) -> torch.Tensor:
    """Plain PyTorch: each of the four output phases as shifted adds of
    the undilated input."""
    kflip = np.asarray(kflip, np.float32)
    k = kflip.shape[0]
    n, c, h, w = x.shape
    if not is_2x(k, pad):
        raise ValueError(f"upsample2x: pad {pad} with {k} taps does not give "
                         "a 2x output")
    offs = phase_offsets(k, pad[0])
    ds = [d for a in (0, 1) for _, d in offs[a]]
    lo, hi = -min(ds), max(ds)
    xp = F.pad(x, (lo, hi, lo, hi))
    out = x.new_empty((n, c, 2 * h, 2 * w))
    for a in (0, 1):
        for b in (0, 1):
            acc = torch.zeros_like(x)
            for i, dy in offs[a]:
                for j, dx in offs[b]:
                    acc = acc + float(kflip[i, j]) * xp[
                        :, :, lo + dy:lo + dy + h, lo + dx:lo + dx + w]
            out[:, :, a::2, b::2] = acc
    return out


@functools.lru_cache(maxsize=None)
def library():
    """The built and loaded launcher ``upsample2x_f32``."""
    lib = _build.load("upsample2x")
    fn = lib.upsample2x_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def upsample2x_cuda(x: torch.Tensor, kflip, pad: Tuple[int, int]
                    ) -> torch.Tensor:
    """The CUDA kernel on an NCHW float32 CUDA tensor; raises on anything
    the kernel does not take and when the launch fails."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upsample2x_cuda takes a contiguous float32 NCHW "
                         f"tensor, got {x.dtype} shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("upsample2x_cuda has no backward kernel")
    taps = np.ascontiguousarray(kflip, np.float32)
    k = taps.shape[0]
    if taps.shape != (k, k) or not 1 <= k <= MAX_TAPS:
        raise ValueError(f"upsample2x_cuda takes a square kernel of at most "
                         f"{MAX_TAPS} taps, got {taps.shape}")
    n, c, h, w = x.shape
    if not is_2x(k, pad):
        raise ValueError(f"upsample2x_cuda: pad {pad} with {k} taps does not "
                         "give a 2x output")
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    fn = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, pad[0], k,
                taps.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"upsample2x kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return y
