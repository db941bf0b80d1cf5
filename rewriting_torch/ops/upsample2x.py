"""The 2x polyphase FIR upsample kernel (K3): CUDA on the card, plain
PyTorch beside it.

Replaces the JAX package's TPU kernel ``ops/pallas_upfirdn.py::
upsample2x_pallas`` (:150): ``upfirdn2d(x, k, up=2, down=1, pad)`` for
the pads whose output is exactly (2H, 2W).  ``ops/upfirdn2d.py::
upsample2d`` sends it maps of 64 or more channels (a multiple of 8), as
the JAX package does; the source, its design and what bounds it are
described in ``csrc/upsample2x.cu``.

- :func:`up2_taps` prepares the taps of one upsample and pad once: the
  flipped taps, their factors when they are an outer product, and the
  factors split into the two phases of each axis (:func:`sep_phases`).
  It caches on the taps' bytes and the pad, and keeps a record of each
  input shape's launch, so a launch does only what depends on the tensor.
- :func:`upsample2x_cuda` launches a kernel on a CUDA tensor or raises:
  the separable polyphase row-band kernel (``upsample2x_sep_f32``) for
  rank-1 taps, which every ``make_kernel`` of a 1-D list is, else the
  general kernel (``upsample2x_f32``).  It counts its launches in the
  module attribute ``launches``, and those of the general kernel also in
  ``general_launches``.  It has no backward: it raises on a tensor that
  requires a gradient.
- :func:`upsample2x_reference` is the plain version: per output phase, the
  taps that phase reads summed as shifted adds of the undilated input, in
  the general kernel's tap order.  The CPU path and the tests use it; on
  the card it is what both kernels are held against.

All take ``kflip``: the spatially flipped kernel with the gain applied,
a host float32 (k, k) array, or the :class:`Up2Taps` that :func:`up2_taps`
made of it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _native_build as _build
from . import blur2d as _blur

MAX_TAPS = 8
# the most input rows (and columns) an output pair reads: k // 2 + 1
SEP_MAX_SPAN = MAX_TAPS // 2 + 1
# the separable kernel's bands: halved down to this many input rows
SEP_BAND_ROWS = 4

# launches since the counters were last set to 0: of either kernel, and of
# the general kernel alone
launches = 0
general_launches = 0


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


class SepPhases(NamedTuple):
    """The separable kernel's taps: output (2i + a, 2j + b) is the sum
    over n, m < ``span`` of ``col[a, n] * row[b, m] * x[i + d0 + n,
    j + d0 + m]``; ``col`` and ``row`` are (2, SEP_MAX_SPAN) float32, zero
    where a phase has no tap."""
    d0: int
    span: int
    col: np.ndarray
    row: np.ndarray


def sep_phases(col, row, k: int, pad0: int) -> SepPhases:
    """Split the factors (col, row) of rank-1 k x k taps into the phases
    of each axis: tap i of phase a reads input offset d, and goes to
    position d - d0, where d0 is the least offset of either phase."""
    offs = phase_offsets(k, pad0)
    ds = [d for a in (0, 1) for _, d in offs[a]]
    d0 = min(ds)
    cph = np.zeros((2, SEP_MAX_SPAN), np.float32)
    rph = np.zeros((2, SEP_MAX_SPAN), np.float32)
    for a in (0, 1):
        for i, d in offs[a]:
            cph[a, d - d0] = col[i]
            rph[a, d - d0] = row[i]
    return SepPhases(d0, max(ds) - d0 + 1, cph, rph)


class Up2Taps:
    """The flipped taps of one 2x upsample with one pad, prepared for
    launches: ``kflip`` (read-only float32), ``k``, ``pad``, the
    ``factors`` (col, row) when the taps are rank 1 (else None) and their
    ``phases`` (:class:`SepPhases`, else None).  ``np.asarray`` of it
    gives ``kflip``."""

    def __init__(self, kflip, pad: Tuple[int, int]):
        kflip = np.array(kflip, np.float32)
        k = kflip.shape[0] if kflip.ndim == 2 else 0
        if kflip.shape != (k, k) or not 1 <= k <= MAX_TAPS:
            raise ValueError(f"upsample2x takes a square kernel of at most "
                             f"{MAX_TAPS} taps, got {kflip.shape}")
        pad = (int(pad[0]), int(pad[1]))
        if not is_2x(k, pad):
            raise ValueError(f"upsample2x: pad {pad} with {k} taps does not "
                             "give a 2x output")
        kflip.setflags(write=False)
        self.kflip, self.k, self.pad = kflip, k, pad
        self.factors = _blur.separable_factors(kflip)
        self.phases = (None if self.factors is None
                       else sep_phases(*self.factors, k, pad[0]))
        # the host address the general launcher reads (kflip lives on self)
        self.taps_ptr = kflip.ctypes.data
        # input shape -> what a launch needs, made by _record
        self.records = {}

    def __array__(self, dtype=None, copy=None):
        return self.kflip if dtype is None else self.kflip.astype(dtype)


@functools.lru_cache(maxsize=None)
def _cached_taps(data: bytes, shape, pad) -> Up2Taps:
    return Up2Taps(np.frombuffer(data, np.float32).reshape(shape), pad)


def up2_taps(kflip, pad: Tuple[int, int]) -> Up2Taps:
    """The prepared taps for (kflip, pad), one object per distinct taps
    and pad; an Up2Taps of the same pad is handed back as it is."""
    pad = (int(pad[0]), int(pad[1]))
    if isinstance(kflip, Up2Taps) and kflip.pad == pad:
        return kflip
    a = np.ascontiguousarray(kflip, np.float32)
    return _cached_taps(a.tobytes(), a.shape, pad)


class SepArgs(ctypes.Structure):
    """The separable launcher's arguments: ``struct SepArgs`` of
    ``csrc/upsample2x.cu``, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "planes", "h", "w", "d0", "span", "lanes", "chunks", "rows")] + [
        ("col", (ctypes.c_float * SEP_MAX_SPAN) * 2),
        ("row", (ctypes.c_float * SEP_MAX_SPAN) * 2)]


def sep_plan(planes: int, h: int, w: int):
    """The separable kernel's cut of ``planes`` input planes (h, w): K2's
    lanes and chunks (``blur2d._sep_plan``) on the input's columns, and
    bands halved from the whole plane down to SEP_BAND_ROWS input rows at
    any size, shorter than K2's warp target would make them: on an H100,
    bands of 8 and 16 rows ran slower (``scripts/compare_upsample.py
    --variants``; numbers in PERF.md)."""
    return _blur._sep_plan(planes, h, w, min_rows=SEP_BAND_ROWS,
                           target_warps=None)


def sep_args(taps: Up2Taps, planes: int, h: int, w: int, plan) -> SepArgs:
    """The separable launcher's arguments for rank-1 `taps` on `planes`
    (h, w) planes cut by `plan` (:func:`sep_plan`)."""
    ph = taps.phases
    a = SepArgs(planes, h, w, ph.d0, ph.span, plan.lanes, plan.chunks,
                plan.rows)
    for p in (0, 1):
        a.col[p][:] = ph.col[p].tolist()
        a.row[p][:] = ph.row[p].tolist()
    return a


@functools.lru_cache(maxsize=None)
def library():
    """The built and loaded library, with the launchers ``upsample2x_f32``
    (general) and ``upsample2x_sep_f32`` (separable) typed."""
    lib = _build.load("upsample2x")
    lib.upsample2x_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.upsample2x_f32.restype = ctypes.c_int
    lib.upsample2x_sep_f32.argtypes = [ctypes.c_void_p] * 4
    lib.upsample2x_sep_f32.restype = ctypes.c_int
    return lib


def _record(taps: Up2Taps, shape):
    """(output shape, launcher, its arguments between the output pointer
    and the stream, what those point to) of `taps` on inputs of `shape`:
    planned once per shape, kept on the taps."""
    n, c, h, w = shape
    lib = library()
    if taps.phases is not None:
        plan = sep_plan(n * c, h, w)
        args = sep_args(taps, n * c, h, w, plan)
        rec = ((n, c, 2 * h, 2 * w), lib.upsample2x_sep_f32,
               (ctypes.addressof(args),), args)
    else:
        rec = ((n, c, 2 * h, 2 * w), lib.upsample2x_f32,
               (n * c, h, w, taps.pad[0], taps.k, taps.taps_ptr), None)
    taps.records[shape] = rec
    return rec


def upsample2x_cuda(x: torch.Tensor, kflip, pad: Tuple[int, int]
                    ) -> torch.Tensor:
    """The CUDA kernel on an NCHW float32 CUDA tensor: the separable one
    where the prepared taps have phases, else the general one; raises on
    anything the kernels do not take and when the launch fails.  Per call
    it does only what depends on the tensor: the stream is PyTorch's
    current one on the tensor's device, taken as a raw handle, and no
    device context is entered when the tensor is on the current device."""
    global launches, general_launches
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upsample2x_cuda takes a contiguous float32 NCHW "
                         f"tensor, got {x.dtype} shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("upsample2x_cuda has no backward kernel")
    taps = up2_taps(kflip, pad)
    rec = taps.records.get(x.shape)
    if rec is None:
        rec = _record(taps, x.shape)
    shape, fn, args, _ = rec
    y = x.new_empty(shape)
    index = x.device.index
    if index == torch.cuda.current_device():
        rc = fn(x.data_ptr(), y.data_ptr(), *args,
                torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(x.data_ptr(), y.data_ptr(), *args,
                    torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"upsample2x kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    general_launches += int(taps.phases is None)
    return y
