"""The FIR blur kernel (K2): CUDA on the card, plain PyTorch beside it.

Replaces the JAX package's TPU kernels ``ops/pallas_upfirdn.py::
blur2d_pallas`` (:85) and ``::blur2d_pallas_bs`` (:230).  Both compute the
depthwise correlation of a padded NCHW map with a flipped k x k FIR, i.e.
``upfirdn2d(x, k, up=1, down=1, pad)``; the source, its design and what
bounds it are described in ``csrc/blur2d.cu``.

- :func:`blur_taps` prepares the taps of one blur and pad once: the
  flipped taps, their factors when they are an outer product, and the
  adjoint's taps and pads.  It caches on the taps' bytes and the pad, and
  the model builds each layer's taps in its closure, so a launch does only
  what depends on the tensor.
- :func:`blur2d_cuda` launches a kernel on a CUDA tensor or raises: the
  separable row-band kernel (``blur2d_sep_f32``) for rank-1 taps, which the
  model's always are, else the general k x k kernel (``blur2d_f32``).  It
  counts its launches in the module attribute ``launches``, and those of
  the general kernel also in ``general_launches``.
- :class:`Blur2dFunction` gives the kernel a gradient.  The adjoint of a
  correlation with taps ``kflip`` and pads ``(p0, p1)`` is the correlation
  of the output gradient with the 180-degree-rotated taps and pads
  ``(k-1-p0, k-1-p1)``, whose output has the input's shape; the backward
  (:func:`blur2d_backward_cuda`) launches the same kernels with those taps
  and pads (rank 1 again for rank-1 taps) and counts in
  ``backward_launches``.
- :func:`blur2d_reference` is the plain version: the same taps in the same
  order as shifted adds, and :func:`blur2d_backward_reference` the adjoint
  through it.  The CPU path and the tests use them; on the card they are
  what both kernels are held against.

All take ``kflip``: the spatially flipped kernel with any gain applied, a
host float32 (k, k) array, or the :class:`BlurTaps` that :func:`blur_taps`
made of it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _native_build as _build

MAX_TAPS = 8

# launches since the counters were last set to 0: of the forward blur, of
# the adjoint the backward runs, and of the general kernel on either
launches = 0
backward_launches = 0
general_launches = 0

# warps a block of the separable kernel (kSepWarps in csrc/blur2d.cu), and
# the warps a launch should reach before its bands are made shorter: one
# wave of 64 warps on each of the H100's 132 SMs
SEP_WARPS = 4
SEP_TARGET_WARPS = 132 * 64
SEP_MAX_CHUNKS = 3


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


def separable_factors(kflip):
    """(col, row), float32, with ``outer(col, row)`` equal to the square
    taps ``kflip`` to within 1 ulp of the largest tap; None when the taps
    are not rank 1 (or are all zero).  The pivot's column and row, each
    divided by the square root of the pivot, are exact for the model's
    taps."""
    t = np.asarray(kflip, np.float64)
    i, j = np.unravel_index(np.argmax(np.abs(t)), t.shape)
    p = t[i, j]
    if p == 0:
        return None
    s = np.sqrt(abs(p))
    col = (t[:, j] / s).astype(np.float32)
    row = (t[i, :] * (np.sign(p) / s)).astype(np.float32)
    err = np.abs(np.outer(col.astype(np.float64), row) - t).max()
    if not err <= np.spacing(np.float32(abs(p))):
        return None
    return col, row


class BlurTaps:
    """The flipped taps of one blur with one pad, prepared for launches:
    ``kflip`` (read-only float32), ``k``, ``pad``, the ``factors`` (col,
    row) when the taps are rank 1 and square of at most MAX_TAPS (else
    None), and :attr:`adjoint`.  ``np.asarray`` of it gives ``kflip``."""

    def __init__(self, kflip, pad: Tuple[int, int]):
        kflip = np.array(kflip, np.float32)
        if kflip.ndim != 2:
            raise ValueError(f"blur taps must be 2-D, got {kflip.shape}")
        kflip.setflags(write=False)
        self.kflip = kflip
        self.k = kflip.shape[0]
        self.pad = (int(pad[0]), int(pad[1]))
        self.factors = (separable_factors(kflip)
                        if kflip.shape == (self.k, self.k)
                        and 1 <= self.k <= MAX_TAPS else None)
        # the host address the general launcher reads (kflip lives on self)
        self.taps_ptr = kflip.ctypes.data
        # (input shape, pad) -> what _launch needs, made by _record
        self.records = {}

    def __array__(self, dtype=None, copy=None):
        return self.kflip if dtype is None else self.kflip.astype(dtype)

    @functools.cached_property
    def adjoint(self) -> "BlurTaps":
        """The backward's taps: rotated by 180 degrees, adjoint pads."""
        taps, apad = adjoint(self.kflip, self.pad)
        return blur_taps(taps, apad)


@functools.lru_cache(maxsize=None)
def _cached_taps(data: bytes, shape, pad) -> BlurTaps:
    return BlurTaps(np.frombuffer(data, np.float32).reshape(shape), pad)


def blur_taps(kflip, pad: Tuple[int, int]) -> BlurTaps:
    """The prepared taps for (kflip, pad), one object per distinct taps
    and pad; a BlurTaps of the same pad is handed back as it is."""
    if isinstance(kflip, BlurTaps) and kflip.pad == tuple(pad):
        return kflip
    a = np.ascontiguousarray(kflip, np.float32)
    return _cached_taps(a.tobytes(), a.shape, (int(pad[0]), int(pad[1])))


class SepPlan(NamedTuple):
    """How the separable kernel cuts a launch: ``lanes`` a plane's row
    (32 // lanes planes a warp), ``chunks`` of 4 * lanes columns a lane,
    ``rows`` output rows a band; the ``bands`` of a plane, the ``spans``
    of columns of a row, and the ``tasks`` (plane, band, span) and
    ``warps`` they make."""
    lanes: int
    chunks: int
    rows: int
    bands: int
    spans: int
    tasks: int
    warps: int


@functools.lru_cache(maxsize=None)
def _sep_plan(planes: int, ho: int, wo: int, min_rows: int = 8,
              target_warps=SEP_TARGET_WARPS) -> SepPlan:
    """The separable kernel's cut of ``planes`` output planes (ho, wo):
    the fewest lanes whose 4 columns each cover a row (a warp then takes
    several narrow planes), up to 32 lanes and 3 chunks a lane, then wider
    rows in spans; bands of the whole plane, halved down to `min_rows`
    rows while the launch has fewer than `target_warps` warps (each band
    reads k - 1 halo rows again; None: halved down to `min_rows` at any
    size).  K3's separable kernel cuts its input planes the same way
    (``ops/upsample2x.py::sep_plan``)."""
    lanes = 1
    while 4 * lanes < wo and lanes < 32:
        lanes *= 2
    chunks = min(SEP_MAX_CHUNKS, -(-wo // (4 * lanes)))
    spans = -(-wo // (4 * lanes * chunks))
    per_warp = 32 // lanes

    def cut(rows):
        bands = -(-ho // rows)
        tasks = planes * bands * spans
        return SepPlan(lanes, chunks, rows, bands, spans, tasks,
                       -(-tasks // per_warp))
    plan = cut(ho)
    while plan.rows > min_rows and (target_warps is None
                                    or plan.warps < target_warps):
        plan = cut(-(-plan.rows // 2))
    return plan


class SepArgs(ctypes.Structure):
    """The separable launcher's arguments: ``struct SepArgs`` of
    ``csrc/blur2d.cu``, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "planes", "h", "w", "ho", "wo", "pad0", "k", "lanes", "chunks",
        "rows")] + [("col", ctypes.c_float * MAX_TAPS),
                    ("row", ctypes.c_float * MAX_TAPS)]


def sep_args(taps: BlurTaps, planes: int, h: int, w: int, ho: int, wo: int,
             plan: SepPlan) -> SepArgs:
    """The separable launcher's arguments for rank-1 `taps` on `planes`
    (h, w) -> (ho, wo) planes cut by `plan`."""
    col, row = taps.factors
    a = SepArgs(planes, h, w, ho, wo, taps.pad[0], taps.k, plan.lanes,
                plan.chunks, plan.rows)
    a.col[:taps.k] = col.tolist()
    a.row[:taps.k] = row.tolist()
    return a


@functools.lru_cache(maxsize=None)
def library():
    """The built and loaded library, with the launchers ``blur2d_f32``
    (general) and ``blur2d_sep_f32`` (separable) typed."""
    lib = _build.load("blur2d")
    lib.blur2d_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.blur2d_f32.restype = ctypes.c_int
    lib.blur2d_sep_f32.argtypes = [ctypes.c_void_p] * 4
    lib.blur2d_sep_f32.restype = ctypes.c_int
    return lib


def _record(taps: BlurTaps, shape, pad: Tuple[int, int]):
    """(output shape, launcher, its arguments between the output pointer
    and the stream, what those point to) of `taps` on inputs of `shape`:
    checked and planned once per shape, kept on the taps."""
    k = taps.k
    if taps.kflip.shape != (k, k) or not 1 <= k <= MAX_TAPS:
        raise ValueError(f"blur2d_cuda takes a square kernel of at most "
                         f"{MAX_TAPS} taps, got {taps.kflip.shape}")
    n, c, h, w = shape
    out = output_shape(shape, k, pad)
    ho, wo = out[2:]
    if ho < 1 or wo < 1:
        raise ValueError(f"blur2d_cuda: empty output {out} for input "
                         f"{tuple(shape)}, kernel {k}, pad {pad}")
    lib = library()
    if taps.factors is not None:
        args = sep_args(taps, n * c, h, w, ho, wo, _sep_plan(n * c, ho, wo))
        rec = (out, lib.blur2d_sep_f32, (ctypes.addressof(args),), args)
    else:
        rec = (out, lib.blur2d_f32,
               (n * c, h, w, ho, wo, pad[0], k, taps.taps_ptr), None)
    taps.records[(shape, pad)] = rec
    return rec


def _launch(x: torch.Tensor, taps: BlurTaps, pad: Tuple[int, int]
            ) -> torch.Tensor:
    """One launch on an NCHW float32 CUDA tensor, of the separable kernel
    where ``taps.factors`` has them, else of the general one; raises on
    anything the kernels do not take and when the launch fails.  Per call
    it does only what depends on the tensor.  The stream is PyTorch's
    current one on the tensor's device, taken as a raw handle (the handle
    Triton's launcher takes too): ``current_stream().cuda_stream`` builds
    a Stream object, 4-9 us of host time a call on an H100's host against
    0.2 (``scripts/compare_blur.py``'s host probe)."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"blur2d_cuda needs a CUDA tensor, got {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"blur2d_cuda takes float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("blur2d_cuda takes a contiguous NCHW tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    rec = taps.records.get((x.shape, pad))
    if rec is None:
        rec = _record(taps, x.shape, pad)
    shape, fn, args, _ = rec
    y = x.new_empty(shape)
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(x.data_ptr(), y.data_ptr(), *args,
                torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(x.data_ptr(), y.data_ptr(), *args,
                    torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"blur2d kernel launch failed: CUDA error {rc}")
    return y


def blur2d_cuda(x: torch.Tensor, kflip, pad: Tuple[int, int]
                ) -> torch.Tensor:
    """The CUDA kernel on an NCHW float32 CUDA tensor (no gradient: use
    :class:`Blur2dFunction` for a tensor that requires one)."""
    global launches, general_launches
    taps = blur_taps(kflip, pad)
    y = _launch(x, taps, taps.pad)
    launches += 1
    general_launches += int(taps.factors is None)
    return y


def blur2d_backward_cuda(grad: torch.Tensor, kflip, pad: Tuple[int, int]
                         ) -> torch.Tensor:
    """The input gradient of the blur from its output gradient: the same
    kernels with the adjoint's taps and pads."""
    global backward_launches, general_launches
    taps = blur_taps(kflip, pad).adjoint
    dx = _launch(grad.contiguous(), taps, taps.pad)
    backward_launches += 1
    general_launches += int(taps.factors is None)
    return dx


class Blur2dFunction(torch.autograd.Function):
    """``blur2d_cuda`` with the adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, x, kflip, pad):
        ctx.taps = blur_taps(kflip, pad)
        return blur2d_cuda(x, ctx.taps, ctx.taps.pad)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return blur2d_backward_cuda(grad, ctx.taps, ctx.taps.pad), None, None
