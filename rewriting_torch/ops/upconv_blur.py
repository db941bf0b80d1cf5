"""The fused up-conv + blur kernel (K1): CUDA on the card, plain PyTorch
beside it.

Replaces the JAX package's TPU kernel ``ops/pallas_upconv.py::
upconv_blur_pallas`` (:166).  It computes, for StyleGAN2's upsampling
layers,

    y = blur4x4(conv_transpose_3x3_stride2(x, w)) * 4

and optionally the epilogue ``sqrt(2) * leaky_relu(y * demod + noise +
bias, 0.2)``: the dconv, blur, noise and activate stages of the seq
pipeline in one pass.  The source, its design and what bounds it are
described in ``csrc/upconv_blur.cu``.

- :func:`upconv_blur_cuda` launches the kernel on a CUDA tensor or raises,
  and counts its launches in the module attribute ``launches``.  It has no
  backward (the JAX kernel has none either): it raises on a tensor that
  requires a gradient.
- :func:`upconv_blur_reference` is the plain version: ``conv_transpose2d``
  then the plain blur and the elementwise epilogue.  The CPU path and the
  tests use it; on the card it is what the kernel is held against.
- :func:`upconv_blur` picks one of the two by the tensor's device.

All take ``x`` (B, I, H, W); ``wf`` (O, I, 3, 3), the correlation taps of
the transposed conv (the dconv's weight flipped and scaled, as
``pipeline_fast`` builds them); ``kf``, the four 1-D blur taps with the
upsample gain, in FIR (``upfirdn2d``) orientation, flipped here; and, for
the epilogue, ``demod`` (B, O), ``noise`` (B or 1, 1, 2H, 2W) already
scaled by the noise weight (a batch of one is served to every batch
index) and ``bias`` (O,).  The output is (B, O, 2H, 2W).

The gate (``set_fused_upconv`` and friends) keeps the JAX package's names,
signatures and semantics (its ``ops/pallas_upconv.py:246-292``).  The
default is ``"off"``: ``pipeline_fast`` runs the seq stages.  ``"on"``
sends a layer through this kernel when both channel counts are at least 64
and multiples of 8 and its output resolution is at least ``min_res`` (256
by default; ``set_fused_upconv("on", min_res=0)`` takes every such layer).
The JAX ``"auto"`` is ``"on"`` behind a TPU capability probe; the port
needs no probe (on a CUDA tensor the kernel launches or raises), so here
``"auto"`` is ``"on"`` with the same gates.  ``set_fused_epilogue``
toggles the in-kernel epilogue, as in the JAX package.

:func:`_plan` picks the kernel's tile for a layer shape; it and the
3xTF32 model (:func:`_tf32_round`, :func:`_split_matmul_3xtf32`) are plain
Python so that the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .blur2d import blur2d_reference
from .fused_act import fused_leaky_relu

# launches of the CUDA kernel since the counter was last set to 0
launches = 0

_FUSED_MODE = "off"     # "off" | "on" | "auto"
_FUSED_MIN_RES = 256    # least OUTPUT resolution of a fused layer
_FUSED_EPILOGUE = True


def set_fused_upconv(mode: str, min_res: Optional[int] = None) -> None:
    """Select the up-conv of ``pipeline_fast``'s upsampling layers: "off"
    runs the seq stages, "on" and "auto" this kernel where the gates of
    :func:`fused_upconv_active` pass.  ``min_res``, if given, sets the
    least output resolution of a fused layer."""
    global _FUSED_MODE, _FUSED_MIN_RES
    if mode not in ("off", "on", "auto"):
        raise ValueError(f"fused up-conv mode {mode!r}: off, on or auto")
    _FUSED_MODE = mode
    if min_res is not None:
        _FUSED_MIN_RES = min_res


def set_fused_epilogue(on: bool) -> None:
    """Toggle the in-kernel demod + noise + bias + leaky-ReLU epilogue (on
    by default)."""
    global _FUSED_EPILOGUE
    _FUSED_EPILOGUE = bool(on)


def fused_upconv_active(in_c: int, out_c: int,
                        res: Optional[int] = None) -> bool:
    """Whether a layer of ``in_c`` -> ``out_c`` channels at OUTPUT
    resolution ``res`` runs this kernel: the JAX package's gates."""
    if _FUSED_MODE == "off":
        return False
    if in_c < 64 or out_c < 64 or in_c % 8 or out_c % 8:
        return False
    return res is None or res >= _FUSED_MIN_RES


def fused_epilogue_active(in_c: int, out_c: int,
                          res: Optional[int] = None) -> bool:
    return _FUSED_EPILOGUE and fused_upconv_active(in_c, out_c, res)


def flipped_taps(kf) -> np.ndarray:
    """The flipped 1-D blur taps (float32, host): the kernel's two blur
    passes use them."""
    c = np.ascontiguousarray(np.asarray(kf, np.float32)[::-1])
    if c.shape != (4,):
        raise ValueError(f"the fused up-conv takes 4 blur taps, got {kf}")
    return c


def blur_taps(kf) -> np.ndarray:
    """The 4x4 flipped blur taps, outer product of the flipped 1-D taps
    (float32, host)."""
    c = flipped_taps(kf)
    return np.ascontiguousarray(np.outer(c, c).astype(np.float32))


# The kernel's fixed shape (csrc/upconv_blur.cu): a warp holds 32
# positions x 16 output channels; a 3-stage ring; at most 384 threads and
# 232448 bytes of shared memory a block; 132 SMs on an H100 SXM.
_WARP_M, _WARP_N, _STAGES = 32, 16, 3
_MAX_SMEM, _SMS = 232448, 132


class Tile(NamedTuple):
    """A block's tile: ``nimg`` whole images or one image's ``th`` x ``tw``
    input positions (plus the phase halo), ``warps_m`` x ``warps_n``
    warps, input channels staged ``kc`` at a time."""
    nimg: int
    th: int
    tw: int
    warps_m: int
    warps_n: int
    kc: int


def _pad_banks(n: int) -> int:
    return n + (8 - n % 32) % 32


def _geometry(t: Tile) -> dict:
    """What the launcher checks of a tile, as ``geometry`` in
    ``csrc/upconv_blur.cu`` derives it: the block's positions (tile and
    halo), output channels and threads, and its shared memory in bytes
    (the larger of the cp.async ring and the blur's buffers)."""
    ph, pw, xh, xw = t.th + 2, t.tw + 2, t.th + 3, t.tw + 3
    nblk = t.warps_n * _WARP_N
    xk = _pad_banks(t.nimg * xh * xw)
    wk = _pad_banks(9 * nblk)
    ring = _STAGES * t.kc * (xk + wk)
    epi = nblk * t.nimg * (2 * ph * (2 * pw + 1)
                           + (2 * t.th + 3) * (2 * t.tw + 1))
    return {"m_valid": t.nimg * ph * pw, "nblk": nblk,
            "threads": t.warps_m * t.warps_n * 32,
            "smem": 4 * max(ring, epi)}


@functools.lru_cache(maxsize=None)
def _plan(b: int, in_c: int, h: int, w: int, out_c: int) -> Tile:
    """The tile for a layer shape.  Maps of at most 64 positions go whole,
    ``nimg`` images a block, as many as keep the grid at one block per SM
    or more while the blur's buffers fit; larger maps go in tiles of 8 x
    16 input positions (10 x 18 with the halo: 6 warps of 32 positions).  Blocks take 32 output
    channels and stage 32 input channels at a time where that fits.
    These choices are the fastest of those timed on an H100 at the
    church-256 shapes (``PERF.md`` §6)."""
    if min(b, in_c, h, w, out_c) < 1:
        raise ValueError(f"no tile for shape {(b, in_c, h, w, out_c)}")
    if h * w <= 64:
        th, tw, nimg, warps_n = h, w, 1, 1
        oblocks = -(-out_c // _WARP_N)
        while (2 * nimg <= min(b, 16)
               and oblocks * -(-b // (2 * nimg)) >= _SMS
               and _geometry(Tile(2 * nimg, h, w, 1, 1, 8))["smem"]
               <= _MAX_SMEM):
            nimg *= 2
    else:
        th, tw, nimg = min(8, h), min(16, w), 1
        warps_n = 2 if out_c > _WARP_N else 1
    warps_m = -(-nimg * (th + 2) * (tw + 2) // _WARP_M)
    for kc in (32, 16, 8):
        t = Tile(nimg, th, tw, warps_m, warps_n, kc)
        if _geometry(t)["smem"] <= _MAX_SMEM:
            return t
    raise ValueError(f"no tile for shape {(b, in_c, h, w, out_c)}")


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A plain model of the kernel's 3xTF32 product ``a @ b`` (float32):
    each operand split into hi = tf32(v) and lo = tf32(v - hi), then lo*hi
    + hi*lo + hi*hi, summed in float32 in the kernel's order.  The tests use
    it to show that the split is as exact as float32 and plain TF32 is
    not."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_round(a - ah), _tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _epilogue(y, demod, noise, bias):
    return fused_leaky_relu(y * demod[:, :, None, None] + noise, bias)


def _check_epilogue(demod, noise, bias):
    given = [v is not None for v in (demod, noise, bias)]
    if any(given) and not all(given):
        raise ValueError("demod, noise and bias go together (the fused "
                         "epilogue)")
    return all(given)


def upconv_blur_reference(x: torch.Tensor, wf: torch.Tensor, kf,
                          demod=None, noise=None, bias=None) -> torch.Tensor:
    """Plain PyTorch: the seq stages composed.  ``conv_transpose2d`` with
    the dconv's own (unflipped) weight, the plain blur (pad 1), then the
    epilogue if given."""
    epilogue = _check_epilogue(demod, noise, bias)
    w = torch.flip(wf, (2, 3)).transpose(0, 1)          # (I, O, 3, 3)
    y = F.conv_transpose2d(x, w, stride=2)               # (B, O, 2H+1, 2W+1)
    y = blur2d_reference(y, blur_taps(kf), (1, 1))       # (B, O, 2H, 2W)
    return _epilogue(y, demod, noise, bias) if epilogue else y


@functools.lru_cache(maxsize=None)
def library():
    """The built and loaded launcher ``upconv_blur_f32``."""
    lib = _build.load("upconv_blur")
    fn = lib.upconv_blur_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shapes, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"upconv_blur_cuda: {name} must be float32 on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"upconv_blur_cuda: {name} has shape "
                         f"{tuple(t.shape)}, expected one of {shapes}")


def upconv_blur_cuda(x: torch.Tensor, wf: torch.Tensor, kf, demod=None,
                     noise=None, bias=None) -> torch.Tensor:
    """The CUDA kernel on NCHW float32 CUDA tensors; raises on anything the
    kernel does not take and when the launch fails."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"upconv_blur_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upconv_blur_cuda takes a contiguous float32 NCHW "
                         f"tensor, got {x.dtype} shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    epilogue = _check_epilogue(demod, noise, bias)
    inputs = [x, wf] + ([demod, noise, bias] if epilogue else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("upconv_blur_cuda has no backward kernel")
    b, in_c, h, w = x.shape
    out_c = wf.shape[0]
    _check("wf", wf, [(out_c, in_c, 3, 3)], x.device)
    taps = flipped_taps(kf)
    tile = _plan(b, in_c, h, w, out_c)
    # (O, I, 3, 3) -> (I, 3, 3, O): a block's weight slice is contiguous
    wp = wf.permute(1, 2, 3, 0).contiguous()
    if epilogue:
        _check("demod", demod, [(b, out_c)], x.device)
        _check("noise", noise, [(b, 1, 2 * h, 2 * w), (1, 1, 2 * h, 2 * w)],
               x.device)
        _check("bias", bias, [(out_c,)], x.device)
        demod, noise, bias = (t.contiguous() for t in (demod, noise, bias))
        noise_bstride = 0 if noise.shape[0] == 1 else 4 * h * w
        ptrs = (demod.data_ptr(), noise.data_ptr(), noise_bstride,
                bias.data_ptr())
    else:
        ptrs = (None, None, 0, None)
    y = torch.empty((b, out_c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    fn = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), wp.data_ptr(), y.data_ptr(), b, in_c, out_c, h,
                w, taps.ctypes.data, *ptrs, *tile, stream)
    if rc != 0:
        raise RuntimeError(f"upconv_blur kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return y


def upconv_blur(x: torch.Tensor, wf: torch.Tensor, kf, demod=None,
                noise=None, bias=None) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return upconv_blur_cuda(x, wf, kf, demod, noise, bias)
    if x.device.type == "cpu":
        return upconv_blur_reference(x, wf, kf, demod, noise, bias)
    raise RuntimeError(f"upconv_blur has no path for device {x.device}")
