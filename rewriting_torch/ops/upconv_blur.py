"""The fused up-conv + blur kernel (K1): CUDA on the card, plain PyTorch
beside it.

Replaces the JAX package's TPU kernel ``ops/pallas_upconv.py::
upconv_blur_pallas`` (:166).  It computes, for StyleGAN2's upsampling
layers,

    y = blur4x4(conv_transpose_3x3_stride2(x, w)) * 4

and optionally the epilogue ``sqrt(2) * leaky_relu(y * demod + noise +
bias, 0.2)``: the dconv, blur, noise and activate stages of the seq
pipeline in one pass.  Two sources: ``csrc/upconv_blur.cu`` (3xTF32
``mma.sync``) and ``csrc/upconv_blur_bf16.cu`` (the one-pass bf16 mode,
``wgmma`` on operands rounded to bf16 once); each describes its design and
what bounds it.

- :func:`upconv_blur_cuda` launches the kernel on a CUDA tensor or raises,
  and counts its launches in the module attribute ``launches`` (3xTF32)
  or ``launches_bf16`` (one-pass bf16).  It has no backward (the JAX
  kernel has none either): it raises on a tensor that requires a
  gradient.
- :func:`upconv_blur_reference` is the plain version: ``conv_transpose2d``
  then the plain blur and the elementwise epilogue.  The CPU path and the
  tests use it; on the card it is what the kernel is held against.
- :func:`upconv_blur` picks one of the two by the tensor's device.

Each takes the precision ``tier`` of its stage (``ops/precision.py``), as
the JAX kernel reads ``get_precision()`` (``pallas_upconv.py:236``):
"highest" and "high" run the 3xTF32 mode, the counterpart of the JAX
kernel's HIGHEST and bf16x3 HIGH (:58-78); "default" the one-pass bf16
mode, the JAX kernel's DEFAULT: ``x`` and ``wf`` rounded to bf16 (to
nearest even) and their products summed in fp32 on the tensor cores
(``wgmma`` m64n64k16 bf16).  Its plain version rounds ``x`` and ``wf`` to
bf16 and computes the rest in fp32.  The blur and the epilogue are fp32
in both modes.

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

:func:`_plan` and :func:`_plan_bf16` pick each kernel's tile for a layer
shape; they, :func:`pack_weights_bf16` and the 3xTF32 model
(:func:`_tf32_round`, :func:`_split_matmul_3xtf32`) are plain Python or
PyTorch so that the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _native_build as _build
from .blur2d import blur2d_reference
from .fused_act import fused_leaky_relu

# launches of the CUDA kernel since the counter was last set to 0: its
# 3xTF32 mode and its one-pass bf16 mode
launches = 0
launches_bf16 = 0

# the kernel's modes by precision tier: 0 is csrc/upconv_blur.cu (3xTF32),
# 1 csrc/upconv_blur_bf16.cu (one-pass bf16)
_MODES = {"highest": 0, "high": 0, "default": 1}

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


def _mode(tier: str) -> int:
    if tier not in _MODES:
        raise ValueError(f"the fused up-conv takes tier highest, high or "
                         f"default, got {tier!r}")
    return _MODES[tier]


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


# The one-pass bf16 kernel's fixed shape (csrc/upconv_blur_bf16.cu): 2
# warpgroups over 128 positions x 64 output channels x 4 phases (128 fp32
# accumulators a thread); input channels staged 32 at a time; a ring of 4
# weight stages (9 B tiles of 4096 bytes each) and 2 fp32 x stages (rows
# of the staged tile from a 16-byte aligned column, padded to 16 bytes:
# the TMA box); x rounded into
# 80-byte position rows, 2 stages; the blur's phase planes of all 64
# channels, its row pass 32 channels a round.
_BF16_ROWS, _BF16_N, _BF16_KC, _BF16_CC = 128, 64, 32, 32
_BF16_WSTAGES, _BF16_XROW = 4, 80
_BF16_TAP_BYTES = _BF16_N * _BF16_KC * 2
# fp32 accumulators a thread: 4 phases x (64 x 64) / 128 threads
BF16_ACC_REGS = 4 * 64 * _BF16_N // 128


class TileBf16(NamedTuple):
    """A one-pass block's tile: ``nimg`` whole images or one image's ``th``
    x ``tw`` input positions, with the phase halo (``th + 2`` x ``tw + 2``
    positions an image)."""
    nimg: int
    th: int
    tw: int


def _geometry_bf16(t: TileBf16) -> dict:
    """What the bf16 launcher checks of a tile, as ``geometry`` in
    ``csrc/upconv_blur_bf16.cu`` derives it: the block's positions, the
    staged positions and the shared memory in bytes (the larger of the
    ring, with the position table, and the blur's buffers)."""
    def up(n, m):
        return -(-n // m) * m

    ph, pw, xh, xw = t.th + 2, t.tw + 2, t.th + 3, up(t.tw + 6, 4)
    npos = t.nimg * xh * xw
    xstage = up(_BF16_KC * npos * 4, 1024)
    off_xf = _BF16_WSTAGES * 9 * _BF16_TAP_BYTES
    off_xb = off_xf + 2 * xstage
    off_pos = off_xb + 2 * npos * _BF16_XROW
    ring = off_pos + 4 * npos
    cg = (2 * t.tw + 3) // 4                 # groups of 4 output columns
    pc, rc = 4 * cg + 8, 4 * cg
    # a phase plane, padded so that planes 2 apart are 8 words apart mod 32
    pst = 2 * ph * pc + (4 if (4 * ph * pc) % 32 == 0 else 0)
    epi = 4 * t.nimg * (_BF16_N * pst + _BF16_CC * (2 * t.th + 3) * rc)
    off_par = up(max(ring, epi), 16)
    # the mbarriers last: no buffer overlaps them
    off_bar = up(off_par + 4 * (t.nimg * (2 * t.th * rc + _BF16_N)
                                + _BF16_N), 8)
    smem = off_bar + 8 * _BF16_WSTAGES
    return {"m_valid": t.nimg * ph * pw, "xw": xw, "npos": npos,
            "cg": cg, "pc": pc, "rc": rc, "pst": pst,
            "xstage": xstage, "off_xf": off_xf, "off_xb": off_xb,
            "off_pos": off_pos, "off_bar": off_bar, "ring": ring,
            "epi": epi, "off_par": off_par, "smem": smem, "threads": 256,
            "acc_regs": BF16_ACC_REGS}


def _grid_bf16(b: int, h: int, w: int, out_c: int, t: TileBf16):
    """The bf16 launcher's grid: output-channel blocks, tiles, batch
    groups."""
    return (-(-out_c // _BF16_N), -(-h // t.th) * -(-w // t.tw),
            -(-b // t.nimg))


def _fits_bf16(t: TileBf16) -> bool:
    g = _geometry_bf16(t)
    return g["m_valid"] <= _BF16_ROWS and g["smem"] <= _MAX_SMEM


@functools.lru_cache(maxsize=None)
def _plan_bf16(b: int, in_c: int, h: int, w: int, out_c: int) -> TileBf16:
    """The one-pass bf16 kernel's tile for a layer shape.  A block computes
    128 positions whatever its tile, so the tile is the one that needs the
    fewest blocks: maps whose (h + 2) (w + 2) phase positions fit go whole,
    ``nimg`` images a block, as many as keep the grid at one block per SM
    or more and fit the shared memory; larger maps go in th x tw tiles
    with (th + 2) (tw + 2) <= 128 that fit the shared memory and need the
    fewest tiles, the widest of those (rows of the output are
    contiguous)."""
    if min(b, in_c, h, w, out_c) < 1:
        raise ValueError(f"no tile for shape {(b, in_c, h, w, out_c)}")
    if (h + 2) * (w + 2) <= _BF16_ROWS:
        oblocks = -(-out_c // _BF16_N)
        nimg = 1
        while (nimg < b and _fits_bf16(TileBf16(nimg + 1, h, w))
               and oblocks * -(-b // (nimg + 1)) >= _SMS):
            nimg += 1
        return TileBf16(nimg, h, w)
    best = None
    for th in range(1, h + 1):
        tw = min(w, _BF16_ROWS // (th + 2) - 2)
        while tw >= 1 and not _fits_bf16(TileBf16(1, th, tw)):
            tw -= 1
        if tw < 1:
            continue
        key = (-(-h // th) * -(-w // tw), -tw, -th)
        if best is None or key < best[0]:
            best = (key, TileBf16(1, th, tw))
    if best is None:
        raise ValueError(f"no tile for shape {(b, in_c, h, w, out_c)}")
    return best[1]


def pack_weights_bf16(wf: torch.Tensor) -> torch.Tensor:
    """The correlation taps ``wf`` (O, I, 3, 3) rounded to bf16 (to nearest
    even, as ``.to(torch.bfloat16)``) in the layout the bf16 kernel's wgmma
    B descriptors read, zero-padded to whole blocks: (ceil(O / 64),
    ceil(I / 32), 9 taps, 4 k groups, 8 n groups, 8 rows, 8 values), i.e.
    for output channel o = 64 ob + 8 j + r and input channel i = 32 c +
    8 g + e, tap 3 dy + dx.  Each (ob, c) is one chunk's 36864 bytes, the
    shared-memory image of its 9 K-major no-swizzle B tiles."""
    o, i = wf.shape[:2]
    ob, nc = -(-o // _BF16_N), -(-i // _BF16_KC)
    if (ob * _BF16_N, nc * _BF16_KC) != (o, i):
        wf = F.pad(wf, (0, 0, 0, 0, 0, nc * _BF16_KC - i,
                        0, ob * _BF16_N - o))
    view = wf.reshape(ob, 8, 8, nc, 4, 8, 9).permute(  # ob j r c g e tap
        0, 3, 6, 4, 1, 2, 5)
    # one copy rounds and permutes
    out = torch.empty(view.shape, dtype=torch.bfloat16, device=wf.device)
    return out.copy_(view)


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
                          demod=None, noise=None, bias=None,
                          tier: str = "highest") -> torch.Tensor:
    """Plain PyTorch: the seq stages composed.  ``conv_transpose2d`` with
    the dconv's own (unflipped) weight, the plain blur (pad 1), then the
    epilogue if given; at tier "default" ``x`` and ``wf`` rounded to bf16
    first."""
    epilogue = _check_epilogue(demod, noise, bias)
    if _mode(tier) == 1:
        x, wf = (t.to(torch.bfloat16).float() for t in (x, wf))
    w = torch.flip(wf, (2, 3)).transpose(0, 1)          # (I, O, 3, 3)
    y = F.conv_transpose2d(x, w, stride=2)               # (B, O, 2H+1, 2W+1)
    y = blur2d_reference(y, blur_taps(kf), (1, 1))       # (B, O, 2H, 2W)
    return _epilogue(y, demod, noise, bias) if epilogue else y


@functools.lru_cache(maxsize=None)
def library():
    """The built and loaded 3xTF32 launcher ``upconv_blur_f32``."""
    lib = _build.load("upconv_blur")
    fn = lib.upconv_blur_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def library_bf16():
    """The built and loaded one-pass bf16 launcher
    ``upconv_blur_bf16_f32``."""
    lib = _build.load("upconv_blur_bf16")
    fn = lib.upconv_blur_bf16_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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
                     noise=None, bias=None, tier: str = "highest"
                     ) -> torch.Tensor:
    """The CUDA kernel on NCHW float32 CUDA tensors, in the mode of `tier`;
    raises on anything the kernel does not take and when the launch
    fails."""
    global launches, launches_bf16
    mode = _mode(tier)
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
    if mode:
        tile = _plan_bf16(b, in_c, h, w, out_c)
        wp = pack_weights_bf16(wf)
        fn = library_bf16()
    else:
        tile = _plan(b, in_c, h, w, out_c)
        # (O, I, 3, 3) -> (I, 3, 3, O): a block's weight slice is contiguous
        wp = wf.permute(1, 2, 3, 0).contiguous()
        fn = library()
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), wp.data_ptr(), y.data_ptr(), b, in_c, out_c, h,
                w, taps.ctypes.data, *ptrs, *tile, stream)
    if rc != 0:
        raise RuntimeError(f"upconv_blur kernel launch failed: CUDA error "
                           f"{rc}")
    if mode:
        launches_bf16 += 1
    else:
        launches += 1
    return y


def upconv_blur(x: torch.Tensor, wf: torch.Tensor, kf, demod=None,
                noise=None, bias=None, tier: str = "highest") -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return upconv_blur_cuda(x, wf, kf, demod, noise, bias, tier)
    if x.device.type == "cpu":
        return upconv_blur_reference(x, wf, kf, demod, noise, bias, tier)
    raise RuntimeError(f"upconv_blur has no path for device {x.device}")
