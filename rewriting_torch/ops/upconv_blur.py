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

The gate (``set_fused_upconv`` and friends) keeps the JAX package's names.
Its modes: ``"auto"`` (the default) and ``"on"`` both send every
upsampling layer with a 4-tap FIR through this kernel with its epilogue;
``"off"`` runs the seq stages.  The JAX package's channel and resolution
gates came from TPU runtime limits and TPU timings and are not carried
over.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .blur2d import blur2d_reference
from .fused_act import fused_leaky_relu

# launches of the CUDA kernel since the counter was last set to 0
launches = 0

_MODE = "auto"      # "off" | "on" | "auto"
_EPILOGUE = True


def set_fused_upconv(mode: str) -> None:
    """Select the up-conv of ``pipeline_fast``'s upsampling layers: "auto"
    and "on" run this kernel, "off" the seq stages."""
    global _MODE
    if mode not in ("off", "on", "auto"):
        raise ValueError(f"fused up-conv mode {mode!r}: off, on or auto")
    _MODE = mode


def fused_upconv_active() -> bool:
    return _MODE != "off"


def set_fused_epilogue(on: bool) -> None:
    """Toggle the in-kernel demod + noise + bias + leaky-ReLU epilogue (on
    by default)."""
    global _EPILOGUE
    _EPILOGUE = bool(on)


def fused_epilogue_active() -> bool:
    return _EPILOGUE and fused_upconv_active()


def blur_taps(kf) -> np.ndarray:
    """The 4x4 flipped blur taps, outer product of the flipped 1-D taps
    (float32, host)."""
    c = np.asarray(kf, np.float32)[::-1]
    if c.shape != (4,):
        raise ValueError(f"the fused up-conv takes 4 blur taps, got {kf}")
    return np.ascontiguousarray(np.outer(c, c).astype(np.float32))


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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_void_p]
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
    taps = blur_taps(kf)
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
                w, taps.ctypes.data, *ptrs, stream)
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
