"""StyleGAN2 generator as a stage pipeline: the seq pipeline and the
sampling pipeline ``pipeline_fast``.

Counterpart of the JAX package's ``models/stylegan2.py`` ``SeqStyleGAN2``
(:587-869), weight-compatible with the rosinality port.  The modulated
conv is split into modulation -> adain -> dconv -> blur so that the linear
conv (``dconv``) can be rewritten as a linear associative memory.  Stage
names mirror the reference module paths (``layer8.sconv.mconv.dconv``), so
saved edit requests and surgery code work unchanged.

``pipeline_fast``, the default of ``__call__``, has the same stages and
reads the same params (JAX package :672-720):

- at a wide upsampling layer with a 4-tap FIR whose shape passes K1's gate
  (``ops/upconv_blur.set_fused_upconv``, "off" by default as in the JAX
  package) its dconv runs the fused up-conv + blur + epilogue kernel (K1,
  ``ops/upconv_blur.py``) and its blur, noise and activate stages pass the
  bag through (JAX package :237-308);
- the narrow high-resolution tail (upsampling layers of at most
  ``s2d_tail_max_c`` = 32 channels at an output resolution of at least
  ``s2d_tail_min_res`` = 512, and the layers after them while they stay
  that narrow: the 1024 layers of faces-1024) runs blur-folded in a
  space-to-depth layout (JAX package :365-531).  The up-conv and the blur
  become one 3x3 conv producing the four output phases as channels at the
  input resolution (``_composite_up_kernel``), and the map stays (B, 4C,
  H/2, W/2), phase-major, through the narrow layers' convs, noise,
  activation and to_rgb; a wider layer after the tail takes the map back
  to NCHW at its adain.  The same products, regrouped.

``pipeline_fused`` (``__call__(fused=True)``) is the JAX package's
subpixel alternate (:311-370): the seq stages with each up-conv computed
as one 2x2 conv of 4O phase channels at the input resolution; the seq
blur (K2 on the card) follows it.

The statistics and the edits run on ``pipeline``, whose stage boundaries
they read.  Every stage's convolutions and matmuls read the precision
tier of its stage (``ops/precision.py``): the dconvs take the int8 core
(``ops/quant.conv2d_w8a8``) under an "int8" stage, as JAX :186-209 do;
``stage_resolution``, ``mixed_precision_schedule`` and
``recommended_precision_schedule`` are the JAX package's schedules
(:998-1106).

Layout: activations are NCHW inside; ``__call__`` returns NHWC images, as
the JAX package's does.  Weights are in torch order, as in the JAX
package: dconv ``(1, O, I, 3, 3)``, to_rgb ``(1, 3, C, 1, 1)``; the const
input is ``(1, C, 4, 4)`` and the noise buffers ``(1, 1, h, w)``.

Noise: as in the reference's NoiseInjectionF, every injection reads
``np.random.RandomState(0).randn(batch, h*w)`` (prefix-stable in batch),
passed in through bag keys ``noise_{h}x{w}`` and regenerated for any other
shape (a cropped window).
"""

from __future__ import annotations

import functools
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import DataBag, Stage, StagePipeline, leaves, tree_map
from ..ops import fused_leaky_relu, make_kernel, upsample2d
from ..ops.grouped import folded, side_by_side
from ..ops.upfirdn2d import apply_blur, blur_taps
from ..ops.precision import (apply_parity_tier, get_precision, int8_active,
                             tiered)
from ..ops.quant import conv2d_w8a8, quantize_weight_per_channel
from ..ops.upconv_blur import (fused_epilogue_active, fused_upconv_active,
                               upconv_blur)
from ..utils.device import resolve_device


def CHANNELS(cm):
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
            256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}


@functools.lru_cache(maxsize=64)
def _reference_noise_np(batch: int, h: int, w: int) -> np.ndarray:
    noise = np.random.RandomState(0).randn(batch, h * w).astype(np.float32)
    return noise.reshape(batch, 1, h, w)


@functools.lru_cache(maxsize=64)
def _reference_noise(batch: int, h: int, w: int,
                     device: torch.device) -> torch.Tensor:
    """RandomState(0).randn(batch, h*w) as (batch, 1, h, w) on `device`
    (JAX package :56; reference models.py:543-545)."""
    return torch.from_numpy(_reference_noise_np(batch, h, w)).to(device)


def noise_key(h: int, w: int) -> str:
    return f"noise_{h}x{w}"


# ---------------------------------------------------------------------------
# Stage functions
# ---------------------------------------------------------------------------

def _bag_in(params, z) -> DataBag:
    if isinstance(z, DataBag):
        return z
    return DataBag(latent=z)


def _pixel_norm_latent(params, d: DataBag) -> DataBag:
    x = d["latent"]
    return DataBag(d, latent=x * torch.rsqrt(
        torch.mean(x * x, dim=1, keepdim=True) + 1e-8))


def _equal_linear(params, x, scale, lr_mul, activation):
    out = tiered(torch.matmul, x, (params["weight"] * scale).t())
    if activation == "fused_lrelu":
        return fused_leaky_relu(out, params["bias"] * lr_mul)
    return out + params["bias"] * lr_mul


def _make_style_linear(in_dim, lr_mul):
    scale = (1.0 / math.sqrt(in_dim)) * lr_mul

    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, latent=_equal_linear(params, d["latent"], scale,
                                               lr_mul, "fused_lrelu"))
    return fn


def _make_modulation(style_dim):
    scale = 1.0 / math.sqrt(style_dim)

    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, style=_equal_linear(params, d["style"], scale,
                                              1.0, None))
    return fn


def _make_adjust_latent(n_latent, truncation):
    def fn(params, d: DataBag) -> DataBag:
        latent = d["latent"]
        avg = params["latent_avg"]
        if truncation != 1.0 and avg.dim() > 0:
            latent = avg + truncation * (latent - avg)
        latent = latent[:, None, :].expand(-1, n_latent, -1)
        return DataBag(d, latent=latent)
    return fn


def _noises_stage(params, d: DataBag) -> DataBag:
    # the reference injects its noise_i buffers into the bag; they are
    # carried but never read (the injection stages read noise_{h}x{w})
    out = DataBag(d)
    for k, v in params.items():
        if k.startswith("noise_") and k not in out:
            out[k] = v
    return out


def _constant_input(params, d: DataBag) -> DataBag:
    const = params["input"]
    batch = d["latent"].shape[0]
    return DataBag(d, fmap=const.expand((batch,) + tuple(const.shape[1:])))


def _make_pick_latent(index):
    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, style=d["latent"][:, index])
    return fn


def _apply_style(params, d: DataBag) -> DataBag:
    # adain: per-sample, per-input-channel scaling (models.py:616-620)
    return DataBag(d, fmap=d["style"][:, :, None, None] * d["fmap"])


def modconv_linear(x: torch.Tensor, w: torch.Tensor, upsample: bool,
                   kernel_size: int, groups: int = 1) -> torch.Tensor:
    """The dconv's bare linear conv of an NCHW map by an OIHW weight: at an
    upsampling layer the stride-2 transposed conv (output 2H+1; == the
    lhs-dilated conv with the flipped kernel and k-1 padding of the JAX
    package, :186-202), else the padded conv.  With ``groups`` = G the map
    holds G maps side by side (B, G·I, H, W) and `w` their G kernels (G·O,
    I, k, k) (``ops/grouped.py``)."""
    if not upsample:
        return tiered(F.conv2d, x, w, padding=kernel_size // 2,
                      groups=groups)
    go, i, kh, kw = w.shape
    o = go // groups
    # conv_transpose2d's grouped weight is (G·I, O, k, k)
    wt = w.reshape(groups, o, i, kh, kw).transpose(1, 2).reshape(
        groups * i, o, kh, kw)
    return tiered(F.conv_transpose2d, x, wt, stride=2, groups=groups)


def modconv_w8a8(x: torch.Tensor, w: torch.Tensor, upsample: bool,
                 kernel_size: int, weight_max=None,
                 row_pad: Optional[int] = None) -> torch.Tensor:
    """:func:`modconv_linear` on the int8 core (JAX package :186-209): the
    weight quantized per output channel, the map per tensor; at an
    upsampling layer the lhs-dilated conv with the flipped kernel and k-1
    padding.  ``weight_max`` (``parallel/comm.max_over``) marks `w` as one
    rank's input channels of a row-parallel weight: each output channel's
    scale is then the max over every rank's share.  ``row_pad`` replaces
    the 3x3 conv's padding of the rows (a band that brings its own halo
    takes 0)."""
    if upsample:
        w = torch.flip(w, (-2, -1))
        pad, dilation = ((kernel_size - 1,) * 2,) * 2, (2, 2)
    else:
        p = kernel_size // 2
        pad, dilation = ((p if row_pad is None else row_pad,) * 2,
                         (p, p)), None
    w_i8, w_scale = quantize_weight_per_channel(w, axis=0,
                                                reduce_max=weight_max)
    return conv2d_w8a8(x, w_i8, w_scale, padding=pad, lhs_dilation=dilation)


def _make_dconv(in_c, kernel_size, upsample, int8=True):
    """The seq dconv; ``int8=False`` keeps an int8 stage's conv at "default"
    (the s2d tail's convs have no int8 core, and tp and the spatial bands
    run the tail's seq stages in its place)."""
    scale = 1.0 / math.sqrt(in_c * kernel_size ** 2)

    def fn(params, d: DataBag) -> DataBag:
        # (G, O, I, kh, kw): G = 1, or G edits of the weight over a bag
        # folded edit-major (ops/grouped.py)
        weight = params["weight"]
        x = d["fmap"]
        g = weight.shape[0]
        if g == 1:
            w = weight[0] * scale
            conv = modconv_w8a8 if int8 and int8_active() \
                else modconv_linear
            out = conv(x, w, upsample, kernel_size)
        elif int8_active():
            raise ValueError("the int8 tier takes one dconv weight, got a "
                             f"stack of {g}")
        else:
            w = weight * scale
            out = folded(modconv_linear(
                side_by_side(x, g), w.reshape((-1,) + tuple(w.shape[2:])),
                upsample, kernel_size, groups=g), g)
        # demod applied after the conv so the conv stays a plain linear map
        demod = _demod(w, d["style"])
        return DataBag(d, fmap=out * demod[:, :, None, None])
    return fn


def _demod(w, style):
    """rsqrt(sum_{I,kh,kw} (scale*W*style)^2 + 1e-8) per (B, O), from the
    scaled (O, I, kh, kw) weight; from a (G, O, I, kh, kw) stack, per
    (G·B, O) of a batch folded edit-major."""
    w_sq = torch.sum(w * w, dim=(-2, -1))    # (O, I) or (G, O, I)
    if w_sq.dim() == 2:
        return torch.rsqrt(tiered(torch.matmul, style * style, w_sq.t())
                           + 1e-8)
    g = w_sq.shape[0]
    s2 = (style * style).reshape(g, -1, style.shape[-1])
    return torch.rsqrt(tiered(torch.bmm, s2, w_sq.transpose(1, 2))
                       + 1e-8).reshape(-1, w_sq.shape[1])


def _make_blur(blur_kernel, pad, upsample_factor):
    taps = blur_taps(make_kernel(blur_kernel), pad, upsample_factor)

    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, fmap=apply_blur(d["fmap"], taps))
    return fn


def _make_fused_upconv_dconv(prefix, in_c, out_c, blur_kernel, res=None):
    """pipeline_fast's dconv at an upsampling layer (JAX package :237-282):
    where the gate passes for (in_c, out_c, res), dconv AND blur (and,
    with the epilogue, noise and activate too) in one pass of K1; else the
    seq dconv, and the stages after it run as in the seq pipeline.  `res`
    is the layer's output resolution.  Takes the FULL params
    (``_full_params``): the epilogue reads the noise and activate stages'
    parameters.  K1 runs at the stage's tier, as JAX :236 passes
    ``get_precision()``: its one-pass bf16 mode under "default" and
    "int8"."""
    seq_fn = _make_dconv(in_c, 3, True)
    scale = 1.0 / math.sqrt(in_c * 9)
    k = np.asarray(blur_kernel, np.float64)
    kf = tuple(float(v) for v in (k / k.sum()) * 2.0)  # 1-D taps with gain

    def fn(params, d: DataBag) -> DataBag:
        own = params.get(f"{prefix}.mconv.dconv", {})
        if not fused_upconv_active(in_c, out_c, res):
            return seq_fn(own, d)
        w = own["weight"][0] * scale
        wf = torch.flip(w, (-2, -1))             # correlation taps
        x = d["fmap"]
        # demod commutes with the channel-wise blur
        demod = _demod(w, d["style"])
        tier = get_precision()
        if not fused_epilogue_active(in_c, out_c, res):
            return DataBag(d, fmap=upconv_blur(x, wf, kf, tier=tier)
                           * demod[:, :, None, None])
        b, _, h, wd = x.shape
        noise = d.get(noise_key(2 * h, 2 * wd))
        if noise is None:
            noise = _reference_noise(b, 2 * h, 2 * wd, x.device)
        noise = params[f"{prefix}.noise"]["weight"] * noise
        bias = params[f"{prefix}.activate"]["bias"]
        return DataBag(d, fmap=upconv_blur(x, wf, kf, demod, noise, bias,
                                           tier=tier))
    fn._full_params = True
    return fn


def _make_shape_dispatch_blur(blur_kernel, pad, upsample_factor):
    """pipeline_fast's blur paired with the fused dconv (JAX package
    :285-296): the seq up-dconv emits (2H+1, 2W+1), still to blur; the
    fused kernel emits the final even-sized (2H, 2W)."""
    blur_fn = _make_blur(blur_kernel, pad, upsample_factor)

    def fn(params, d: DataBag) -> DataBag:
        if d["fmap"].shape[2] % 2 == 0:
            return d
        return blur_fn(params, d)
    return fn


def _make_epilogue_skip(seq_fn, in_c, out_c, res):
    """pipeline_fast's noise / activate at a fused layer (JAX package
    :299-308): the identity when the epilogue ran in the kernel, under the
    same gate as the dconv stage."""
    def fn(params, d: DataBag) -> DataBag:
        if fused_epilogue_active(in_c, out_c, res):
            return d
        return seq_fn(params, d)
    return fn


def _one_weight(weight: torch.Tensor) -> torch.Tensor:
    """The (O, I, k, k) dconv weight of a stage that takes one weight."""
    if weight.shape[0] != 1:
        raise ValueError("this pipeline takes one dconv weight, got a stack "
                         f"of {weight.shape[0]}; the seq pipeline takes "
                         "many")
    return weight[0]


def _pass_through(params, d: DataBag) -> DataBag:
    return d


def _rgb_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """to_rgb's 1x1 conv: (B, C, H, W) by (3, C)."""
    return torch.einsum("bchw,oc->bohw", x, w)


def _subpixel3_kernel(wf: torch.Tensor, out_c: int, in_c: int
                      ) -> torch.Tensor:
    """(O, I, 3, 3) correlation taps -> (4O, I, 2, 2) subpixel phase
    kernels of the stride-2 transposed conv (JAX package :311-326): by
    output parity p the dilated conv's 3 taps become 2 over the undilated
    input, p=0 taps [wf0, wf2] at {u-1, u}, p=1 taps [0, wf1] at {u}."""
    idx = torch.tensor([[0, 2], [0, 1]], device=wf.device)
    msk = torch.tensor([[1.0, 1.0], [0.0, 1.0]], dtype=wf.dtype,
                       device=wf.device)
    ky = wf[:, :, idx, :] * msk[None, None, :, :, None]       # (O,I,p,ty,3)
    k = ky[:, :, :, :, idx] * msk[None, None, None, None]     # (O,I,p,ty,q,tx)
    return k.permute(2, 4, 0, 1, 3, 5).reshape(4 * out_c, in_c, 2, 2)


def _make_subpixel_up_dconv(in_c, out_c, kernel_size, demodulate):
    """``pipeline_fused``'s up-dconv (JAX package :329-361): one 2x2 conv
    of 4O phase channels at the input resolution, interleaved to the
    (2H+1, 2W+1) map of the seq dconv; the seq blur follows."""
    if kernel_size != 3:
        raise ValueError(f"the subpixel up-conv takes 3x3, got {kernel_size}")
    scale = 1.0 / math.sqrt(in_c * kernel_size ** 2)

    def fn(params, d: DataBag) -> DataBag:
        w = _one_weight(params["weight"]) * scale
        kconv = _subpixel3_kernel(torch.flip(w, (-2, -1)), out_c, in_c)
        ph = tiered(F.conv2d, d["fmap"], kconv, padding=1)  # (B,4O,h+1,w+1)
        if demodulate:
            ph = ph * _demod(w, d["style"]).repeat(1, 4)[:, :, None, None]
        b, _, hp, wp = ph.shape
        t = ph.reshape(b, 2, 2, out_c, hp, wp).permute(0, 3, 4, 1, 5, 2)
        t = t.reshape(b, out_c, 2 * hp, 2 * wp)
        return DataBag(d, fmap=t[:, :, :2 * hp - 1, :2 * wp - 1].contiguous())
    return fn


# ---------------------------------------------------------------------------
# The s2d tail (JAX package :365-531): an s2d map is (B, 4C, H/2, W/2), its
# channel 4-block p = 2 * row parity + column parity, phase-major
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _s2d_placement() -> np.ndarray:
    """(p, q, t, d) one-hot: 3x3 tap d of output phase p reads input phase
    q of the s2d block at offset t - 1 (p + d - 1 == 2 (t - 1) + q)."""
    a = np.zeros((2, 2, 3, 3), np.float32)
    for p in range(2):
        for d in range(3):
            r = p + d - 1
            q = r % 2
            a[p, q, (r - q) // 2 + 1, d] = 1.0
    return a


def _s2d_of(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> s2d layout."""
    b, c, h, w = x.shape
    xs = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return xs.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def _d2s_of(y: torch.Tensor) -> torch.Tensor:
    """s2d layout -> NCHW."""
    b, c4, h2, w2 = y.shape
    ys = y.reshape(b, 2, 2, c4 // 4, h2, w2)
    return ys.permute(0, 3, 4, 1, 5, 2).reshape(b, c4 // 4, 2 * h2, 2 * w2)


def _s2d_kernel_transform(w: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, 3) -> (4O, 4I, 3, 3): the kernel of the same 3x3 SAME conv
    on s2d maps (each tap once, structural zeros elsewhere)."""
    a = torch.from_numpy(_s2d_placement()).to(w.device, w.dtype)
    o_c, i_c = w.shape[:2]
    wt = torch.einsum("pqtd,PQTD,oidD->pPoqQitT", a, a, w)
    return wt.reshape(4 * o_c, 4 * i_c, 3, 3)


def _conv3x3_s2d_pre(xs: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of an s2d map by a transformed kernel."""
    return tiered(F.conv2d, xs, wt, padding=1)


def _conv3x3_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of an NCHW map computed in the s2d layout: 2x the
    MACs of the plain conv with 4x the channels (JAX package :163-175)."""
    return _d2s_of(_conv3x3_s2d_pre(_s2d_of(x), _s2d_kernel_transform(w)))


def _composite_up_kernel(wf: torch.Tensor, blur_kern, out_c: int,
                         in_c: int) -> torch.Tensor:
    """(O, I, 3, 3) correlation taps and the 4x4 FIR -> (4O, I, 3, 3)
    per-phase taps of blur o convT over the undilated input (JAX package
    :378-397): the 6x6 full convolution of the taps with the flipped FIR
    (gain 4), output phase p taking rows 3 - p + 2 delta."""
    kf = torch.flip(torch.as_tensor(np.asarray(blur_kern, np.float32),
                                    device=wf.device), (0, 1)) * 4.0
    comp = wf.new_zeros((out_c, in_c, 6, 6))
    for by in range(4):
        for bx in range(4):
            comp[:, :, by:by + 3, bx:bx + 3] += wf * kf[by, bx]
    idx = torch.tensor([[1, 3, 5], [0, 2, 4]], device=wf.device)
    k = comp[:, :, idx, :][:, :, :, :, idx]        # (O, I, p, 3, P, 3)
    return k.permute(2, 4, 0, 1, 3, 5).reshape(4 * out_c, in_c, 3, 3)


def _make_fast_up_dconv_s2d(in_c, out_c, kernel_size, demodulate,
                            blur_kernel, from_s2d=False):
    """The tail's up-dconv and blur as one conv producing an s2d map
    (JAX package :432-460); `from_s2d`: the layer before ends in s2d."""
    if kernel_size != 3:
        raise ValueError(f"the s2d tail takes 3x3, got {kernel_size}")
    scale = 1.0 / math.sqrt(in_c * kernel_size ** 2)
    bk = make_kernel(blur_kernel)

    def fn(params, d: DataBag) -> DataBag:
        w = _one_weight(params["weight"]) * scale
        kconv = _composite_up_kernel(torch.flip(w, (-2, -1)), bk, out_c,
                                     in_c)
        x = _d2s_of(d["fmap"]) if from_s2d else d["fmap"]
        ph = tiered(F.conv2d, x, kconv, padding=1)     # (B, 4O, h, w)
        if demodulate:
            ph = ph * _demod(w, d["style"]).repeat(1, 4)[:, :, None, None]
        return DataBag(d, fmap=ph)
    return fn


def _make_dconv_s2d(in_c, out_c):
    """A 3x3 dconv on s2d maps, demodulated (JAX package :463-478)."""
    scale = 1.0 / math.sqrt(in_c * 9)

    def fn(params, d: DataBag) -> DataBag:
        w = _one_weight(params["weight"]) * scale
        out = _conv3x3_s2d_pre(d["fmap"], _s2d_kernel_transform(w))
        demod = _demod(w, d["style"])
        return DataBag(d, fmap=out * demod.repeat(1, 4)[:, :, None, None])
    return fn


def _apply_style_s2d(params, d: DataBag) -> DataBag:
    return DataBag(d, fmap=d["style"].repeat(1, 4)[:, :, None, None]
                   * d["fmap"])


def _apply_style_from_s2d(params, d: DataBag) -> DataBag:
    """adain of a layer that ends the tail: the s2d map back to NCHW, then
    the style; the layer's other stages are the seq ones."""
    return DataBag(d, fmap=d["style"][:, :, None, None] * _d2s_of(d["fmap"]))


def _noise_inject_s2d(params, d: DataBag) -> DataBag:
    x = d["fmap"]
    b, c4, h2, w2 = x.shape
    noise = d.get(noise_key(2 * h2, 2 * w2))
    if noise is None:
        noise = _reference_noise(b, 2 * h2, 2 * w2, x.device)
    ns = _s2d_of(noise).repeat_interleave(c4 // 4, dim=1)
    return DataBag(d, fmap=x + params["weight"] * ns)


def _fused_lrelu_s2d(params, d: DataBag) -> DataBag:
    return DataBag(d, fmap=fused_leaky_relu(d["fmap"],
                                            params["bias"].repeat(4)))


def _make_to_rgb_s2d(in_c, style_dim, skip, blur_kernel):
    """to_rgb of an s2d map; the RGB output is NCHW (JAX :510-532)."""
    mod_scale = 1.0 / math.sqrt(style_dim)
    conv_scale = 1.0 / math.sqrt(in_c)
    kern = make_kernel(blur_kernel)

    def fn(params, d: DataBag) -> DataBag:
        style = _equal_linear(params["modulation"], d["style"], mod_scale,
                              1.0, None)
        w = params["weight"][0, :, :, 0, 0] * conv_scale       # (3, C)
        x = d["fmap"] * style.repeat(1, 4)[:, :, None, None]
        b, _, h2, w2 = x.shape
        rgb = tiered(_rgb_product, x.reshape(b * 4, in_c, h2, w2), w)
        out = _d2s_of(rgb.reshape(b, 12, h2, w2)) + \
            params["bias"][None, :, None, None]
        if skip:
            prev = d["output"]
            if prev.shape[2:] != out.shape[2:]:
                prev = upsample2d(prev, kern, factor=2)
            out = out + prev
        return DataBag(d, output=out)
    return fn


def _noise_inject(params, d: DataBag) -> DataBag:
    x = d["fmap"]
    b, _, h, w = x.shape
    noise = d.get(noise_key(h, w))
    if noise is None:
        noise = _reference_noise(b, h, w, x.device)
    return DataBag(d, fmap=x + params["weight"] * noise)


def _fused_lrelu_stage(params, d: DataBag) -> DataBag:
    return DataBag(d, fmap=fused_leaky_relu(d["fmap"], params["bias"]))


def _make_upsample_output(blur_kernel):
    kern = make_kernel(blur_kernel)

    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, output=upsample2d(d["output"], kern, factor=2))
    return fn


def _make_to_rgb(in_c, style_dim, skip, blur_kernel):
    mod_scale = 1.0 / math.sqrt(style_dim)
    conv_scale = 1.0 / math.sqrt(in_c)  # 1x1 kernel, fan_in = in_c
    kern = make_kernel(blur_kernel)

    def fn(params, d: DataBag) -> DataBag:
        # modulated 1x1 conv without demodulation (models.py:628-655)
        style = _equal_linear(params["modulation"], d["style"], mod_scale,
                              1.0, None)                       # (B, C)
        w = params["weight"][0, :, :, 0, 0] * conv_scale       # (3, C)
        x = d["fmap"] * style[:, :, None, None]
        out = tiered(_rgb_product, x, w) + params["bias"][None, :, None, None]
        if skip:
            prev = d["output"]
            if prev.shape[2:] != out.shape[2:]:
                prev = upsample2d(prev, kern, factor=2)
            out = out + prev
        return DataBag(d, output=out)
    return fn


def _return_output(params, d: DataBag):
    return DataBag(d, output=d["output"])


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class SeqStyleGAN2:
    """Sequential StyleGAN2 (reference SeqStyleGAN2, models.py:31-141).

    Runs on ``device`` (default ``cuda``; raises if CUDA is absent and the
    caller did not pass ``device="cpu"``).  ``s2d_tail_max_c`` sets the
    widest layer of ``pipeline_fast``'s s2d tail (32 by default, as in
    the JAX package :591-602)."""

    # pipeline_fast's s2d tail: layers of at most s2d_tail_max_c channels
    # at an output resolution of at least s2d_tail_min_res
    s2d_tail_max_c = 32
    s2d_tail_min_res = 512

    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2,
                 blur_kernel=(1, 3, 3, 1), lr_mlp=0.01, truncation=1.0,
                 s2d_tail_max_c=None, device=None):
        self.device = resolve_device(device)
        apply_parity_tier()
        if s2d_tail_max_c is not None:
            self.s2d_tail_max_c = s2d_tail_max_c
        self.size = size
        self.style_dim = style_dim
        self.z_dim = style_dim
        self.n_mlp = n_mlp
        self.lr_mlp = lr_mlp
        self.truncation = truncation
        self.blur_kernel = list(blur_kernel)
        self.channels = CHANNELS(channel_multiplier)
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2

        stages: List[Stage] = [Stage("bag_in", _bag_in)]
        # name -> (kind, shapes...) read by init_params
        self._param_specs: Dict[str, tuple] = {}
        # pipeline_fast's and pipeline_fused's stages where they differ
        # from the seq pipeline's; the names of pipeline_fast's s2d tail
        self._fast_overrides: Dict[str, object] = {}
        self._fused_overrides: Dict[str, object] = {}
        self._s2d_names: set = set()
        self._s2d_tail = False

        stages.append(Stage("style.0", _pixel_norm_latent))
        for i in range(n_mlp):
            stages.append(Stage(f"style.{i + 1}",
                                _make_style_linear(style_dim, lr_mlp)))
            self._param_specs[f"style.{i + 1}"] = ("linear", style_dim,
                                                   style_dim, lr_mlp, 0.0)
        stages.append(Stage("latents",
                            _make_adjust_latent(self.n_latent, truncation)))
        self._param_specs["latents"] = ("latent_avg",)
        stages.append(Stage("noises", _noises_stage))
        self._param_specs["noises"] = ("noises", self.num_layers)
        stages.append(Stage("input", _constant_input))
        self._param_specs["input"] = ("const", self.channels[4])

        def styled_conv(prefix, in_c, out_c, upsample, res=None):
            """layerN.{conv|sconv}: mconv(seq) + noise + activate; `res` is
            the layer's output resolution."""
            sub = [Stage(f"{prefix}.mconv.modulation",
                         _make_modulation(style_dim)),
                   Stage(f"{prefix}.mconv.adain", _apply_style),
                   Stage(f"{prefix}.mconv.dconv",
                         _make_dconv(in_c, 3, upsample))]
            self._param_specs[f"{prefix}.mconv.modulation"] = (
                "linear", style_dim, in_c, 1.0, 1.0)
            self._param_specs[f"{prefix}.mconv.dconv"] = (
                "dconv", in_c, out_c, 3, upsample)
            if upsample:
                factor, k = 2, 3
                p = (len(self.blur_kernel) - factor) - (k - 1)
                pad = ((p + 1) // 2 + factor - 1, p // 2 + 1)
                sub.append(Stage(f"{prefix}.mconv.blur",
                                 _make_blur(self.blur_kernel, pad, factor)))
                self._fused_overrides[f"{prefix}.mconv.dconv"] = \
                    _make_subpixel_up_dconv(in_c, out_c, 3, True)
            sub.append(Stage(f"{prefix}.noise", _noise_inject))
            self._param_specs[f"{prefix}.noise"] = ("noise_w",)
            sub.append(Stage(f"{prefix}.activate", _fused_lrelu_stage))
            self._param_specs[f"{prefix}.activate"] = ("act_bias", out_c)
            # the s2d tail's composite kernel and K1 are specialised to
            # 4-tap FIRs, so their overrides install only for those (JAX
            # package :672-728)
            fir4 = len(self.blur_kernel) == 4
            narrow = out_c <= self.s2d_tail_max_c
            tail = {}
            if (upsample and narrow and fir4
                    and (res or 0) >= self.s2d_tail_min_res):
                if self._s2d_tail:       # the layer before ends in s2d
                    tail[f"{prefix}.mconv.adain"] = _apply_style_s2d
                tail.update({
                    f"{prefix}.mconv.dconv": _make_fast_up_dconv_s2d(
                        in_c, out_c, 3, True, self.blur_kernel,
                        from_s2d=self._s2d_tail),
                    f"{prefix}.mconv.blur": _pass_through,
                    f"{prefix}.noise": _noise_inject_s2d,
                    f"{prefix}.activate": _fused_lrelu_s2d})
                self._s2d_tail = True
            elif (not upsample and self._s2d_tail and narrow
                    and in_c <= self.s2d_tail_max_c):
                tail = {f"{prefix}.mconv.adain": _apply_style_s2d,
                        f"{prefix}.mconv.dconv": _make_dconv_s2d(in_c, out_c),
                        f"{prefix}.noise": _noise_inject_s2d,
                        f"{prefix}.activate": _fused_lrelu_s2d}
            elif self._s2d_tail:
                # a wider layer after the tail: its adain takes the map
                # back to NCHW and its other stages are the seq ones
                tail = {f"{prefix}.mconv.adain": _apply_style_from_s2d}
                self._s2d_tail = False
            elif upsample and fir4:
                self._fast_overrides.update({
                    f"{prefix}.mconv.dconv": _make_fused_upconv_dconv(
                        prefix, in_c, out_c, self.blur_kernel, res),
                    f"{prefix}.mconv.blur": _make_shape_dispatch_blur(
                        self.blur_kernel, pad, factor),
                    f"{prefix}.noise": _make_epilogue_skip(
                        _noise_inject, in_c, out_c, res),
                    f"{prefix}.activate": _make_epilogue_skip(
                        _fused_lrelu_stage, in_c, out_c, res)})
            self._fast_overrides.update(tail)
            self._s2d_names.update(tail)
            return sub

        def to_rgb(name, in_c, lat_idx, skip):
            self._param_specs[f"{name}.rgb"] = ("to_rgb", in_c)
            if self._s2d_tail:
                self._fast_overrides[f"{name}.rgb"] = _make_to_rgb_s2d(
                    in_c, style_dim, skip, self.blur_kernel)
                self._s2d_names.add(f"{name}.rgb")
            return [Stage(f"{name}.lat{lat_idx}", _make_pick_latent(lat_idx)),
                    Stage(f"{name}.rgb", _make_to_rgb(in_c, style_dim, skip,
                                                      self.blur_kernel))]

        # layer2 uses 'conv', layers >= 3 'sconv', as the reference names them
        c4 = self.channels[4]
        stages.append(Stage("layer2.lat0", _make_pick_latent(0)))
        stages.extend(styled_conv("layer2.conv", c4, c4, upsample=False))
        stages.extend(to_rgb("to_rgb1", c4, 1, skip=False))
        in_c = c4
        lat_i = 1
        for i in range(3, self.log_size + 1):
            out_c = self.channels[2 ** i]
            stages.append(Stage(f"up_rgb{i - 2}",
                                _make_upsample_output(self.blur_kernel)))
            stages.append(Stage(f"layer{lat_i + 2}.lat{lat_i}",
                                _make_pick_latent(lat_i)))
            stages.extend(styled_conv(f"layer{lat_i + 2}.sconv", in_c, out_c,
                                      upsample=True, res=2 ** i))
            stages.append(Stage(f"layer{lat_i + 3}.lat{lat_i + 1}",
                                _make_pick_latent(lat_i + 1)))
            stages.extend(styled_conv(f"layer{lat_i + 3}.sconv", out_c, out_c,
                                      upsample=False))
            stages.extend(to_rgb(f"to_rgb{i - 1}", out_c, lat_i + 2,
                                 skip=True))
            in_c = out_c
            lat_i += 2
        stages.append(Stage("output", _return_output))
        self.pipeline = StagePipeline(stages)
        # the sampling pipeline: the same stages and params, K1 at the
        # wide upsampling layers and the s2d tail; the seq pipeline stays
        # the surface that statistics and edits read
        self.pipeline_fast = StagePipeline([
            Stage(s.name, self._fast_overrides.get(s.name, s.fn))
            for s in stages])
        # the subpixel alternate: the seq stages with subpixel up-dconvs
        self.pipeline_fused = StagePipeline([
            Stage(s.name, self._fused_overrides.get(s.name, s.fn))
            for s in stages])

    # -- noise inputs -------------------------------------------------------
    def prepare_noise(self, batch: int) -> Dict[str, torch.Tensor]:
        """Per-resolution deterministic noise inputs for a full forward."""
        return {noise_key(2 ** i, 2 ** i):
                _reference_noise(batch, 2 ** i, 2 ** i, self.device)
                for i in range(2, self.log_size + 1)}

    # -- parameters ---------------------------------------------------------
    def init_params(self, seed: int = 0) -> Dict[str, dict]:
        """Random params from a seed, with the JAX package's distributions
        (:795): EqualLinear weight ~ N(0, 1/lr_mul^2), bias = bias_init;
        dconv, const and to_rgb weights ~ N(0, 1); noise weights and
        activate/to_rgb biases 0; latent_avg the scalar 0 (truncation off
        until a real latent_avg is loaded); noise buffers from
        RandomState(1).  Drawn on the CPU with a seeded torch.Generator,
        so every device gets the same numbers."""
        return params_to(self._cpu_params(seed), self.device)

    def _cpu_params(self, seed: int) -> Dict[str, dict]:
        gen = torch.Generator().manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32)

        params: Dict[str, dict] = {}
        for name, spec in self._param_specs.items():
            kind = spec[0]
            if kind == "linear":
                _, in_d, out_d, lr_mul, bias_init = spec
                params[name] = {"weight": normal(out_d, in_d) / lr_mul,
                                "bias": torch.full((out_d,), float(bias_init))}
            elif kind == "latent_avg":
                params[name] = {"latent_avg": torch.tensor(0.0)}
            elif kind == "noises":
                rng = np.random.RandomState(1)  # FixedNoiseBuffers seed 1
                bufs = {}
                for li in range(spec[1]):
                    res = 2 ** ((li + 5) // 2)
                    bufs[f"noise_{li}"] = torch.from_numpy(
                        rng.randn(1, 1, res, res).astype(np.float32))
                params[name] = bufs
            elif kind == "const":
                params[name] = {"input": normal(1, spec[1], 4, 4)}
            elif kind == "dconv":
                _, in_c, out_c, k = spec[:4]
                params[name] = {"weight": normal(1, out_c, in_c, k, k)}
            elif kind == "noise_w":
                params[name] = {"weight": torch.zeros(1)}
            elif kind == "act_bias":
                params[name] = {"bias": torch.zeros(spec[1])}
            elif kind == "to_rgb":
                in_c = spec[1]
                params[name] = {
                    "modulation": {"weight": normal(in_c, self.style_dim),
                                   "bias": torch.ones(in_c)},
                    "weight": normal(1, 3, in_c, 1, 1),
                    "bias": torch.zeros(3)}
            else:  # pragma: no cover
                raise ValueError(kind)
        return params

    # -- application --------------------------------------------------------
    def make_bag(self, z, noise: Optional[dict] = None) -> DataBag:
        """Input bag: latent + deterministic per-resolution noise inputs."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        bag = DataBag(latent=z)
        bag.update(noise if noise is not None
                   else self.prepare_noise(z.shape[0]))
        return bag

    def __call__(self, params, z, noise: Optional[dict] = None,
                 fused: bool = False, fast: bool = True) -> torch.Tensor:
        """z (B, style_dim) -> (B, H, W, 3) NHWC image.

        fast=True (the default) runs ``pipeline_fast``, fast=False the seq
        pipeline; fused=True the subpixel alternate ``pipeline_fused``
        (JAX package :855-869).  The three agree to fp32 tolerance."""
        pipe = (self.pipeline_fused if fused
                else self.pipeline_fast if fast else self.pipeline)
        with torch.no_grad():
            out = pipe(params, self.make_bag(z, noise))["output"]
        return out.permute(0, 2, 3, 1).contiguous()

    def apply_bag(self, params, bag: DataBag) -> DataBag:
        """The seq pipeline over a bag (``make_bag``'s, or any stage's)."""
        return self.pipeline(params, bag)


def params_to(params, device) -> Dict[str, dict]:
    """The params tree with every tensor moved to `device`."""
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Checkpoint conversion
# ---------------------------------------------------------------------------

# key prefixes that only rosinality's module paths have
_ROSINALITY_PREFIXES = ("conv1.", "convs.", "to_rgbs.")


def _seq_names_from_rosinality(sd: dict, latent_avg=None) -> dict:
    """Rename rosinality checkpoint keys to the seq stage names (JAX
    package :879-906; reference models.py:149-202).  A ``{"g_ema": sd,
    "latent_avg": ...}`` checkpoint is unwrapped first."""
    if len(sd) < 10 and "g_ema" in sd:
        latent_avg = sd.get("latent_avg", latent_avg)
        sd = sd["g_ema"]
    new = {}
    for k, v in sd.items():
        k = re.sub(r"^conv1\.conv\.", "layer2.conv.mconv.", k)
        k = re.sub(r"^conv1\.", "layer2.conv.", k)
        k = re.sub(r"^convs\.(\d+)\.conv",
                   lambda m: f"layer{int(m.group(1)) + 3}.sconv.mconv", k)
        k = re.sub(r"^convs\.(\d+)\.",
                   lambda m: f"layer{int(m.group(1)) + 3}.sconv.", k)
        k = re.sub(r"^to_rgb1\.(conv\.|bias$)",
                   lambda m: f"to_rgb1.rgb.{m.group(1)}", k)
        k = re.sub(r"^to_rgbs\.(\d+)\.upsample\.",
                   lambda m: f"up_rgb{int(m.group(1)) + 1}.", k)
        k = re.sub(r"^to_rgbs\.(\d+)\.",
                   lambda m: f"to_rgb{int(m.group(1)) + 2}.rgb.", k)
        k = re.sub(r"mconv\.weight$", "mconv.dconv.weight", k)
        new[k] = v
    if latent_avg is not None:
        new["latents.latent_avg"] = latent_avg
    return new


def _param_slot(k: str):
    """(stage, param path) of a seq-named checkpoint key in the params
    tree, or None for a fixed FIR buffer (recomputed from blur_kernel)."""
    if re.match(r"^style\.\d+\.(weight|bias)$", k):
        stage, pname = k.rsplit(".", 1)
        return stage, (pname,)
    if k == "latents.latent_avg":
        return "latents", ("latent_avg",)
    if re.match(r"^noises\.noise_\d+$", k):
        return "noises", (k.split(".")[1],)
    if k == "input.input":
        return "input", ("input",)
    if re.match(r".*\.mconv\.(modulation|dconv)\.(weight|bias)$", k):
        stage, pname = k.rsplit(".", 1)
        return stage, (pname,)
    if k.endswith(".mconv.weight"):
        # fast-mconv naming: the same tensor as the seq dconv weight
        return k[:-len(".weight")] + ".dconv", ("weight",)
    if k.endswith(".noise.weight") or k.endswith(".activate.bias"):
        stage, pname = k.rsplit(".", 1)
        return stage, (pname,)
    m = re.match(r"^(to_rgb\d+\.rgb)\.conv\.modulation\.(weight|bias)$", k)
    if m:
        return m.group(1), ("modulation", m.group(2))
    m = re.match(r"^(to_rgb\d+\.rgb)\.(conv\.weight|bias)$", k)
    if m:
        return m.group(1), (m.group(2).split(".")[-1],)
    if re.match(r"^up_rgb\d+\.kernel$", k) or k.endswith(".mconv.blur.kernel"):
        return None
    raise ValueError(f"unrecognized StyleGAN2 param {k!r}")


def params_from_state_dict(model: SeqStyleGAN2, sd: dict,
                           latent_avg=None) -> Dict[str, dict]:
    """The port's params (on ``model.device``) from a StyleGAN2 state dict
    in rosinality's naming (flat or ``{"g_ema": ..., "latent_avg": ...}``)
    or in the seq stage names; values numpy arrays or torch tensors (JAX
    package :909-996).  The const input and the noise buffers keep the
    checkpoint's NCHW layout.  Raises on a shape that differs from the
    model's and on a learned param the checkpoint lacks (only the noise
    buffers and latent_avg may be absent), never loading half a model.

    Unlike the JAX package's, which takes any dict with a ``style.`` key
    for seq-named (rosinality's mapping network has ``style.`` keys too),
    this one tells the two namings apart by rosinality's own module paths,
    so a flat rosinality dict loads as well as a wrapped one."""
    sd = dict(sd)
    if "g_ema" in sd or any(k.startswith(_ROSINALITY_PREFIXES) for k in sd):
        sd = _seq_names_from_rosinality(sd, latent_avg)
    elif latent_avg is not None:
        sd["latents.latent_avg"] = latent_avg

    template = model._cpu_params(seed=0)
    params = {stage: {k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in sub.items()}
              for stage, sub in template.items()}
    for k, v in sd.items():
        slot = _param_slot(k)
        if slot is None:
            continue
        stage, path = slot
        if stage not in params:
            raise ValueError(f"checkpoint param {k!r} has no stage "
                             f"{stage!r} in this model")
        holder = params[stage]
        for p in path[:-1]:
            holder = holder[p]
        want = holder.get(path[-1])
        if want is None:
            raise ValueError(f"checkpoint param {k!r} has no slot in this "
                             "model")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = torch.from_numpy(np.array(v, np.float32))
        # the noise strength (1,) and the to_rgb bias (1, 3, 1, 1) come in
        # other shapes of the same size; every other param keeps its shape
        if ((stage.endswith(".noise") and path == ("weight",))
                or (stage.startswith("to_rgb") and path == ("bias",))) and \
                arr.numel() == want.numel():
            arr = arr.reshape(want.shape)
        if path[-1] != "latent_avg" and tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint param {k!r} has shape "
                             f"{tuple(arr.shape)}, model expects "
                             f"{tuple(want.shape)}")
        holder[path[-1]] = arr

    missing = [name for (name, got), (_, orig) in zip(leaves(params),
                                                      leaves(template))
               if got is orig and "latent_avg" not in name
               and ".noise_" not in name]
    if missing:
        raise ValueError(
            f"checkpoint is missing {len(missing)} learned params "
            f"(e.g. {missing[:4]}); refusing a silent partial load")
    return params_to(params, model.device)


# ---------------------------------------------------------------------------
# Per-layer mixed precision (JAX package :994-1106)
# ---------------------------------------------------------------------------

def stage_resolution(name: str) -> Optional[int]:
    """The output resolution of a SeqStyleGAN2 stage, from its name
    (layerN / up_rgbN / to_rgbN); None for the stages without one (the
    style MLP, latents, noises, input, output)."""
    m = re.match(r"layer(\d+)\.", name)
    if m:
        n = int(m.group(1))
        return 4 if n == 2 else 2 ** ((n - 3) // 2 + 3)
    m = re.match(r"up_rgb(\d+)$", name)
    if m:
        return 2 ** (int(m.group(1)) + 2)
    m = re.match(r"to_rgb(\d+)\.", name)
    if m:
        n = int(m.group(1))
        return 4 if n == 1 else 2 ** (n + 1)
    return None


def mixed_precision_schedule(min_res: int = 128, tier: str = "default",
                             keep_rgb: bool = True,
                             pin: Tuple[str, ...] = ()
                             ) -> Callable[[str], Optional[str]]:
    """A schedule for ``ops.precision.set_precision_schedule``: the stages
    at output resolution >= `min_res` run at `tier`, the rest (the style
    MLP and the low-resolution trunk) at the global tier.  keep_rgb keeps
    the RGB skip chain (up_rgb / to_rgb) at the global tier; `pin` names
    stages (or dotted prefixes) kept there too.  Sampling only: the
    statistics, solves and the rewriter's renders suspend it."""
    def schedule(stage_name: str) -> Optional[str]:
        if keep_rgb and re.match(r"(up_rgb|to_rgb)\d+", stage_name):
            return None
        if any(stage_name == p or stage_name.startswith(p + ".")
               for p in pin):
            return None
        r = stage_resolution(stage_name)
        if r is not None and r >= min_res:
            return tier
        return None
    return schedule


# the JAX package's per-size choice (its v5e sweeps): size -> (min_res,
# pinned stages)
_RECOMMENDED = {256: (128, ()), 512: (256, ("layer13",)),
                1024: (512, ("layer15",))}


def recommended_precision_schedule(model) -> Callable[[str], Optional[str]]:
    """The JAX package's recommended schedule for ``model.size``: "default"
    from 128 at 256 px, from 256 with layer13 pinned at 512 px, from 512
    with layer15 pinned at 1024 px; any other size from its own
    resolution."""
    size = int(getattr(model, "size", 0)) or 1024
    min_res, pin = _RECOMMENDED.get(size, (size, ()))
    return mixed_precision_schedule(min_res, pin=pin)
