"""StyleGAN2 generator as a stage pipeline: the seq pipeline and the
sampling pipeline ``pipeline_fast``.

Counterpart of the JAX package's ``models/stylegan2.py`` ``SeqStyleGAN2``
(:587-869), weight-compatible with the rosinality port.  The modulated
conv is split into modulation -> adain -> dconv -> blur so that the linear
conv (``dconv``) can be rewritten as a linear associative memory.  Stage
names mirror the reference module paths (``layer8.sconv.mconv.dconv``), so
saved edit requests and surgery code work unchanged.

``pipeline_fast``, the default of ``__call__``, has the same stages and
reads the same params; at an upsampling layer with a 4-tap FIR whose
shape passes K1's gate (``ops/upconv_blur.set_fused_upconv``, "off" by
default as in the JAX package) its dconv runs the fused up-conv + blur +
epilogue kernel (K1, ``ops/upconv_blur.py``) and its blur, noise and
activate stages pass the bag through (JAX package :237-308).  The
statistics and the edits run on ``pipeline``, whose stage boundaries they
read.

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
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import DataBag, Stage, StagePipeline
from ..ops import fused_leaky_relu, make_kernel, upsample2d
from ..ops.upfirdn2d import blur2d
from ..ops.precision import apply_parity_tier
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
    out = x @ (params["weight"] * scale).t()
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


def _make_dconv(in_c, kernel_size, upsample):
    scale = 1.0 / math.sqrt(in_c * kernel_size ** 2)

    def fn(params, d: DataBag) -> DataBag:
        w = params["weight"][0] * scale          # (O, I, kh, kw)
        x = d["fmap"]
        if upsample:
            # == the lhs-dilated conv with the flipped kernel and k-1
            # padding of the JAX package (:186-202); output 2H+1
            out = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        else:
            out = F.conv2d(x, w, padding=kernel_size // 2)
        # demod applied after the conv so the conv stays a plain linear map
        demod = _demod(w, d["style"])
        return DataBag(d, fmap=out * demod[:, :, None, None])
    return fn


def _demod(w, style):
    """rsqrt(sum_{I,kh,kw} (scale*W*style)^2 + 1e-8) per (B, O), from the
    scaled (O, I, kh, kw) weight."""
    w_sq = torch.sum(w * w, dim=(-2, -1))    # (O, I)
    return torch.rsqrt((style * style) @ w_sq.t() + 1e-8)


def _make_blur(blur_kernel, pad, upsample_factor):
    kern = make_kernel(blur_kernel)

    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, fmap=blur2d(d["fmap"], kern, pad, upsample_factor))
    return fn


def _make_fused_upconv_dconv(prefix, in_c, out_c, blur_kernel, res=None):
    """pipeline_fast's dconv at an upsampling layer (JAX package :237-282):
    where the gate passes for (in_c, out_c, res), dconv AND blur (and,
    with the epilogue, noise and activate too) in one pass of K1; else the
    seq dconv, and the stages after it run as in the seq pipeline.  `res`
    is the layer's output resolution.  Takes the FULL params
    (``_full_params``): the epilogue reads the noise and activate stages'
    parameters."""
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
        if not fused_epilogue_active(in_c, out_c, res):
            return DataBag(d, fmap=upconv_blur(x, wf, kf)
                           * demod[:, :, None, None])
        b, _, h, wd = x.shape
        noise = d.get(noise_key(2 * h, 2 * wd))
        if noise is None:
            noise = _reference_noise(b, 2 * h, 2 * wd, x.device)
        noise = params[f"{prefix}.noise"]["weight"] * noise
        bias = params[f"{prefix}.activate"]["bias"]
        return DataBag(d, fmap=upconv_blur(x, wf, kf, demod, noise, bias))
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
        out = torch.einsum("bchw,oc->bohw", x, w) + \
            params["bias"][None, :, None, None]
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
    caller did not pass ``device="cpu"``)."""

    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2,
                 blur_kernel=(1, 3, 3, 1), lr_mlp=0.01, truncation=1.0,
                 device=None):
        self.device = resolve_device(device)
        apply_parity_tier()
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
        # pipeline_fast's stages where they differ from the seq pipeline's
        self._fast_overrides: Dict[str, object] = {}

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
            sub.append(Stage(f"{prefix}.noise", _noise_inject))
            self._param_specs[f"{prefix}.noise"] = ("noise_w",)
            sub.append(Stage(f"{prefix}.activate", _fused_lrelu_stage))
            self._param_specs[f"{prefix}.activate"] = ("act_bias", out_c)
            # K1 is specialised to 4-tap FIRs, so the overrides install
            # only for those.  Where the JAX package's s2d tail engages
            # (<= 32 channels at >= 512, :672-690; not ported) the port
            # runs the exact seq stages.
            if (upsample and len(self.blur_kernel) == 4
                    and not (out_c <= 32 and (res or 0) >= 512)):
                self._fast_overrides.update({
                    f"{prefix}.mconv.dconv": _make_fused_upconv_dconv(
                        prefix, in_c, out_c, self.blur_kernel, res),
                    f"{prefix}.mconv.blur": _make_shape_dispatch_blur(
                        self.blur_kernel, pad, factor),
                    f"{prefix}.noise": _make_epilogue_skip(
                        _noise_inject, in_c, out_c, res),
                    f"{prefix}.activate": _make_epilogue_skip(
                        _fused_lrelu_stage, in_c, out_c, res)})
            return sub

        def to_rgb(name, in_c, lat_idx, skip):
            self._param_specs[f"{name}.rgb"] = ("to_rgb", in_c)
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
        # upsampling layers; the seq pipeline stays the surface that
        # statistics and edits read
        self.pipeline_fast = StagePipeline([
            Stage(s.name, self._fast_overrides.get(s.name, s.fn))
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
        return params_to(params, self.device)

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
        pipeline; the two agree to fp32 tolerance.  fused=True, the JAX
        package's subpixel alternate (:329-370), is not ported."""
        if fused:
            raise NotImplementedError(
                "the subpixel pipeline (fused=True) is not ported")
        pipe = self.pipeline_fast if fast else self.pipeline
        with torch.no_grad():
            out = pipe(params, self.make_bag(z, noise))["output"]
        return out.permute(0, 2, 3, 1).contiguous()


def params_to(params, device) -> Dict[str, dict]:
    """The params tree with every tensor moved to `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)
