"""Progressive GAN generator as a stage pipeline.

Counterpart of the JAX package's ``models/proggan.py``
``ProgressiveGenerator`` (:202-332) and its converters (:335-425),
weight-compatible with the reference (utils/proggan.py:65-193): a flat
sequence of named blocks ``layer1 .. layerN, output_DxD``, each PixelNorm
-> (2x nearest upsample) -> conv (no bias) -> WScale (runtime weight
scale and bias) -> LeakyReLU(0.2), with a 1x1 output conv and a hardtanh.

Layout: activations are NCHW inside (the latent enters as a 1x1 map);
``__call__`` returns NHWC images, as the JAX package's does.  Conv weights
are OIHW, as in the reference and the JAX package, so a params tree
carries across unchanged (``convert.params_from_jax``).

A conv stage also takes a ``(G, O, I, k, k)`` weight: G edits of its
weight, one for each G-th of the batch, which is folded edit-major (G·B
rows); ``rewrite/multi.preview_edits`` renders many edits in one forward
that way.

``pipeline_fast`` (JAX package :107-262) has the seq stages and reads the
same params, except in the narrow high-resolution tail: an upsampling
block of at most 32 channels at 512 px or more, and the blocks after it
while they stay that narrow (the 512 and 1024 blocks of celebhq-1024),
fold the 2x nearest upsample into the conv (per-phase 3x3 taps over the
undilated input) and carry the map in the space-to-depth layout of
``models/stylegan2.py`` through pixel norm, conv and WScale; the output
1x1 conv takes it back to NCHW, and so does the pixel norm of a wider
block after the tail.  The same products, regrouped.  A model with no
such block (church-256) has ``pipeline_fast`` = ``pipeline``.

Every conv reads its stage's precision tier (``ops/precision.py``);
``stage_resolution``, ``mixed_precision_schedule`` and
``recommended_precision_schedule`` are the JAX package's (:427-472).
"""

from __future__ import annotations

import functools
import itertools
import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import DataBag, Stage, StagePipeline
from ..ops.grouped import folded, side_by_side
from ..ops.precision import apply_parity_tier, tiered
from ..utils.device import resolve_device
from .stylegan2 import (_d2s_of, _pass_through, _rgb_product,
                        _s2d_kernel_transform)

RESOLUTION_SIZES = {
    8: [512, 512, 512],
    16: [512, 512, 512, 512],
    32: [512, 512, 512, 512, 256],
    64: [512, 512, 512, 512, 256, 128],
    128: [512, 512, 512, 512, 256, 128, 64],
    256: [512, 512, 512, 512, 256, 128, 64, 32],
    1024: [512, 512, 512, 512, 512, 256, 128, 64, 32, 16],
}


# ---------------------------------------------------------------------------
# Stage functions
# ---------------------------------------------------------------------------

def _input_stage(params, d: DataBag) -> DataBag:
    z = d["latent"]
    # z (B, C) as a 1x1 feature map (reference proggan.py:126-129)
    return DataBag(d, fmap=z.reshape(z.shape[0], z.shape[1], 1, 1))


def _pixel_norm(params, d: DataBag) -> DataBag:
    x = d["fmap"]
    return DataBag(d, fmap=x * torch.rsqrt(
        torch.mean(x * x, dim=1, keepdim=True) + 1e-8))


def _upscale2x(params, d: DataBag) -> DataBag:
    return DataBag(d, fmap=F.interpolate(d["fmap"], scale_factor=2,
                                         mode="nearest"))


def conv2d_grouped(x: torch.Tensor, weight: torch.Tensor, padding: int,
                   groups: int = 1) -> torch.Tensor:
    """The block's conv of an NCHW map by an OIHW weight; by a ``(G, O, I,
    k, k)`` stack of G weights, over a batch folded edit-major (G·B rows),
    one grouped convolution (``ops/grouped.py``).  With ``groups`` = G the
    map is (B, G·I, H, W) and the weight (G·O, I, k, k) already."""
    if weight.dim() == 4:
        return tiered(F.conv2d, x, weight, padding=padding, groups=groups)
    g, o, i, kh, kw = weight.shape
    return folded(tiered(F.conv2d, side_by_side(x, g),
                         weight.reshape(g * o, i, kh, kw), padding=padding,
                         groups=g), g)


def _make_conv(padding: int):
    def conv(params, d: DataBag) -> DataBag:
        return DataBag(d, fmap=conv2d_grouped(d["fmap"], params["weight"],
                                              padding))
    return conv


def _make_wscale(scale: float):
    def wscale(params, d: DataBag) -> DataBag:
        # x*scale + b, scale = gain/sqrt(fan_in) (reference proggan.py:146-157)
        return DataBag(d, fmap=d["fmap"] * scale
                       + params["bias"][None, :, None, None])
    return wscale


def _leaky_relu(params, d: DataBag) -> DataBag:
    x = d["fmap"]
    return DataBag(d, fmap=torch.where(x >= 0, x, 0.2 * x))


def _hardtanh(params, d: DataBag) -> DataBag:
    return DataBag(d, fmap=torch.clamp(d["fmap"], -1.0, 1.0))


def _return_output(params, d: DataBag) -> DataBag:
    return DataBag(d, output=d["fmap"])


# ---------------------------------------------------------------------------
# The s2d tail (JAX package :97-199); s2d maps as in models/stylegan2.py
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _nearest_up_placement() -> np.ndarray:
    """(p, t, d): the 2x nearest upsample then a 3x3 SAME conv as a 3-tap
    correlation over the original grid for each output phase p (tap d
    lands on original row i + t - 1)."""
    b = np.zeros((2, 3, 3), np.float32)
    for p in range(2):
        for dd in range(3):
            r = p + dd - 1
            b[p, r // 2 + 1, dd] += 1.0
    return b


def _tail_weight(weight: torch.Tensor) -> torch.Tensor:
    if weight.dim() != 4:
        raise ValueError("pipeline_fast's s2d tail takes one conv weight, "
                         f"got shape {tuple(weight.shape)}; the seq "
                         "pipeline takes a stack")
    return weight


def _fold_up_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, 3) -> (4O, I, 3, 3) phase kernels of conv o nearest_up2x,
    phase-major."""
    b = torch.from_numpy(_nearest_up_placement()).to(w.device, w.dtype)
    o_c, i_c = w.shape[:2]
    k = torch.einsum("ptd,PTD,oidD->pPoitT", b, b, w)
    return k.reshape(4 * o_c, i_c, 3, 3)


def _pixel_norm_s2d(params, d: DataBag) -> DataBag:
    x = d["fmap"]
    b, c4, h, w = x.shape
    xp = x.reshape(b, 4, c4 // 4, h, w)
    n = xp * torch.rsqrt(torch.mean(xp * xp, dim=2, keepdim=True) + 1e-8)
    return DataBag(d, fmap=n.reshape(b, c4, h, w))


def _pixel_norm_from_s2d(params, d: DataBag) -> DataBag:
    """The pixel norm of a block that ends the tail: the s2d map back to
    NCHW first; the block's other stages are the seq ones."""
    return _pixel_norm(params, DataBag(d, fmap=_d2s_of(d["fmap"])))


def _make_fold_up_conv(from_s2d: bool):
    def fn(params, d: DataBag) -> DataBag:
        x = _d2s_of(d["fmap"]) if from_s2d else d["fmap"]
        k = _fold_up_kernel(_tail_weight(params["weight"]))
        return DataBag(d, fmap=tiered(F.conv2d, x, k, padding=1))
    return fn


def _conv_s2d_stage(params, d: DataBag) -> DataBag:
    wt = _s2d_kernel_transform(_tail_weight(params["weight"]))
    return DataBag(d, fmap=tiered(F.conv2d, d["fmap"], wt, padding=1))


def _make_wscale_s2d(scale: float):
    def fn(params, d: DataBag) -> DataBag:
        return DataBag(d, fmap=d["fmap"] * scale
                       + params["bias"].repeat(4)[None, :, None, None])
    return fn


def _out_conv1x1_s2d(params, d: DataBag) -> DataBag:
    """The 1x1 RGB conv of an s2d map; the output is NCHW."""
    x = d["fmap"]
    b, c4, h, w = x.shape
    wk = _tail_weight(params["weight"])[:, :, 0, 0]          # (3, I)
    rgb = tiered(_rgb_product, x.reshape(b * 4, c4 // 4, h, w), wk)
    return DataBag(d, fmap=_d2s_of(rgb.reshape(b, 12, h, w)))


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class ProgressiveGenerator:
    """ProgGAN; ``sizes`` = [z_dim, 4x4 depth, 8x8 depth, ...] (reference
    utils/proggan.py:66-124); output resolution 2 * 2**len(sizes).

    Runs on ``device`` (default ``cuda``; raises if CUDA is absent and the
    caller did not pass ``device="cpu"``)."""

    def __init__(self, resolution: Optional[int] = None,
                 sizes: Optional[Sequence[int]] = None,
                 output_tanh: bool = True, device=None):
        if (resolution is None) == (sizes is None):
            raise ValueError("give one of resolution and sizes")
        self.device = resolve_device(device)
        apply_parity_tier()
        if sizes is None:
            sizes = RESOLUTION_SIZES[resolution]
        self.sizes = list(sizes)
        self.z_dim = self.sizes[0]
        self.output_tanh = output_tanh

        stages: List[Stage] = [Stage("input", _input_stage)]
        self._conv_specs = {}  # name -> (in_c, out_c, kernel, padding, gain)
        # pipeline_fast's stages where they differ from the seq pipeline's
        self._fast_overrides: Dict[str, object] = {}
        self._s2d_tail = False
        cur_res = [4]

        def add_block(name, in_c, out_c, ksize, padding, gain, upsample):
            stages.append(Stage(f"{name}.norm", _pixel_norm))
            if upsample:
                stages.append(Stage(f"{name}.up", _upscale2x))
                cur_res[0] *= 2
            stages.append(Stage(f"{name}.conv", _make_conv(padding)))
            scale = gain / math.sqrt(in_c)
            stages.append(Stage(f"{name}.wscale", _make_wscale(scale)))
            self._conv_specs[name] = (in_c, out_c, ksize, padding, gain)
            # the s2d tail, with the JAX package's gate (:253-283)
            fast = self._fast_overrides
            if upsample and out_c <= 32 and cur_res[0] >= 512 and ksize == 3:
                if self._s2d_tail:
                    fast[f"{name}.norm"] = _pixel_norm_s2d
                fast[f"{name}.up"] = _pass_through
                fast[f"{name}.conv"] = _make_fold_up_conv(self._s2d_tail)
                fast[f"{name}.wscale"] = _make_wscale_s2d(scale)
                self._s2d_tail = True
            elif (not upsample and self._s2d_tail and ksize == 3
                    and out_c <= 32):
                fast[f"{name}.norm"] = _pixel_norm_s2d
                fast[f"{name}.conv"] = _conv_s2d_stage
                fast[f"{name}.wscale"] = _make_wscale_s2d(scale)
            elif self._s2d_tail and ksize == 1:
                fast[f"{name}.norm"] = _pixel_norm_s2d
                fast[f"{name}.conv"] = _out_conv1x1_s2d
            elif self._s2d_tail:
                # a wider block after the tail
                fast[f"{name}.norm"] = _pixel_norm_from_s2d
                self._s2d_tail = False

        layer_i = 0

        def lname():
            return "layer%d" % (layer_i + 1)

        add_block(lname(), self.sizes[0], self.sizes[1], 4, 3,
                  math.sqrt(2) / 4, upsample=False)
        stages.append(Stage(f"{lname()}.relu", _leaky_relu))
        layer_i += 1
        add_block(lname(), self.sizes[1], self.sizes[1], 3, 1,
                  math.sqrt(2) / 3, upsample=False)
        stages.append(Stage(f"{lname()}.relu", _leaky_relu))
        layer_i += 1
        for si, so in zip(self.sizes[1:-1], self.sizes[2:]):
            add_block(lname(), si, so, 3, 1, math.sqrt(2) / 3, upsample=True)
            stages.append(Stage(f"{lname()}.relu", _leaky_relu))
            layer_i += 1
            add_block(lname(), so, so, 3, 1, math.sqrt(2) / 3, upsample=False)
            stages.append(Stage(f"{lname()}.relu", _leaky_relu))
            layer_i += 1

        dim = 4 * (2 ** (layer_i // 2 - 1))
        self.resolution = dim
        out_name = "output_%dx%d" % (dim, dim)
        add_block(out_name, self.sizes[-1], 3, 1, 0, 1.0, upsample=False)
        if output_tanh:
            stages.append(Stage(f"{out_name}.clamp", _hardtanh))
        stages.append(Stage("output", _return_output))
        self.output_layer = out_name
        self.pipeline = StagePipeline(stages)
        self.pipeline_fast = StagePipeline([
            Stage(s.name, self._fast_overrides.get(s.name, s.fn))
            for s in stages]) if self._fast_overrides else self.pipeline

    # -- parameters ---------------------------------------------------------
    def init_params(self, seed: int = 0) -> Dict[str, dict]:
        """Random params from a seed, with the JAX package's distributions
        (:301): conv weights and WScale biases ~ N(0, 1).  Drawn on the
        CPU with a seeded torch.Generator, so every device gets the same
        numbers."""
        gen = torch.Generator().manual_seed(seed)
        params = {}
        for name, (in_c, out_c, k, _, _) in self._conv_specs.items():
            params[f"{name}.conv"] = {"weight": torch.randn(
                (out_c, in_c, k, k), generator=gen, dtype=torch.float32)}
            params[f"{name}.wscale"] = {"bias": torch.randn(
                (out_c,), generator=gen, dtype=torch.float32)}
        return {stage: {k: v.to(self.device) for k, v in sub.items()}
                for stage, sub in params.items()}

    # -- application --------------------------------------------------------
    def make_bag(self, z) -> DataBag:
        """Input bag for a (B, z_dim) latent batch."""
        return DataBag(latent=torch.as_tensor(z, dtype=torch.float32,
                                              device=self.device))

    def __call__(self, params, z, fast: bool = True) -> torch.Tensor:
        """z (B, z_dim) -> (B, H, W, 3) NHWC image in [-1, 1]; ``fast``
        picks ``pipeline_fast`` (the s2d tail where it engages), else the
        seq ``pipeline``."""
        pipe = self.pipeline_fast if fast else self.pipeline
        with torch.no_grad():
            out = pipe(params, self.make_bag(z))["output"]
        return out.permute(0, 2, 3, 1).contiguous()

    def apply_bag(self, params, bag: DataBag) -> DataBag:
        return self.pipeline(params, bag)


# ---------------------------------------------------------------------------
# Checkpoint conversion
# ---------------------------------------------------------------------------

def sizes_from_state_dict(sd) -> List[int]:
    """[z_dim, depths...] of a reference-format state dict (reference
    utils/proggan.py:222-239)."""
    sizes = []
    for i in itertools.count():
        name = "layer%d.conv.weight" % (i + 1)
        if name not in sd:
            break
        w = sd[name]
        if i == 0:
            sizes.append(w.shape[1])
        if i % 2 == 0:
            sizes.append(w.shape[0])
    return sizes


def _tensor(val) -> torch.Tensor:
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return torch.from_numpy(np.array(val, np.float32))


def params_from_state_dict(sd, device=None) -> Dict[str, dict]:
    """The params tree, on ``device`` (default ``cuda``), of a reference
    state dict (``layerN.conv.weight``, ``layerN.wscale.b``,
    ``output_DxD.*``); values numpy arrays or tensors.  Weights stay
    OIHW."""
    device = resolve_device(device)
    params = {}
    for key, val in sd.items():
        if key.endswith(".conv.weight"):
            params[key[:-len(".weight")]] = {"weight": _tensor(val)}
        elif key.endswith(".wscale.b"):
            params[key[:-len(".b")]] = {"bias": _tensor(val)}
        else:
            raise ValueError(f"unrecognized ProgGAN param {key!r}")
    return {stage: {k: v.to(device) for k, v in sub.items()}
            for stage, sub in params.items()}


def from_state_dict(sd, device=None) -> "tuple[ProgressiveGenerator, dict]":
    """(model, params) of a reference-format state dict, on ``device``."""
    model = ProgressiveGenerator(sizes=sizes_from_state_dict(sd),
                                 device=device)
    return model, params_from_state_dict(sd, model.device)


def state_dict_from_tf_parameters(params) -> dict:
    """The reference-format state dict (numpy) of the original TF ProgGAN
    variables (``{'4x4/Dense/weight': array, ...}``): the dense layer as a
    4x4 conv, the transposed convs flipped, the axes permuted (reference
    proggan.py:242-295)."""
    params = {k: np.asarray(v) for k, v in params.items()}
    result = {}
    i = 0
    for i in itertools.count():
        res = 4 * (2 ** (i // 2))
        tf_name = "%dx%d/%s" % (res, res,
                                "Dense" if i == 0 else "Conv" if i == 1
                                else "Conv0_up" if i % 2 == 0 else "Conv1")
        pt_name = "layer%d" % (i + 1)
        if f"{tf_name}/weight" not in params:
            break
        w = params[f"{tf_name}/weight"]
        if i == 0:
            # dense -> 4x4 conv: (in, out*16) -> (out, in, 4, 4) flipped
            w = w.reshape(w.shape[0], w.shape[1] // 16, 4, 4)
            w = w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1]
        elif i % 2 == 0:
            # transposed conv -> conv: permute and flip
            w = w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        else:
            w = w.transpose(3, 2, 0, 1)
        result[f"{pt_name}.conv.weight"] = np.ascontiguousarray(
            w, dtype=np.float32)
        result[f"{pt_name}.wscale.b"] = np.asarray(
            params[f"{tf_name}/bias"], np.float32)
    i -= 1
    res = 4 * (2 ** (i // 2))
    out_name = "output_%dx%d" % (res, res)
    result[f"{out_name}.conv.weight"] = np.ascontiguousarray(
        np.asarray(params["ToRGB_lod0/weight"]).transpose(3, 2, 0, 1),
        dtype=np.float32)
    result[f"{out_name}.wscale.b"] = np.asarray(params["ToRGB_lod0/bias"],
                                                np.float32)
    return result


def from_tf_parameters(params, device=None
                       ) -> "tuple[ProgressiveGenerator, dict]":
    """(model, params) of the original TF variables (reference
    proggan.py:200-208)."""
    return from_state_dict(state_dict_from_tf_parameters(params), device)


# ---------------------------------------------------------------------------
# Per-layer mixed precision (JAX package :427-472)
# ---------------------------------------------------------------------------

def stage_resolution(name: str) -> Optional[int]:
    """The output resolution of a ProgressiveGenerator stage, from its
    name (layerN.* / output_DxD.*); None for input and output."""
    m = re.match(r"layer(\d+)\.", name)
    if m:
        n = int(m.group(1))
        return 4 if n <= 2 else 2 ** ((n - 3) // 2 + 3)
    m = re.match(r"output_(\d+)x", name)
    if m:
        return int(m.group(1))
    return None


def mixed_precision_schedule(min_res: int = 128, tier: str = "default",
                             keep_rgb: bool = True
                             ) -> Callable[[str], Optional[str]]:
    """The stages at output resolution >= `min_res` run at `tier`, the
    rest at the global tier; keep_rgb keeps the output_DxD block there
    (its rounding goes straight into the image).  Sampling only."""
    def schedule(stage_name: str) -> Optional[str]:
        if keep_rgb and stage_name.startswith("output_"):
            return None
        r = stage_resolution(stage_name)
        if r is not None and r >= min_res:
            return tier
        return None
    return schedule


def recommended_precision_schedule(model) -> Callable[[str], Optional[str]]:
    """The JAX package's ProgGAN choice at every size: "default" from
    16 px, the output block kept at the global tier."""
    del model
    return mixed_precision_schedule(16)
