"""LPIPS perceptual distance (net-lin VGG16, spatial) as a torch module
on NCHW tensors.

Counterpart of the JAX package's ``metrics/lpips.py``, the metric of the
reference's PerceptualLoss (metrics/distances.py:18-59): the images are
rescaled as LPIPS's ScalingLayer does, VGG16's relu1_2 .. relu5_3
features are taken, each unit-normalized along the channels, their
squared differences weighted by non-negative 1x1 heads, and each tap's
map bilinearly upsampled to the image (half-pixel centres, clamped edges:
``F.interpolate(align_corners=False)``, as ``jax.image.resize``) and
reduced by a mask or a mean.  The convolutions are cuDNN's (fp32, the
parity tier): no TPU kernel covered them.

Params are the JAX package's tree, of tensors: ``{"convs": [{"weight"
(O, I, 3, 3), "bias" (O,)} x 13], "lins": [{"weight" (C,)} x 5]}``.
``params_from_torch`` reads a torchvision ``vgg16().features`` state
dict and, through the validating ``lins_from_state_dict``, the official
LPIPS ``lin`` heads (uniform heads without one: distances then are not
calibrated LPIPS); ``init_params`` draws seeded weights at VGG16's
widths (14.7M parameters) for runs without the files.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

# VGG16 cfg 'D': conv widths, "M" a 2x2 max pool
_VGG_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# torchvision features indices of the convs
_CONV_IDXS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
# number of convs after whose relu a feature is tapped: relu1_2, 2_2,
# 3_3, 4_3, 5_3
_TAP_AFTER_CONV = [2, 4, 7, 10, 13]
# channels of the five taps
_TAP_CHANNELS = (64, 128, 256, 512, 512)

# LPIPS input scaling
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)


def init_params(seed: int = 0) -> Dict:
    """Seeded VGG16 convs (normal / sqrt(fan-in), zero bias) and uniform
    [0, 1) lin heads, on the CPU: a stand-in for the published weights."""
    gen = torch.Generator().manual_seed(seed)
    convs, in_c = [], 3
    for item in _VGG_PLAN:
        if item == "M":
            continue
        convs.append({"weight": torch.randn((item, in_c, 3, 3),
                                            generator=gen)
                      / math.sqrt(in_c * 9),
                      "bias": torch.zeros((item,))})
        in_c = item
    lins = [{"weight": torch.rand((c,), generator=gen)}
            for c in _TAP_CHANNELS]
    return {"convs": convs, "lins": lins}


def _as_tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


def lins_from_state_dict(lpips_sd) -> List[Dict]:
    """The five lin heads of an official LPIPS VGG checkpoint, in any of
    its three historical key layouts (``lin{i}.model.1.weight``,
    ``lin{i}.1.weight``, ``lin{i}.weight``).  Checks each head's size
    against VGG16's taps and that no tensor is left over."""
    sd = {k: _as_tensor(v) for k, v in dict(lpips_sd).items()}
    lins = []
    for i, c in enumerate(_TAP_CHANNELS):
        for key in (f"lin{i}.model.1.weight", f"lin{i}.1.weight",
                    f"lin{i}.weight"):
            if key in sd:
                w = sd.pop(key)
                break
        else:
            table = "\n".join(f"  {k}: {tuple(v.shape)}"
                              for k, v in sorted(sd.items()))
            raise KeyError(
                f"no lin{i} head found in LPIPS checkpoint; tensors "
                f"present:\n{table}")
        if w.numel() != c:
            raise ValueError(
                f"lin{i} head has {w.numel()} weights (shape "
                f"{tuple(w.shape)}), expected {c}: not a VGG16 LPIPS head "
                "checkpoint")
        lins.append({"weight": w.reshape(-1)})
    if sd:
        raise ValueError(f"unconsumed LPIPS tensors: {sorted(sd)}")
    return lins


def uniform_lins() -> List[Dict]:
    """Equal weight for every channel: distances monotone in perceptual
    difference but not calibrated LPIPS."""
    return [{"weight": torch.full((c,), 1.0 / c)} for c in _TAP_CHANNELS]


def params_from_torch(vgg_sd, lpips_sd=None) -> Dict:
    """Params from torchvision's ``vgg16().features`` state dict
    (``features.N.weight/bias``) and an LPIPS lin state dict (uniform
    heads if None)."""
    convs = [{"weight": _as_tensor(vgg_sd[f"features.{i}.weight"]),
              "bias": _as_tensor(vgg_sd[f"features.{i}.bias"])}
             for i in _CONV_IDXS]
    lins = (lins_from_state_dict(lpips_sd) if lpips_sd is not None
            else uniform_lins())
    return {"convs": convs, "lins": lins}


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=1, keepdim=True)
                           + eps)


class LPIPS(nn.Module):
    """``lpips(a, b[, mask])`` -> (B,) distances between zc [-1, 1] NCHW
    images; `mask` (B, H, W) or (B, 1, H, W) weights the spatial map (the
    reference's masked LPIPS), else its mean.  On `device` (default
    ``cuda``); `params` default to ``init_params(0)``."""

    def __init__(self, params: Optional[Dict] = None, spatial: bool = True,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        params = params if params is not None else init_params(0)
        self.spatial = spatial
        self.convs = nn.ModuleList()
        for p in params["convs"]:
            o, i = p["weight"].shape[:2]
            conv = nn.Conv2d(i, o, 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(p["weight"])
                conv.bias.copy_(p["bias"])
            self.convs.append(conv)
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(p["weight"]).clone())
             for p in params["lins"]])
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None,
                                                           None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None,
                                                           None])
        self.requires_grad_(False)
        self.to(device)

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The relu1_2 .. relu5_3 features of NCHW `x` (unscaled); those
        past a map too small to pool (under 2x2, as a small crop's) are
        left out, where the JAX package gives empty maps."""
        taps, n = [], 0
        for item in _VGG_PLAN:
            if item == "M":
                if min(x.shape[-2:]) < 2:
                    break
                x = F.max_pool2d(x, 2)
                continue
            x = F.relu(self.convs[n](x))
            n += 1
            if n in _TAP_AFTER_CONV:
                taps.append(x)
        return taps

    def _tap_maps(self, a, b):
        """Per tap, the (B, h, w) lin-weighted squared difference of the
        unit-normalized features."""
        taps_a = self.taps((a - self.shift) / self.scale)
        taps_b = self.taps((b - self.shift) / self.scale)
        for fa, fb, lin in zip(taps_a, taps_b, self.lins):
            diff = torch.square(_unit_normalize(fa) - _unit_normalize(fb))
            yield torch.einsum("bchw,c->bhw", diff, F.relu(lin))

    @staticmethod
    def _upsample(dist: torch.Tensor, size) -> torch.Tensor:
        return F.interpolate(dist[:, None], size=size, mode="bilinear",
                             align_corners=False, antialias=False)[:, 0]

    def distance_map(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The (B, H, W) spatial distance map: every tap's map upsampled
        to the image and summed."""
        size = tuple(a.shape[-2:])
        return sum(self._upsample(d, size) for d in self._tap_maps(a, b))

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        size = tuple(a.shape[-2:])
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=a.device).reshape(
                a.shape[0], *size)
        total = 0.0
        for dist in self._tap_maps(a, b):
            if self.spatial:
                dist = self._upsample(dist, size)
                if mask is not None:
                    dist = (torch.sum(dist * mask, dim=(1, 2))
                            / (torch.sum(mask, dim=(1, 2)) + 1e-10))
                else:
                    dist = torch.mean(dist, dim=(1, 2))
            else:
                dist = torch.mean(dist, dim=(1, 2))
            total = total + dist
        return total


def vgg16_taps(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """The relu1_2 .. relu5_3 features of NCHW `x` under `params` (a net
    built for the call on x's device; build an ``LPIPS`` once and call its
    ``taps`` to reuse it)."""
    return LPIPS(params, device=x.device).taps(x)
