"""InceptionV3's pool3 features (2048) for FID, as a torch module on
NCHW tensors.

The port's counterpart of the JAX package's ``metrics/inception.py``: the
standard FID Inception (torchvision's layout with pytorch-fid's quirks:
the pool branches average without the padding, ``Mixed_7c`` max-pools
3x3 at stride 1), every BatchNorm folded into its conv.  The reference
ran TF1's Inception graph (reference metrics/fid.py:31-131).  Images are
(B, H, W, 3) in [-1, 1], or uint8 normalized on the device (x / 255 * 2 -
1), resized to 299 with plain bilinear (no antialiasing, as the JAX
package).  The convolutions are cuDNN's (fp32, the parity tier): no TPU
kernel covered them.

Params are the JAX package's tree, of tensors: ``{"Conv2d_1a_3x3":
{"weight" (O, I, kh, kw), "bias" (O,)}, "Mixed_5b": {"branch1x1": {...},
...}, ...}``.  ``params_from_torch_state_dict`` reads pytorch-fid's
``pt_inception-2015-12-05.pth``; ``state_dict_from_params`` writes params
back under its names (identity BatchNorms); ``init_params`` draws seeded
weights.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

BN_EPS = 1e-3  # pytorch-fid's BasicConv2d


def _conv_specs() -> Dict[str, tuple]:
    """(out, in, kh, kw) of each conv, by its dotted torchvision name."""
    specs = {}

    def add(name, o, i, k):
        kh, kw = (k, k) if isinstance(k, int) else k
        specs[name] = (o, i, kh, kw)

    add("Conv2d_1a_3x3", 32, 3, 3)
    add("Conv2d_2a_3x3", 32, 32, 3)
    add("Conv2d_2b_3x3", 64, 32, 3)
    add("Conv2d_3b_1x1", 80, 64, 1)
    add("Conv2d_4a_3x3", 192, 80, 3)
    in_c = 192
    for name, pf in [("Mixed_5b", 32), ("Mixed_5c", 64), ("Mixed_5d", 64)]:
        add(f"{name}.branch1x1", 64, in_c, 1)
        add(f"{name}.branch5x5_1", 48, in_c, 1)
        add(f"{name}.branch5x5_2", 64, 48, 5)
        add(f"{name}.branch3x3dbl_1", 64, in_c, 1)
        add(f"{name}.branch3x3dbl_2", 96, 64, 3)
        add(f"{name}.branch3x3dbl_3", 96, 96, 3)
        add(f"{name}.branch_pool", pf, in_c, 1)
        in_c = 64 + 64 + 96 + pf
    add("Mixed_6a.branch3x3", 384, in_c, 3)
    add("Mixed_6a.branch3x3dbl_1", 64, in_c, 1)
    add("Mixed_6a.branch3x3dbl_2", 96, 64, 3)
    add("Mixed_6a.branch3x3dbl_3", 96, 96, 3)
    in_c = 384 + 96 + in_c
    for name, c7 in [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)]:
        add(f"{name}.branch1x1", 192, in_c, 1)
        add(f"{name}.branch7x7_1", c7, in_c, 1)
        add(f"{name}.branch7x7_2", c7, c7, (1, 7))
        add(f"{name}.branch7x7_3", 192, c7, (7, 1))
        add(f"{name}.branch7x7dbl_1", c7, in_c, 1)
        add(f"{name}.branch7x7dbl_2", c7, c7, (7, 1))
        add(f"{name}.branch7x7dbl_3", c7, c7, (1, 7))
        add(f"{name}.branch7x7dbl_4", c7, c7, (7, 1))
        add(f"{name}.branch7x7dbl_5", 192, c7, (1, 7))
        add(f"{name}.branch_pool", 192, in_c, 1)
        in_c = 192 * 4
    add("Mixed_7a.branch3x3_1", 192, in_c, 1)
    add("Mixed_7a.branch3x3_2", 320, 192, 3)
    add("Mixed_7a.branch7x7x3_1", 192, in_c, 1)
    add("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7))
    add("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1))
    add("Mixed_7a.branch7x7x3_4", 192, 192, 3)
    in_c = 320 + 192 + in_c
    for name in ["Mixed_7b", "Mixed_7c"]:
        add(f"{name}.branch1x1", 320, in_c, 1)
        add(f"{name}.branch3x3_1", 384, in_c, 1)
        add(f"{name}.branch3x3_2a", 384, 384, (1, 3))
        add(f"{name}.branch3x3_2b", 384, 384, (3, 1))
        add(f"{name}.branch3x3dbl_1", 448, in_c, 1)
        add(f"{name}.branch3x3dbl_2", 384, 448, 3)
        add(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3))
        add(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1))
        add(f"{name}.branch_pool", 192, in_c, 1)
        in_c = 320 + 768 + 768 + 192
    return specs


CONV_SPECS = _conv_specs()


def _put(tree: Dict, dotted: str, leaf) -> None:
    node = tree
    parts = dotted.split(".")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = leaf


def _get(tree: Dict, dotted: str):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def init_params(seed: int = 0) -> Dict:
    """Seeded params (normal over sqrt(fan-in), zero bias) at InceptionV3's
    widths (21.8M parameters); CPU tensors.  Features of these are not
    FID's."""
    gen = torch.Generator().manual_seed(seed)
    params: Dict = {}
    for name, (o, i, kh, kw) in CONV_SPECS.items():
        _put(params, name, {
            "weight": torch.randn((o, i, kh, kw), generator=gen)
            / math.sqrt(i * kh * kw),
            "bias": torch.zeros((o,))})
    return params


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def params_from_torch_state_dict(sd) -> Dict:
    """Params of a torchvision or pytorch-fid InceptionV3 state dict, each
    BatchNorm folded into its conv: W' = W g / sqrt(var + eps), b' = beta -
    mean g / sqrt(var + eps).  Tensors other than the convs' and their
    BatchNorms' (the classifier) are not read."""
    out: Dict = {}
    for ck in [k for k in sd if k.endswith(".conv.weight")]:
        base = ck[:-len(".conv.weight")]
        scale = _np(sd[base + ".bn.weight"]) / np.sqrt(
            _np(sd[base + ".bn.running_var"]) + BN_EPS)
        w = _np(sd[ck]) * scale[:, None, None, None]
        b = _np(sd[base + ".bn.bias"]) - _np(sd[base + ".bn.running_mean"]) \
            * scale
        _put(out, base, {"weight": torch.tensor(w), "bias": torch.tensor(b)})
    return out


def state_dict_from_params(params: Dict) -> Dict[str, torch.Tensor]:
    """The params under pytorch-fid's names, each bias carried by an
    identity BatchNorm (running mean 0 and variance 1, weight sqrt(1 +
    eps), so that folding it gives the params back bit for bit); CPU
    tensors."""
    sd = {}
    for name in CONV_SPECS:
        leaf = _get(params, name)
        o = leaf["weight"].shape[0]
        ones = np.ones(o, np.float32)
        sd[f"{name}.conv.weight"] = leaf["weight"].detach().cpu().clone()
        sd[f"{name}.bn.weight"] = torch.from_numpy(np.sqrt(ones + BN_EPS))
        sd[f"{name}.bn.bias"] = leaf["bias"].detach().cpu().clone()
        sd[f"{name}.bn.running_mean"] = torch.zeros(o)
        sd[f"{name}.bn.running_var"] = torch.from_numpy(ones)
    return sd


class InceptionV3Features(nn.Module):
    """``net(images)``: (B, H, W, 3) images in [-1, 1] (or uint8) ->
    (B, 2048) pool3 features.  On `device` (default ``cuda``); `params`
    default to ``init_params(0)``."""

    def __init__(self, params: Optional[Dict] = None, resize_to: int = 299,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        params = params if params is not None else init_params(0)
        self.resize_to = resize_to
        self.convs = nn.ModuleDict()
        for name, (o, i, kh, kw) in CONV_SPECS.items():
            conv = nn.Conv2d(i, o, (kh, kw))
            leaf = _get(params, name)
            with torch.no_grad():
                conv.weight.copy_(torch.as_tensor(leaf["weight"]))
                conv.bias.copy_(torch.as_tensor(leaf["bias"]))
            self.convs[name.replace(".", "__")] = conv
        self.requires_grad_(False)
        self.to(device)

    def _c(self, x, name, stride=1, padding=0):
        conv = self.convs[name.replace(".", "__")]
        return F.relu(F.conv2d(x, conv.weight, conv.bias, stride, padding))

    @staticmethod
    def _avgpool(x):
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)

    def _mixed_a(self, x, n):
        b1 = self._c(x, f"{n}.branch1x1")
        b5 = self._c(self._c(x, f"{n}.branch5x5_1"), f"{n}.branch5x5_2",
                     padding=2)
        b3 = self._c(self._c(self._c(x, f"{n}.branch3x3dbl_1"),
                             f"{n}.branch3x3dbl_2", padding=1),
                     f"{n}.branch3x3dbl_3", padding=1)
        bp = self._c(self._avgpool(x), f"{n}.branch_pool")
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _mixed_b(self, x, n):
        b3 = self._c(x, f"{n}.branch3x3", stride=2)
        bd = self._c(self._c(self._c(x, f"{n}.branch3x3dbl_1"),
                             f"{n}.branch3x3dbl_2", padding=1),
                     f"{n}.branch3x3dbl_3", stride=2)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)

    def _mixed_c(self, x, n):
        b1 = self._c(x, f"{n}.branch1x1")
        b7 = self._c(self._c(self._c(x, f"{n}.branch7x7_1"),
                             f"{n}.branch7x7_2", padding=(0, 3)),
                     f"{n}.branch7x7_3", padding=(3, 0))
        bd = self._c(x, f"{n}.branch7x7dbl_1")
        for i, pad in ((2, (3, 0)), (3, (0, 3)), (4, (3, 0)), (5, (0, 3))):
            bd = self._c(bd, f"{n}.branch7x7dbl_{i}", padding=pad)
        bp = self._c(self._avgpool(x), f"{n}.branch_pool")
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _mixed_d(self, x, n):
        b3 = self._c(self._c(x, f"{n}.branch3x3_1"), f"{n}.branch3x3_2",
                     stride=2)
        b7 = self._c(self._c(self._c(x, f"{n}.branch7x7x3_1"),
                             f"{n}.branch7x7x3_2", padding=(0, 3)),
                     f"{n}.branch7x7x3_3", padding=(3, 0))
        b7 = self._c(b7, f"{n}.branch7x7x3_4", stride=2)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)

    def _mixed_e(self, x, n, pool):
        b1 = self._c(x, f"{n}.branch1x1")
        b3 = self._c(x, f"{n}.branch3x3_1")
        b3 = torch.cat([self._c(b3, f"{n}.branch3x3_2a", padding=(0, 1)),
                        self._c(b3, f"{n}.branch3x3_2b", padding=(1, 0))],
                       dim=1)
        bd = self._c(self._c(x, f"{n}.branch3x3dbl_1"),
                     f"{n}.branch3x3dbl_2", padding=1)
        bd = torch.cat([self._c(bd, f"{n}.branch3x3dbl_3a", padding=(0, 1)),
                        self._c(bd, f"{n}.branch3x3dbl_3b", padding=(1, 0))],
                       dim=1)
        # pytorch-fid's FIDInceptionE_2 max-pools in the pool branch
        pooled = F.max_pool2d(x, 3, 1, 1) if pool == "max" \
            else self._avgpool(x)
        bp = self._c(pooled, f"{n}.branch_pool")
        return torch.cat([b1, b3, bd, bp], dim=1)

    def forward(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.convs["Conv2d_1a_3x3"]
                                       .weight.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0 * 2.0 - 1.0
        x = x.float().permute(0, 3, 1, 2)
        if tuple(x.shape[-2:]) != (self.resize_to, self.resize_to):
            x = F.interpolate(x, size=(self.resize_to, self.resize_to),
                              mode="bilinear", align_corners=False,
                              antialias=False)
        x = self._c(x, "Conv2d_1a_3x3", stride=2)
        x = self._c(x, "Conv2d_2a_3x3")
        x = self._c(x, "Conv2d_2b_3x3", padding=1)
        x = F.max_pool2d(x, 3, 2)
        x = self._c(x, "Conv2d_3b_1x1")
        x = self._c(x, "Conv2d_4a_3x3")
        x = F.max_pool2d(x, 3, 2)
        for name in ["Mixed_5b", "Mixed_5c", "Mixed_5d"]:
            x = self._mixed_a(x, name)
        x = self._mixed_b(x, "Mixed_6a")
        for name in ["Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"]:
            x = self._mixed_c(x, name)
        x = self._mixed_d(x, "Mixed_7a")
        x = self._mixed_e(x, "Mixed_7b", "avg")
        x = self._mixed_e(x, "Mixed_7c", "max")
        return torch.mean(x, dim=(2, 3))
