"""Functional layers of the segmenters and metric networks, on NCHW
tensors (inference only: each BatchNorm is folded into its conv when a
checkpoint is converted).

The port's counterpart of the JAX package's ``segment/nn.py``.  A conv's
params are ``{"weight" (O, I/groups, kh, kw), "bias" (O,)}``, as there.
Resizes follow ``jax.image.resize``, which the JAX package calls:

- ``resize_bilinear(align_corners=False)`` is half-pixel bilinear that
  antialiases when it shrinks (a triangle filter widened by the factor,
  its weights renormalized at the edges): ``F.interpolate(...,
  antialias=True)``, which growing leaves equal to plain bilinear;
- ``resize_nearest`` takes source pixel ``floor((i + 0.5) * in / out)``
  (half-pixel centres: torch's ``"nearest-exact"``, not its
  ``"nearest"``), here as an index gather that keeps any dtype, with the
  float32 rounding of ``jax.image.resize(..., "nearest")`` as XLA compiles
  it: ``(i + 0.5) * c`` with the constant ``c = in * (1 / out)``.  At
  some sizes (256 -> 218, 30 -> 123) a plain ``(i + 0.5) * in / out``
  picks another pixel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv(x, p: Dict, stride: int = 1, padding=0, relu: bool = False,
         dilation: int = 1, groups: int = 1, relu6: bool = False):
    """conv2d of NCHW `x` with ``p["weight"]`` (and ``p["bias"]`` if
    present), then relu or relu6 if asked; `padding` an int or (ph, pw)."""
    out = F.conv2d(x, p["weight"], p.get("bias"), stride, padding, dilation,
                   groups)
    if relu6:
        return torch.clamp(out, 0.0, 6.0)
    return F.relu(out) if relu else out


def maxpool(x, k: int = 3, s: int = 2, p: int = 1):
    """Max pool with -inf padding."""
    return F.max_pool2d(x, k, s, p)


def global_avg_pool(x):
    return torch.mean(x, dim=(2, 3), keepdim=True)


def resize_bilinear(x, size: Tuple[int, int], align_corners: bool = False):
    """Bilinear resize of NCHW `x` to ``size = (H, W)``; half-pixel centres
    with an antialiasing shrink, or corners aligned."""
    size = tuple(int(s) for s in size)
    if align_corners:
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=True)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


def nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """The source index of each output sample: ``floor((i + 0.5) * n_in *
    (1 / n_out))`` in float32."""
    scale = float(np.float32(n_in) * (np.float32(1) / np.float32(n_out)))
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * scale
    return torch.floor(pos).long()


def resize_nearest(x, size: Tuple[int, int]):
    """Nearest resize of the last two axes of `x` (any dtype) to ``size =
    (H, W)``, half-pixel centres."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    ys = nearest_index(h, size[0], x.device)
    xs = nearest_index(w, size[1], x.device)
    return x.index_select(-2, ys).index_select(-1, xs)


def adaptive_avg_pool(x, size: Tuple[int, int]):
    """torch's AdaptiveAvgPool2d: integer bin boundaries, as the JAX
    package's weights give them (reference segmenter.py:268-271)."""
    return F.adaptive_avg_pool2d(x, tuple(int(s) for s in size))


# -- parameter init and conversion -------------------------------------------

def generator(seed) -> torch.Generator:
    """A CPU generator from a seed (or the generator itself): the seeded
    inits draw in one stream, network by network."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def init_conv(gen: torch.Generator, out_c: int, in_c: int, k,
              scale: Optional[float] = None) -> Dict:
    """Seeded conv params: normal weights over sqrt(fan-in) (or times
    `scale`), zero bias; CPU tensors."""
    kh, kw = (k, k) if isinstance(k, int) else k
    if scale is None:
        scale = 1.0 / math.sqrt(in_c * kh * kw)
    return {"weight": torch.randn((out_c, in_c, kh, kw), generator=gen)
            * scale,
            "bias": torch.zeros((out_c,))}


def _as_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def fold_bn(sd, conv_key: str, bn_prefix: Optional[str], eps: float = 1e-5
            ) -> Dict:
    """The conv at ``conv_key`` with the BatchNorm ``bn_prefix.{weight,
    bias,running_mean,running_var}`` folded in (``bn_prefix=None``: the
    conv as it is, a zero bias if it has none); CPU tensors.  `sd` holds
    tensors or numpy arrays."""
    w = _as_np(sd[conv_key + ".weight"])
    b = _as_np(sd[conv_key + ".bias"]) if conv_key + ".bias" in sd else \
        np.zeros(w.shape[0], np.float32)
    if bn_prefix is not None:
        g = _as_np(sd[bn_prefix + ".weight"])
        beta = _as_np(sd[bn_prefix + ".bias"])
        mean = _as_np(sd[bn_prefix + ".running_mean"])
        var = _as_np(sd[bn_prefix + ".running_var"])
        scale = g / np.sqrt(var + eps)
        w = w * scale[:, None, None, None]
        b = beta + (b - mean) * scale
    return {"weight": torch.tensor(w), "bias": torch.tensor(b)}


def unfold_bn(sd: Dict, conv_key: str, bn_prefix: Optional[str], p: Dict,
              eps: float = 1e-5) -> None:
    """Write conv params `p` into `sd` as ``fold_bn`` reads them: the conv
    at ``conv_key`` and an identity BatchNorm at `bn_prefix` carrying the
    bias (running mean 0 and variance 1, weight sqrt(1 + eps): it folds
    back bit for bit), or the conv with its bias where `bn_prefix` is
    None; CPU tensors."""
    sd[conv_key + ".weight"] = p["weight"].detach().cpu().clone()
    bias = p["bias"].detach().cpu().clone()
    if bn_prefix is None:
        sd[conv_key + ".bias"] = bias
        return
    ones = np.ones(bias.shape[0], np.float32)
    sd[bn_prefix + ".weight"] = torch.from_numpy(np.sqrt(ones + eps))
    sd[bn_prefix + ".bias"] = bias
    sd[bn_prefix + ".running_mean"] = torch.zeros(bias.shape[0])
    sd[bn_prefix + ".running_var"] = torch.from_numpy(ones)


# A layout lists a network's convs as (path in the params tree, conv key,
# BatchNorm prefix or None); an int in a path indexes a list.

def params_from_layout(sd, layout) -> Dict:
    """The params tree of a state dict, BatchNorms folded."""
    tree: Dict = {}
    for path, conv_key, bn_prefix in layout:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = fold_bn(sd, conv_key, bn_prefix)

    def listify(node):
        if not isinstance(node, dict) or "weight" in node:
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out
    return listify(tree)


def state_dict_from_layout(params: Dict, layout) -> Dict:
    """The inverse of ``params_from_layout``: identity BatchNorms."""
    sd: Dict = {}
    for path, conv_key, bn_prefix in layout:
        p = params
        for key in path:
            p = p[key]
        unfold_bn(sd, conv_key, bn_prefix, p)
    return sd
