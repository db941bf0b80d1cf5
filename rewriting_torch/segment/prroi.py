"""Precise RoI Pooling (PrRoI, Jia et al. ECCV'18) as closed-form hat
integrals.

The port's counterpart of the JAX package's ``segment/prroi.py``; the
reference ran a CUDA extension for it (utils/upsegmodel/prroi_pool/src/
prroi_pooling_gpu_impl.cu), the JAX package and the port plain tensor code.
PrRoI averages the continuous bilinear interpolant of the feature map over
each bin.  Bilinear interpolation is a separable sum of unit hats, so the
bin integral factorizes into two constant matrices, one an axis:

    avg over [y0, y1] x [x0, x1] of f = (Wy F Wx^T) / area,
    Wy[i] = integral over [y0, y1] of the hat at grid point i.

Values outside the feature map count as zero, as in the CUDA kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _hat_integral_weights(n: int, lo: float, hi: float) -> np.ndarray:
    """The integral over [lo, hi] of the unit hat at each i in [0, n)."""
    w = np.zeros(n, np.float64)

    def antider(i, t):
        # the hat's antiderivative on each linear piece, clamped to support
        t = np.clip(t, i - 1.0, i + 1.0)
        if t <= i:
            u = t - (i - 1.0)
            return 0.5 * u * u
        u = t - i
        return 0.5 + u - 0.5 * u * u

    for i in range(n):
        a = max(lo, i - 1.0)
        b = min(hi, i + 1.0)
        if b > a:
            w[i] = antider(i, b) - antider(i, a)
    return w


def prroi_pool2d(features, rois, pooled_height: int, pooled_width: int,
                 spatial_scale: float = 1.0):
    """features (N, C, H, W); rois (R, 5) rows of (batch index, x0, y0, x1,
    y1) in input coordinates (reference prroi_pool/functional.py:71).
    Returns (R, C, pooled_height, pooled_width)."""
    features = torch.as_tensor(features)
    rois = np.asarray(rois, np.float32)
    h, w = features.shape[-2:]
    out = []
    for roi in rois:
        x0, y0, x1, y1 = roi[1:] * spatial_scale
        bin_h = (y1 - y0) / pooled_height
        bin_w = (x1 - x0) / pooled_width
        wy = np.stack([_hat_integral_weights(h, y0 + i * bin_h,
                                             y0 + (i + 1) * bin_h)
                       for i in range(pooled_height)])
        wx = np.stack([_hat_integral_weights(w, x0 + i * bin_w,
                                             x0 + (i + 1) * bin_w)
                       for i in range(pooled_width)])
        area = max(float(bin_h * bin_w), 1e-12)
        fmap = features[int(roi[0])].double()
        pooled = torch.einsum("oh,chw,pw->cop",
                              torch.as_tensor(wy, device=fmap.device), fmap,
                              torch.as_tensor(wx, device=fmap.device))
        out.append((pooled / area).to(features.dtype))
    return torch.stack(out)


@functools.lru_cache(maxsize=64)
def _full_image_weights(h: int, w: int, pooled: int):
    wy = np.stack([_hat_integral_weights(h, i * h / pooled,
                                         (i + 1) * h / pooled)
                   for i in range(pooled)]).astype(np.float32)
    wx = np.stack([_hat_integral_weights(w, i * w / pooled,
                                         (i + 1) * w / pooled)
                   for i in range(pooled)]).astype(np.float32)
    return wy, wx


def prroi_pool_full_image(x, pooled: int):
    """UPerNet's PPM use: the RoI is the whole (N, C, H, W) map, ((0, 0) to
    (W, H); reference upsegmodel/models.py:333-339), so the op is two
    constant matmuls; returns (N, C, pooled, pooled)."""
    h, w = x.shape[-2:]
    wy, wx = _full_image_weights(h, w, pooled)
    out = torch.einsum("oh,nchw->ncow", torch.as_tensor(wy, device=x.device),
                       x)
    out = torch.einsum("pw,ncow->ncop", torch.as_tensor(wx, device=x.device),
                       out)
    return out / ((h / pooled) * (w / pooled))
