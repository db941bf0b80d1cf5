"""Bilinear resize of feature maps onto image pixels.

The port's own copy of ``resize_bilinear`` from the JAX package's
``utils/upsample.py``, which is numpy only (reference utils/upsample.py):
half-pixel aligned, edge-clamped, with an optional per-axis (scale, offset)
map from the data grid to target pixels.  ``utils/imgviz`` resizes heatmaps
and masks with it; ``utils/renormalize.resize_bilinear`` is another
function, PIL's bilinear resize of images.  The conv-stack geometry and
``upsampler`` come with the slice that first calls them (dissection)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _axis_coords(target_n, data_n, scale=None, offset=None):
    if scale is None:
        # default: proportional stretch with half-pixel alignment
        scale = target_n / data_n
        offset = scale / 2.0 - 0.5
    # source coordinate of each target pixel
    return (np.arange(target_n) - offset) / scale


def resize_bilinear(data: np.ndarray, target_shape: Tuple[int, int],
                    scale_offset=None) -> np.ndarray:
    """Bilinear resize of (H, W) or (H, W, C) data to target_shape, with
    optional per-axis (scale, offset) mapping from data grid to target
    pixels (edge-clamped)."""
    data = np.asarray(data, np.float32)
    h, w = data.shape[:2]
    th, tw = target_shape
    if scale_offset is None:
        ys = _axis_coords(th, h)
        xs = _axis_coords(tw, w)
    else:
        (sy, oy), (sx, ox) = scale_offset
        ys = (np.arange(th) - oy) / sy
        xs = (np.arange(tw) - ox) / sx
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    if data.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = data[y0][:, x0]
    b = data[y0][:, x1]
    c = data[y1][:, x0]
    d = data[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)
