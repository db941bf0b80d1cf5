"""Selection geometry on host arrays: bounding boxes, centred pasting,
crop alignment.

The port's own copy of the JAX package's ``rewrite/geometry.py`` (NHWC
numpy arrays; reference ganrewrite.py:767-803).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Box = Tuple[int, int, int, int]  # (top, left, bottom, right), b/r exclusive


def positive_bounding_box(mask) -> Box:
    """Tight bbox of mask > 0."""
    pos = np.asarray(mask) > 0
    if not pos.any():
        return 0, 0, 0, 0
    rows = np.nonzero(pos.any(axis=1))[0]
    cols = np.nonzero(pos.any(axis=0))[0]
    return int(rows[0]), int(cols[0]), int(rows[-1]) + 1, int(cols[-1]) + 1


def centered_location(mask) -> Tuple[int, int]:
    t, l, b, r = positive_bounding_box(mask)
    return (t + b) // 2, (l + r) // 2


def paste_clip_at_center(source, clip, center, area=None):
    """Paste `clip` (B, h, w, C) into `source` (B, H, W, C) centred at
    `center`, clamped in bounds, optionally alpha-blended by `area`.
    Returns (pasted, (t, l, b, r))."""
    source = np.asarray(source)
    clip = np.asarray(clip)
    target = source.copy()
    (h, w), (H, W) = clip.shape[1:3], source.shape[1:3]
    t = max(0, min(H - h, center[0] - h // 2))
    l = max(0, min(W - w, center[1] - w // 2))
    b, r = t + h, l + w
    if area is None:
        target[:, t:b, l:r, :] = clip
    else:
        a = np.asarray(area, np.float32)[None, :, :, None]
        target[:, t:b, l:r, :] = (1 - a) * target[:, t:b, l:r, :] + a * clip
    return target, (t, l, b, r)


def crop_clip_to_bounds(source, target, bounds: Box):
    """Crop the (possibly lower-resolution) source map and the target map
    to the paste bounds, keeping their integer resolution ratio.
    Returns (src_crop, tgt_crop, src_bounds, tgt_bounds)."""
    t, l, b, r = bounds
    vr = target.shape[1] // source.shape[1]
    hr = target.shape[2] // source.shape[2]
    st, sl = t // vr, l // hr
    sb, sr = -(-b // vr), -(-r // hr)   # ceil div
    tt, tl, tb, tr = st * vr, sl * hr, sb * vr, sr * hr
    return (source[:, st:sb, sl:sr, :], target[:, tt:tb, tl:tr, :],
            (st, sl, sb, sr), (tt, tl, tb, tr))
