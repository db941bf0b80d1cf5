"""Correspondence visualization + missing-result scanning for the NBB
baseline (reference baselines/neural_best_buddies/util/draw_correspondence.py
and get_missing.py).

The port's own copy of the JAX package's ``baselines/nbbviz.py``; the
PNGs are written by the port's PIL-free encoder (``utils/imgsave``).

Drawing is plain numpy on (H, W, 3) uint8 arrays: squares at coarse
pyramid levels, filled circles at mid levels, single dots at the finest
(reference draw_correspondence.py:77-86)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.imgsave import save_png

_BASE_COLORS = np.array([
    [255, 0, 0],
    [0, 255, 0],
    [0, 0, 255],
    [128, 128, 0],
    [0, 128, 128],
], np.uint8)


def color_map(i: int) -> np.ndarray:
    """Fixed palette for the first five points, then seeded-random colors
    (reference color_map, draw_correspondence.py:10-22, which uses
    unseeded randint — seeded here so renders are reproducible)."""
    if i < len(_BASE_COLORS):
        return _BASE_COLORS[i]
    return np.random.RandomState(i).randint(0, 256, 3).astype(np.uint8)


def draw_square(image: np.ndarray, center: Sequence[int], color,
                radius: int = 2) -> np.ndarray:
    """Hollow square outline of half-width `radius` around center (y, x)
    (reference draw_square, draw_correspondence.py:24-33)."""
    out = np.array(image, np.uint8, copy=True)
    h, w = out.shape[:2]
    y, x = int(center[0]), int(center[1])
    y0, y1 = y - radius, y + radius
    x0, x1 = x - radius, x + radius
    xs = np.clip(np.arange(x0, x1 + 1), 0, w - 1)
    ys = np.clip(np.arange(y0, y1 + 1), 0, h - 1)
    for yy in (y0, y1):
        if 0 <= yy < h:
            out[yy, xs] = color
    for xx in (x0, x1):
        if 0 <= xx < w:
            out[ys, xx] = color
    return out


def draw_dot(image: np.ndarray, center: Sequence[int], color) -> np.ndarray:
    """Single-pixel mark (reference draw_dots, draw_correspondence.py:35-37)."""
    out = np.array(image, np.uint8, copy=True)
    h, w = out.shape[:2]
    y = int(np.clip(center[0], 0, h - 1))
    x = int(np.clip(center[1], 0, w - 1))
    out[y, x] = color
    return out


def draw_circle(image: np.ndarray, center: Sequence[int], color,
                radius: int = 4,
                border_color=(255, 255, 255)) -> np.ndarray:
    """Filled disc with a contrasting 1px border (reference draw_circle,
    draw_correspondence.py:39-58, which hand-rasterizes the same shape)."""
    out = np.array(image, np.uint8, copy=True)
    h, w = out.shape[:2]
    cy, cx = int(center[0]), int(center[1])
    yy, xx = np.ogrid[:h, :w]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    out[d2 <= (radius - 1) ** 2] = color
    out[(d2 > (radius - 1) ** 2) & (d2 <= radius ** 2)] = border_color
    return out


def draw_points(image: np.ndarray, points: Sequence[Sequence[int]],
                level: int = 0, radius: int = 2,
                unicolor: bool = False) -> np.ndarray:
    """Mark a point list on one image, with the reference's per-level mark
    shape: squares above level 2, circles at levels 1-2, dots at level 0
    (reference draw_points, draw_correspondence.py:60-75)."""
    out = np.array(image, np.uint8, copy=True)
    for i, pt in enumerate(points):
        color = color_map(0 if unicolor else i)
        if level > 2:
            out = draw_square(out, pt, color, radius=radius)
        elif level >= 1:
            out = draw_circle(out, pt, color)
        else:
            out = draw_dot(out, pt, color)
    return out


def draw_correspondence(image_a: np.ndarray, image_b: np.ndarray,
                        pairs: Sequence[Tuple[Sequence[int], Sequence[int]]],
                        level: int = 0, radius: int = 2
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Mark matched point pairs with matching colors on both images
    (reference draw_correspondence, draw_correspondence.py:77-91).
    `pairs` is the nbb.neural_best_buddies output format
    [((ya, xa), (yb, xb)), ...]."""
    marked_a = np.array(image_a, np.uint8, copy=True)
    marked_b = np.array(image_b, np.uint8, copy=True)
    for i, (pa, pb) in enumerate(pairs):
        color = color_map(i)
        if level < 3:
            marked_a = draw_circle(marked_a, pa, color)
            marked_b = draw_circle(marked_b, pb, color)
        else:
            marked_a = draw_square(marked_a, pa, color, radius=radius)
            marked_b = draw_square(marked_b, pb, color, radius=radius)
    return marked_a, marked_b


def save_correspondence(image_a, image_b, pairs, save_dir: str,
                        level: int = 0, name: str = "") -> None:
    """Write A_level_N{name}.png / B_level_N{name}.png like the reference
    (draw_correspondence.py:90-91)."""
    marked_a, marked_b = draw_correspondence(image_a, image_b, pairs,
                                             level=level)
    save_png(marked_a, os.path.join(save_dir, f"A_level_{level}{name}.png"))
    save_png(marked_b, os.path.join(save_dir, f"B_level_{level}{name}.png"))


def check_missing(src_root: str, results_root: str,
                  expect: str = "BtoA.npy",
                  limit: Optional[int] = 10000) -> List[int]:
    """Image numbers in src_root whose per-image result directory lacks
    the final artifact (reference get_missing.py:20-27: source files are
    named {basename}_{num} with a .png, .jpg, .jpeg or .webp extension,
    the port reading the PNG and JPEG ones; results live in
    {results_root}/{num}/).
    Feed the return value back through the batch script to redo only the
    missing work."""
    base = os.path.basename(os.path.normpath(src_root))
    nums = []
    for fn in os.listdir(src_root):
        stem, ext = os.path.splitext(fn)
        if ext.lower() not in (".png", ".jpg", ".jpeg", ".webp"):
            continue
        prefix = base + "_"
        if stem.startswith(prefix) and stem[len(prefix):].isdigit():
            nums.append(int(stem[len(prefix):]))
    if not nums:
        raise ValueError(
            f"no {base}_<num>.png images under {src_root} — the source "
            f"directory's basename must prefix its image files "
            f"(reference get_missing.py naming contract)")
    nums = sorted(nums)[:limit]
    return [n for n in nums
            if not os.path.exists(os.path.join(results_root, str(n), expect))]
