"""Write the JPEG fixtures of ``tests/data/jpeg/``: each ``<name>.jpg``
written by PIL from seeded numpy content, and beside it PIL's decode of
that JPEG as ``<name>.png``, so that a machine without PIL can hold the
port's JPEG decoder to PIL's pixels (``chip_smoke.py`` phase 39).  The
twins are written by the port's encoder (``renormalize.encode_png``, rows
"up"-filtered), which the port's PNG reader decodes without the per-pixel
loop that PIL's Paeth-filtered rows cost it.  Two files have no twin:
``truncated.jpg`` (the baseline fixture cut in half) and ``cmyk.jpg`` (a
four-component Adobe JPEG), which the port must refuse.

    python3 scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

Needs PIL and numpy; rewrites every fixture (the JPEG bytes depend on the
libjpeg PIL was built with, so run it only to change the set).
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (height, width, grey, PIL save options)
FIXTURES = {
    "baseline_420_q75_256": (256, 256, False, {"quality": 75}),
    "progressive_420_q90_256": (256, 256, False,
                                {"quality": 90, "progressive": True}),
    "restart_420_q85_256": (256, 256, False,
                            {"quality": 85, "restart_marker_blocks": 7}),
    "optimized_422_q95_256": (256, 256, False,
                              {"quality": 95, "subsampling": 1,
                               "optimize": True}),
    "full_444_q100_256": (256, 256, False,
                          {"quality": 100, "subsampling": 0}),
    "rgb_444_q90_256": (256, 256, False,
                        {"quality": 90, "subsampling": 0, "keep_rgb": True}),
    "grey_q75_256": (256, 256, True, {"quality": 75}),
    "odd_420_q75_131x257": (131, 257, False, {"quality": 75}),
    "progressive_444_q80_17x33": (17, 33, False,
                                  {"quality": 80, "subsampling": 0,
                                   "progressive": True}),
}


def content(seed: int, h: int, w: int) -> np.ndarray:
    """A photo-like (h, w, 3) uint8 image: smooth colour fields, hard
    edges of two stripe families and a disc, mild noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.02, 0.09, (3, 2))
    p = rng.uniform(0, 2 * np.pi, (3, 2))
    img = np.stack([128 + 90 * np.sin(x * f[c, 0] + p[c, 0])
                    * np.cos(y * f[c, 1] + p[c, 1]) for c in range(3)], -1)
    a, b = rng.randint(2, 6, 2)
    img[(a * x + b * y).astype(int) % 61 < 7] = rng.uniform(0, 255, 3)
    cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), min(h, w) / 4
    img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).round().astype(np.uint8)


def main(argv=None) -> int:
    import PIL.Image

    from rewriting_torch.utils.renormalize import encode_png

    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                    "jpeg"))
    args = args.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    total = 0

    def write(name: str, data: bytes) -> None:
        nonlocal total
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        total += len(data)
        print(f"{name}: {len(data)} bytes")

    for seed, (name, (h, w, grey, options)) in enumerate(FIXTURES.items()):
        im = PIL.Image.fromarray(content(seed, h, w))
        if grey:
            im = im.convert("L")
        buf = io.BytesIO()
        im.save(buf, "JPEG", **options)
        jpg = buf.getvalue()
        write(f"{name}.jpg", jpg)
        decoded = np.asarray(PIL.Image.open(io.BytesIO(jpg)))
        write(f"{name}.png", encode_png(decoded, level=9))
        if name == "baseline_420_q75_256":
            write("truncated.jpg", jpg[:len(jpg) // 2])
    buf = io.BytesIO()
    PIL.Image.fromarray(content(99, 32, 32)).convert("CMYK").save(
        buf, "JPEG", quality=75)
    write("cmyk.jpg", buf.getvalue())
    print(f"total {total} bytes in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
