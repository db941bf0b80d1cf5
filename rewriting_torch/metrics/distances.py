"""The "undesired change" damage metric: the distance between clean and
edited renders outside the edited region.

Counterpart of the JAX package's ``metrics/distances.py``, after the
reference's metrics/distances.py (``compute_dl`` :96-136): for each image,
the source-labelled region of the clean model's segmentation is masked
out and the rest compared by masked LPIPS (spatial net-lin VGG16,
``metrics/lpips.py``) or by per-pixel L1.  Images are read as RGB by
``native.read_image_rgb``, as the JAX package reads them; LPIPS runs on
`device` (default ``cuda``), L1 on the host.

Command line (JAX package :139-160)::

    python3 -m rewriting_torch.metrics.distances --exp_name dome2spire
        [--results results/samples] [--metric l1|lpips|lpips_unmasked]
        [--num 10000]

reads ``<results>/<dataset>_clean``, its segmentations under
``<results>/seg/<dataset>_clean`` and ``<results>/<exp_name>``; LPIPS
weights come from ``$REWRITING_TPU_WEIGHTS`` (``default_lpips_params``).
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Sequence

import numpy as np
import torch

from ..models.zoo import load_state, weights_dir
from ..utils.device import resolve_device
from ..native import read_image_rgb
from ..utils.renormalize import renormalize
from ..utils.upsample import resize_bilinear
from .load_mask import load_mask_info
from .load_seg import load_seg_info_from_exp_name
from .lpips import LPIPS, init_params, params_from_torch
from .segio import load_seg


def _load_image(path: str) -> np.ndarray:
    """(H, W, 3) zc float32 image of an image file, read as RGB."""
    img = read_image_rgb(path).astype(np.float32) / 255.
    return renormalize(img, "pt", "zc")


def default_lpips_params(allow_random: bool = False):
    """LPIPS params from ``$REWRITING_TPU_WEIGHTS``: ``vgg16_features.pth``
    (torchvision's VGG16 features) and, if present, ``lpips_vgg_lins.pth``
    (the official calibrated heads; uniform heads otherwise).  Without the
    files: seeded weights if `allow_random` (a pipeline check; the
    distances are not LPIPS), else FileNotFoundError."""
    vgg_path = os.path.join(weights_dir(), "vgg16_features.pth")
    lin_path = os.path.join(weights_dir(), "lpips_vgg_lins.pth")
    if os.path.exists(vgg_path):
        return params_from_torch(
            load_state(vgg_path),
            load_state(lin_path) if os.path.exists(lin_path) else None)
    if allow_random:
        return init_params(0)
    raise FileNotFoundError(
        f"LPIPS weights not found ({vgg_path}); place a torchvision vgg16 "
        "features state dict there (and optionally lpips_vgg_lins.pth for "
        "the calibrated official lin heads), or pass allow_random=True for "
        "a pipeline check: the numbers are then NOT calibrated LPIPS.")


class PerceptualLoss:
    """The reference's LPIPS wrapper (metrics/distances.py:18-59):
    ``loss(im0, im1, w=None)`` on zc NCHW tensors.  With a mask `w` ((B,
    H, W) or (B, 1, H, W)) per-image scalars ``sum(map * w) / sum(w)``;
    without, the raw (B, 1, H, W) spatial distance map.  `use_gpu` and
    `precision` are accepted as the reference's; the distance runs in fp32
    on `device` (default ``cuda``)."""

    def __init__(self, net: str = "vgg", use_gpu: bool = False,
                 precision: str = "float", params=None,
                 allow_random: bool = False, device=None):
        if net != "vgg":
            raise NotImplementedError(
                f"net={net!r}: only the vgg backbone is built (the "
                "reference experiments use net-lin vgg)")
        if precision not in ("half", "float", "double"):
            raise ValueError(f"precision={precision!r}")
        self.model = LPIPS(params if params is not None
                           else default_lpips_params(allow_random),
                           device=device)

    def __call__(self, im0, im1, w=None):
        with torch.no_grad():
            if w is None:
                return self.model.distance_map(im0, im1)[:, None]
            return self.model(im0, im1, w)


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(
        images.transpose(0, 3, 1, 2)), device=device)


def compute_dl(before_imgs: str, before_seg: str, after_imgs: str,
               indices: Iterable[int], src: Sequence[int] = (1708,),
               srcc: int = 2, metric: str = "l1", lpips_model=None,
               lpips_params=None, batch_size: int = 100,
               mask_edits: bool = True, allow_random_lpips: bool = False,
               device=None):
    """(total, count) of the damage metric over the indexed images
    ``{i}.png`` of the two directories.

    `metric`: 'l1' (masked per-pixel L1, summed over the channels; count
    is the pixels kept), 'lpips' (masked spatial LPIPS per image; count is
    the images) or 'lpips_unmasked' (LPIPS over the whole image, the
    reference's --mask_lpips variant).  The mask drops the pixels whose
    segmentation channel `srcc` holds a label of `src`."""
    indices = list(indices)
    if metric not in ("l1", "lpips", "lpips_unmasked"):
        raise ValueError(f"metric {metric!r}")
    if metric.startswith("lpips") and lpips_model is None:
        lpips_model = LPIPS(lpips_params if lpips_params is not None
                            else default_lpips_params(allow_random_lpips),
                            device=resolve_device(device))
    total, count = 0.0, 0
    for lo in range(0, len(indices), batch_size):
        chunk = indices[lo:lo + batch_size]
        before = np.stack([_load_image(
            os.path.join(before_imgs, f"{i}.png")) for i in chunk])
        after = np.stack([_load_image(
            os.path.join(after_imgs, f"{i}.png")) for i in chunk])
        masks = np.ones(before.shape[:3], np.float32)
        if mask_edits:
            for j, i in enumerate(chunk):
                seg = load_seg(os.path.join(before_seg, str(i)))
                ch = seg[srcc] if seg.ndim == 3 else seg
                if ch.shape != masks.shape[1:]:
                    ch = (resize_bilinear(ch.astype(np.float32),
                                          masks.shape[1:]) > 0.5) * ch.max()
                keep = np.ones_like(ch, np.float32)
                for label in src:
                    keep = keep * (ch != label)
                masks[j] = keep
        if metric == "l1":
            diff = np.abs(after - before).sum(axis=-1)
            total += float((diff * masks).sum())
            count += int(masks.sum())
            continue
        dev = lpips_model.shift.device
        use_mask = (np.ones_like(masks) if metric == "lpips_unmasked"
                    else masks)
        with torch.no_grad():
            d = lpips_model(_nchw(before, dev), _nchw(after, dev),
                            torch.as_tensor(use_mask, device=dev))
        total += float(d.sum())
        count += len(chunk)
    return total, count


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp_name", required=True)
    ap.add_argument("--results", default="results/samples")
    ap.add_argument("--metric", default="l1",
                    choices=["l1", "lpips", "lpips_unmasked"])
    ap.add_argument("--num", type=int, default=10000)
    args = ap.parse_args(argv)
    _, dataset, _ = load_mask_info(args.exp_name)
    _, srcc, _, src, _ = load_seg_info_from_exp_name(args.exp_name)
    total, count = compute_dl(
        os.path.join(args.results, f"{dataset}_clean"),
        os.path.join(args.results, "seg", f"{dataset}_clean"),
        os.path.join(args.results, args.exp_name),
        range(args.num), src=src, srcc=srcc, metric=args.metric)
    print(f"after: {args.exp_name}")
    print(f"total={total} count={count} mean={total / max(count, 1)}")


if __name__ == "__main__":
    main()
