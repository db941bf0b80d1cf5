"""Per-layer patch-FID sweep (reference metrics/patch_metrics/
fid_image_patches.py + fid_patches.sh): sample image patches corresponding
to fixed-size crops of a layer's activations, from the clean vs the edited
model, and FID them, localizing how much an edit perturbs each layer.

The port's counterpart of the JAX package's ``metrics/patch_fid.py``, over
``SeqStyleGanRewriter.sample_image_patch`` and ``fid.compute_fid``.

Command line (runs on the card)::

    python3 -m rewriting_torch.metrics.patch_fid --mask dome2tree
        [--crops 1 2 4 ...] [--n 1000] [--out results/patch_fid.json]
"""

from __future__ import annotations

import os
import random
from typing import Optional, Sequence

import numpy as np

from ..utils import pbar
from . import fid as fid_mod


def sample_patches(gw, crop_size: int, n: int, seed: int = 1,
                   batch_indices: Optional[Sequence[int]] = None
                   ) -> np.ndarray:
    """n patch images from the rewriter's current params
    (reference fid_image_patches.py:29-57 uses random crops per image)."""
    rng = random.Random(seed)
    h = gw.k_shape[1]
    out = []
    idxs = batch_indices if batch_indices is not None else range(n)
    for i in pbar.pbar(list(idxs)[:n], desc=f"patches {crop_size}"):
        xi = rng.randint(0, h - crop_size)
        yi = rng.randint(0, h - crop_size)
        img = gw.sample_image_patch(gw.get_z(i % len(gw.zds)), crop_size,
                                    seed=(xi, yi))
        out.append(img[0].cpu().numpy())
    return np.stack(out)


def patch_fid_sweep(gw_clean, gw_edited, crop_sizes: Sequence[int],
                    n: int = 1000, feature_fn=None) -> dict:
    """{crop_size: FID(clean patches, edited patches)}."""
    results = {}
    for cs in crop_sizes:
        a = sample_patches(gw_clean, cs, n, seed=1)
        b = sample_patches(gw_edited, cs, n, seed=1)
        results[cs] = fid_mod.compute_fid(a, b, feature_fn=feature_fn)
        pbar.print(f"crop {cs}: FID {results[cs]:.3f}")
    return results


def main(argv=None) -> None:
    import argparse
    import json
    ap = argparse.ArgumentParser("per-layer patch-FID sweep")
    ap.add_argument("--mask", required=True,
                    help="published edit name (load_mask registry)")
    ap.add_argument("--crops", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 64, 128])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--out", default="results/patch_fid.json")
    args = ap.parse_args(argv)
    from ..models.zoo import load_seq_stylegan
    from ..rewrite import SeqStyleGanRewriter
    from ..utils.zdataset import z_dataset_for_model
    from .load_mask import load_mask_info
    mask_path, dataset, layernum = load_mask_info(args.mask)
    model, params = load_seq_stylegan(dataset, truncation=0.5)
    zds = z_dataset_for_model(model, 1000)
    gw_clean = SeqStyleGanRewriter(model, params, zds, layernum)
    gw_edit = SeqStyleGanRewriter(model, params, zds, layernum)
    with open(mask_path) as f:
        gw_edit.apply_edit(json.load(f), rank=1)
    results = patch_fid_sweep(gw_clean, gw_edit, args.crops, n=args.n)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({str(k): v for k, v in results.items()}, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
