"""Effectiveness metric: the fraction of source-labelled pixels (clean
model) that carry the target label after the edit.

The port's counterpart of the JAX package's ``metrics/seg_correct_mod.py``
(reference metrics/seg_correct_mod.py:40-65), over the per-image label
files of ``seg_stats`` (``segio.load_seg``).  Not the damage metric's
``distances.compute_dl``.

Command line (reference seg_correct_mod.py:69-84; host only)::

    python3 -m rewriting_torch.metrics.seg_correct_mod --exp_name
        dome2spire [--num 10000] [--results results/samples]

compares ``<results>/seg/<dataset>_clean`` with ``<results>/seg/<exp_name>``
and prints ``total=... count=... ratio=...``.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Sequence

import numpy as np

from .segio import load_seg


def compute_dl(before: str, after: str, indices: Iterable[int],
               tgt: Sequence[int] = (5,), tgtc: int = 0,
               src: Sequence[int] = (1708,), srcc: int = 2):
    """(total correctly-modified pixels, total source pixels)."""
    total, count = 0, 0
    for i in indices:
        before_seg = load_seg(os.path.join(before, str(i)))
        after_seg = load_seg(os.path.join(after, str(i)))
        bch = before_seg[srcc] if before_seg.ndim == 3 else before_seg
        ach = after_seg[tgtc] if after_seg.ndim == 3 else after_seg
        src_mask = np.zeros_like(bch, bool)
        for s in src:
            src_mask |= bch == s
        mapped = ach[src_mask]
        hit = np.zeros_like(mapped, bool)
        for t in tgt:
            hit |= mapped == t
        total += int(hit.sum())
        count += int(mapped.shape[0])
    return total, count


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp_name", type=str, required=True)
    ap.add_argument("--num", type=int, default=10000)
    ap.add_argument("--results", default="results/samples")
    args = ap.parse_args(argv)
    from .load_mask import load_mask_info
    from .load_seg import load_seg_info_from_exp_name
    _, dataset, _ = load_mask_info(args.exp_name)
    before = os.path.join(args.results, "seg", f"{dataset}_clean")
    after = os.path.join(args.results, "seg", args.exp_name)
    _, srcc, tgtc, src, tgt = load_seg_info_from_exp_name(args.exp_name)
    total, count = compute_dl(before, after, range(args.num), tgt, tgtc,
                              src, srcc)
    print(f"before: {before}")
    print(f"after: {args.exp_name}")
    print(f"total={total} count={count} "
          f"ratio={total / max(count, 1):.4f}")


if __name__ == "__main__":
    main()
