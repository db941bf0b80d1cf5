"""Plot patch-FID sweep results (reference
metrics/patch_metrics/plot_patch_fids.py, which renders FID-vs-layer
curves per crop size from a results pickle).

Input here is the JSON files written by metrics/patch_fid.py
(``{crop_size: fid}`` per run); each file becomes one labeled curve of
FID vs crop size.  For the reference's layer-sweep view, pass one file
per layer and ``--by_layer`` to transpose the axes (FID vs layer, one
curve per crop size).

The port's copy of the JAX package's ``metrics/plot_patch_fids.py``.  It
imports matplotlib when it draws, not when it is imported, and draws on
the host only: the card's machine has no matplotlib, so run it on a CPU
host over the JSON files ``patch_fid`` writes there.

Command line::

    python3 -m rewriting_torch.metrics.plot_patch_fids a.json b.json
        [--labels ...] [--by_layer] [--out plots/patch_fids.png]
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence


def _load(paths: Sequence[str], labels: Sequence[str]
          ) -> Dict[str, Dict[int, float]]:
    out = {}
    for path, label in zip(paths, labels):
        with open(path) as f:
            out[label] = {int(k): float(v) for k, v in json.load(f).items()}
    return out


def plot_patch_fids(results: Dict[str, Dict[int, float]], out_png: str,
                    title: str = "Patch FID", xlabel: str = "Crop size",
                    by_layer: bool = False) -> str:
    """Render curves to out_png with a headless backend.  `results` maps
    curve label -> {x: fid}.  With by_layer=True the labels are treated as
    layer numbers and the inner keys as crop sizes, producing the
    reference's FID-vs-layer figure (plot_patch_fids.py:21-40)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if by_layer:
        def layer_num(label):
            digits = "".join(ch for ch in str(label) if ch.isdigit())
            if not digits:
                raise ValueError(
                    f"--by_layer needs a layer number in each curve "
                    f"label (e.g. 'layer8' or --labels 8); got {label!r}")
            return int(digits)
        transposed: Dict[str, Dict[int, float]] = {}
        for label, curve in results.items():
            for x, v in curve.items():
                transposed.setdefault(f"crop {x}", {})[layer_num(label)] = v
        results, xlabel = transposed, "Layer number"

    fig, ax = plt.subplots()
    for label, curve in results.items():
        xs = sorted(curve)
        ax.plot(xs, [curve[x] for x in xs], marker="o", label=str(label))
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("FID")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return out_png


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser("plot patch-FID sweeps")
    ap.add_argument("inputs", nargs="+", help="patch_fid.py JSON outputs")
    ap.add_argument("--labels", nargs="+", default=None,
                    help="one label per input (default: file stems)")
    ap.add_argument("--title", default="Patch FID")
    ap.add_argument("--by_layer", action="store_true",
                    help="labels are layer numbers; plot FID vs layer")
    ap.add_argument("--out", default="plots/patch_fids.png")
    args = ap.parse_args(argv)
    labels = args.labels or [
        os.path.splitext(os.path.basename(p))[0] for p in args.inputs]
    if len(labels) != len(args.inputs):
        raise SystemExit("need one label per input")
    results = _load(args.inputs, labels)
    print(plot_patch_fids(results, args.out, title=args.title,
                          by_layer=args.by_layer))


if __name__ == "__main__":
    main()
