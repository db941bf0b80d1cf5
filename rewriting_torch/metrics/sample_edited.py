"""Apply a published edit request to a generator, then sample images from
the edited model.

The port's counterpart of the JAX package's ``metrics/sample_edited.py``
(reference metrics/sample_edited.py:38-61), with the options its command
line takes: ``low_rank_insert`` (off for --full_rank), ``tight_paste``
(off for --no_tight_paste) and ``single_key`` (--single_context), and the
solve's step count ``niter`` (the paper's 2001 by default).

Command line (JAX package :38-67; reference metrics/sample_edited.py)::

    python3 -m rewriting_torch.metrics.sample_edited --mask dome2tree
        [--full_rank] [--no_tight_paste] [--single_context K] [--n 10000]
        [--results results/samples]

finds the named edit request (``load_mask``), loads its dataset's
checkpoint (``models/zoo.py``, truncation 0.5) on the card, edits the
mask's layer with its statistics cached under
``results/rewrite/stylegan/<dataset>/layer<N>`` of the working directory,
and writes ``<results>/<mask>[_full_rank][_context<K>]/`` with a
``done.txt`` marker at the end.
"""

from __future__ import annotations

import argparse
import json
import os

from ..rewrite import SeqStyleGanRewriter
from ..utils.pidfile import mark_job_done, reserve_dir
from ..utils.zdataset import z_dataset_for_model
from .load_mask import load_mask_info
from .sample import sample_clean


def sample_edited(model, params, request: dict, layernum: int,
                  outdir: str, n: int = 10000, batch_size: int = 16,
                  rank: int = 1, cachedir=None, low_rank_insert=True,
                  tight_paste=True, single_key: int = -1,
                  zds_size: int = 1000, niter: int = 2001):
    """Build a rewriter at `layernum`, apply the edit, and sample the
    edited model into `outdir`; returns the rewriter."""
    zds = z_dataset_for_model(model, size=zds_size)
    gw = SeqStyleGanRewriter(
        model, params, zds, layernum, cachedir=cachedir,
        low_rank_insert=low_rank_insert, key_method="zca",
        tight_paste=tight_paste, device=model.device)
    gw.apply_edit(request, rank=rank, niter=niter, single_key=single_key)
    sample_clean(model, gw.params, outdir, n=n, batch_size=batch_size)
    return gw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="sample edited images")
    ap.add_argument("--mask", type=str, required=True)
    ap.add_argument("--full_rank", action="store_true")
    ap.add_argument("--no_tight_paste", action="store_true")
    ap.add_argument("--single_context", type=int, default=-1)
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--results", default="results/samples")
    args = ap.parse_args(argv)
    exp_name = args.mask
    if args.full_rank:
        exp_name += "_full_rank"
    if args.single_context != -1:
        exp_name += f"_context{args.single_context}"
    outdir = reserve_dir(os.path.join(args.results, exp_name))
    mask_path, dataset, layernum = load_mask_info(args.mask)
    from ..models.zoo import load_seq_stylegan
    model, params = load_seq_stylegan(dataset, truncation=0.5)
    with open(mask_path) as f:
        request = json.load(f)
    sample_edited(
        model, params, request, layernum, outdir, n=args.n,
        cachedir=os.path.join("results/rewrite/stylegan", dataset,
                              f"layer{layernum}"),
        low_rank_insert=not args.full_rank,
        tight_paste=not args.no_tight_paste,
        single_key=args.single_context)
    mark_job_done(outdir)


if __name__ == "__main__":
    main()
