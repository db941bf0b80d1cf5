"""Apply a published edit request to a generator, then sample images from
the edited model.

The port's counterpart of the JAX package's ``metrics/sample_edited.py``
(reference metrics/sample_edited.py:38-61), with the options its command
line takes: ``low_rank_insert`` (off for --full_rank), ``tight_paste``
(off for --no_tight_paste) and ``single_key`` (--single_context), and the
solve's step count ``niter`` (the paper's 2001 by default).  The command
line itself waits for the checkpoint loader, which is not ported.
"""

from __future__ import annotations

from ..rewrite import SeqStyleGanRewriter
from ..utils.zdataset import z_dataset_for_model
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
