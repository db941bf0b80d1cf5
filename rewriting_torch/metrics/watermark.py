"""The watermark-removal experiment of the paper's §5.2.

The port's counterpart of the JAX package's ``metrics/watermark.py``
(``save_zds_images`` :24, ``erase_watermark`` :48, ``main`` :94), after
the reference's metrics/make_watermark_images.py: the key statistics of
a StyleGAN2 layer are taken from the truncation-1.0 model and cached,
then the watermark rule is erased from the truncation-0.5 sampling model
with ``apply_erase`` (``ours``, repeated ``nreps`` times), by GANdissect's
baseline (``gandissect``: the `drank` units of the request's key
selections that score highest against their quantile sketch, zeroed in
the weight with ``zero``) or left as it is (``none``), and the z
dataset's images are written.

Command line (JAX package :94-130; reference :12-96)::

    python3 -m rewriting_torch.metrics.watermark [--model church]
        [--request multikey_markandbottom] [--requestdir notebooks/masks]
        [--layer 6] [--niters 2001] [--nreps 2] [--sample_size 1000]
        [--erasemethod ours|gandissect|none] [--outdir results/watermark]

loads the model's checkpoint twice through ``models/zoo.py`` (truncation
1.0 for the statistics, 0.5 for the erase and the images), on the card,
and writes ``<outdir>/erase-<gan>-<model>-<request>-...`` with the images
under ``images/`` and a ``done.txt`` marker at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from ..rewrite import SeqStyleGanRewriter
from ..utils import pbar, renormalize
from ..utils.imgsave import SaveImagePool
from ..utils.pidfile import mark_job_done, reserve_dir
from ..utils.zdataset import z_dataset_for_model

ERASE_METHODS = ("ours", "gandissect", "none")
# the context directions each method's rewriters are built with
_KEY_METHODS = {"ours": "zca", "gandissect": "gandissect", "none": "zca"}


def save_zds_images(dirname: str, model, params, zds, batch_size: int = 10,
                    name_template: str = "image_{}.png", indices=None):
    """Render every z of the dataset (or those at `indices`) through
    ``model(params, z)`` in batches and write ``image_{i}.png``
    (reference make_watermark_images.py:100-130)."""
    os.makedirs(dirname, exist_ok=True)
    idxs = list(indices) if indices is not None else list(range(len(zds)))
    saver = SaveImagePool()
    try:
        for lo in pbar.pbar(range(0, len(idxs), batch_size),
                            desc="Saving images"):
            chunk = idxs[lo:lo + batch_size]
            imgs = model(params, np.stack([zds[i] for i in chunk]))
            imgs = renormalize.renormalize(
                np.clip(imgs.cpu().numpy(), -1, 1), "zc", "byte")
            for i, img in zip(chunk, imgs):
                saver.add(img, os.path.join(dirname,
                                            name_template.format(i)))
    finally:
        saver.close()   # flushes the queued writes


def erase_watermark(model, params, params_for_covariance, request: dict,
                    layer: int, outdir: str, rank: int = 1, drank: int = 1,
                    niters: int = 2001, piters: int = 10, lr: float = 0.05,
                    nreps: int = 2, erasemethod: str = "ours",
                    sample_size: int = 1000, save_images: bool = True,
                    covariance_model=None, update_callback=None):
    """Erase the request's rule; returns the rewriter.

    The key statistics come from ``params_for_covariance`` on
    ``covariance_model`` (default `model`; the command line passes the
    truncation-1.0 model, as the reference does), cached in `outdir`,
    where the rewriter of `model` and `params` finds them; the erase and
    the images use `model` and `params`.  ``update_callback(rep, step,
    loss)`` sees every step of each repetition's solve."""
    if erasemethod not in ERASE_METHODS:
        raise ValueError(f"erasemethod {erasemethod!r}: one of "
                         f"{ERASE_METHODS}")
    key_method = _KEY_METHODS[erasemethod]
    zds = z_dataset_for_model(model, size=sample_size)
    os.makedirs(outdir, exist_ok=True)
    if params_for_covariance is not None:
        # fills the r2m cache that the rewriter below reads
        SeqStyleGanRewriter(
            covariance_model or model, params_for_covariance, zds, layer,
            cachedir=outdir, low_rank_insert=True, low_rank_gradient=True,
            key_method=key_method, device=model.device)
    gw = SeqStyleGanRewriter(
        model, params, zds, layer, cachedir=outdir, low_rank_insert=True,
        low_rank_gradient=True, key_method=key_method, device=model.device)
    if erasemethod == "ours":
        for rep in range(nreps):
            pbar.print("erasing objects from model (rep %d)" % rep)
            losses = gw.apply_erase(request, rank=rank, drank=drank,
                                    niter=niters, piter=piters, lr=lr)
            if update_callback is not None:
                for step, loss in enumerate(losses):
                    update_callback(rep, step, loss)
    elif erasemethod == "gandissect":
        gw.zero(gw.multi_key_from_selection(request["key"], rank=drank))
    if save_images:
        savedir = os.path.join(outdir, "images")
        os.makedirs(savedir, exist_ok=True)
        shutil.copyfile(
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "utils", "lightbox.html"),
            os.path.join(savedir, "+lightbox.html"))
        save_zds_images(savedir, model, gw.params, zds)
    return gw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="make_watermark_images")
    ap.add_argument("--outdir", default="results/watermark")
    ap.add_argument("--gan", default="stylegan")
    ap.add_argument("--model", default="church")
    ap.add_argument("--request", default="multikey_markandbottom")
    ap.add_argument("--requestdir", default="notebooks/masks")
    ap.add_argument("--sample_size", type=int, default=1000)
    ap.add_argument("--layer", type=int, default=6)
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--drank", type=int, default=1)
    ap.add_argument("--niters", type=int, default=2001)
    ap.add_argument("--piters", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--nreps", type=int, default=2)
    ap.add_argument("--erasemethod", default="ours",
                    choices=["ours", "gandissect", "none"])
    args = ap.parse_args(argv)
    subdir = (f"erase-{args.gan}-{args.model}-{args.request}-{args.layer}"
              f"-{args.rank}-{args.niters}-{args.lr}-{args.erasemethod}"
              f"-{args.drank}"
              + (f"-{args.nreps}" if args.erasemethod == "ours" else ""))
    outdir = reserve_dir(os.path.join(args.outdir, subdir))
    from ..models.zoo import load_seq_stylegan
    model, params_cov = load_seq_stylegan(args.model, truncation=1.0)
    model05, params = load_seq_stylegan(args.model, truncation=0.5)
    reqfn = os.path.join(args.requestdir, args.gan, args.model,
                         f"{args.request}.json")
    with open(reqfn) as f:
        request = json.load(f)
    erase_watermark(model05, params, params_cov, request, args.layer,
                    outdir, rank=args.rank, drank=args.drank,
                    niters=args.niters, piters=args.piters, lr=args.lr,
                    nreps=args.nreps, erasemethod=args.erasemethod,
                    sample_size=args.sample_size, covariance_model=model)
    mark_job_done(outdir)


if __name__ == "__main__":
    main()
