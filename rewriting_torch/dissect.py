"""quickdissect: a small GANdissect that labels a generator layer's units
by their IoU with segmentation classes.

Counterpart of the JAX package's ``dissect.py`` (:26-159), after the
reference's utils/quickdissect.py: retain a layer's activations over a z
sample, upsample them on the device, sketch each unit's quantiles,
threshold each unit at its `cutoff` quantile, tally the mean of those
indicators within each segmentation class, take the all-pairs IoU, and
write ``rq.npz``, ``cmv.npz``, ``topk.npz``, ``iou.npy``, ``labels.json``,
``seglabels.json`` and each unit's strip of top-activating images
(``imgs/unit_<u>.png``).  ``DissectVis`` reads them back, its images
through the port's own PNG decoder as ``uint8`` arrays.

A segmenter is an object whose ``segment_batch(images)`` maps the (B, H,
W, 3) images, a tensor on the device in [-1, 1], to (B, M, H, W) integer
label maps on the device (0: no label): those of ``segment/``, or any
other.

Command line (reference quickdissect.py:10-33)::

    python3 -m rewriting_torch.dissect [--model church] [--layer layer4]
        [--seg netpqc] [--sample_size 1000] [--outdir results]

dissects a ProgGAN, named as in ``models/zoo.py`` or given as a path to a
checkpoint file, with ``segment.load_segmenter(--seg)`` (the released
models in ``$REWRITING_TPU_WEIGHTS``), on the card, into
``<outdir>/<model>/<layer>/<seg>/<sample_size>``, claimed with a pidfile
and marked done at the end.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .core.instrument import InstrumentedPipeline
from .models.stylegan2 import params_to
from .native import read_image
from .stats import tally
from .utils import imgsave, imgviz, pbar, pidfile
from .utils.device import resolve_device
from .utils.upsample import upsampler
from .utils.zdataset import z_dataset_for_model


def dissect(model, params, layer: str, segmodel, seglabels, outdir: str,
            sample_size: int = 1000, batch_size: int = 10,
            upsample_to=(64, 64), cutoff: float = 0.99,
            save_unit_images: bool = True, topk_k: int = 5, device=None):
    """Dissect `layer` of (model, params) over `sample_size` seeded z into
    `outdir` (the caches there are reused); returns the unit records
    ``{"units": [{"unit", "iou", "label", "cls"}, ...]}``.  Runs on
    `device` (default ``cuda``), which must be the model's."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, dissect asked for "
                         f"{device}")
    os.makedirs(outdir, exist_ok=True)
    inst = InstrumentedPipeline(model, params_to(params, device))
    inst.retain_layer(layer)
    zds = z_dataset_for_model(model, size=sample_size, seed=1)

    def fmap_of(zbatch):
        """(images, the layer's (B, h, w, C) activations) of a z batch."""
        imgs = inst(zbatch)
        return imgs, inst.retained_layer(layer)["fmap"]

    sample_act = fmap_of(zds.zs[:1])[1]
    units = sample_act.shape[-1]
    upfn = upsampler(upsample_to, tuple(sample_act.shape[1:3]))

    def flat_acts(zbatch):
        return upfn(fmap_of(zbatch)[1]).reshape(-1, units)

    rq = tally.tally_quantile(flat_acts, zds, batch_size=batch_size,
                              cachefile=os.path.join(outdir, "rq.npz"),
                              device=device)
    level_np = rq.quantiles([cutoff])[:, 0]               # (units,)
    level = torch.as_tensor(level_np, device=device)

    def compute_cond_indicator(zbatch):
        imgs, fmap = fmap_of(zbatch)
        seg = segmodel.segment_batch(imgs)
        iacts = (upfn(fmap) > level).to(torch.float32)
        return tally.conditional_samples(iacts, seg)

    cmv = tally.tally_conditional_mean(
        compute_cond_indicator, zds, batch_size=batch_size,
        cachefile=os.path.join(outdir, "cmv.npz"), device=device)

    iou_table = tally.iou_from_conditional_indicator_mean(cmv).T
    np.save(os.path.join(outdir, "iou.npy"), iou_table)   # (units, conds)

    best_cond = iou_table.argmax(axis=1)
    best_iou = iou_table.max(axis=1)
    unit_records = {"units": [
        {"unit": int(u), "iou": float(best_iou[u]),
         "label": seglabels[int(best_cond[u])]
         if int(best_cond[u]) < len(seglabels) else str(best_cond[u]),
         "cls": int(best_cond[u])}
        for u in range(len(best_iou))]}
    with open(os.path.join(outdir, "labels.json"), "w") as f:
        json.dump(unit_records, f)
    with open(os.path.join(outdir, "seglabels.json"), "w") as f:
        json.dump(list(seglabels), f)

    if save_unit_images:
        topk = tally.tally_topk(
            lambda zbatch: fmap_of(zbatch)[1].amax(dim=(1, 2)), zds,
            k=topk_k, batch_size=batch_size,
            cachefile=os.path.join(outdir, "topk.npz"), device=device)
        idx = topk.result()[1].cpu().numpy()
        iv = imgviz.ImageVisualizer(128, quantiles=rq)
        # render each needed sample once: the top-k lists share images
        needed = sorted({int(i) for row in idx[:, :topk_k] for i in row})
        cache = {}
        with torch.no_grad():
            for lo in pbar.pbar(range(0, len(needed), batch_size),
                                desc="render topk"):
                chunk = needed[lo:lo + batch_size]
                imgs, fmaps = fmap_of(zds.zs[np.asarray(chunk)])
                imgs, fmaps = imgs.cpu().numpy(), fmaps.cpu().numpy()
                for j, i in enumerate(chunk):
                    cache[i] = (imgs[j], fmaps[j])
        rows = []
        for u in pbar.pbar(range(units), desc="unit images"):
            # thresholded at the dataset-level quantile of the unit, not
            # the image's own
            cells = [iv.masked_image(cache[int(i)][0],
                                     activations=cache[int(i)][1][:, :, u],
                                     level=float(level_np[u]))
                     for i in idx[u][:topk_k]]
            rows.append(iv.image_row(cells))
        imgsave.save_image_set(rows, os.path.join(outdir,
                                                  "imgs/unit_%d.png"))
    return unit_records


class DissectVis:
    """Reader of dissection outputs under
    ``<outdir>/<model>/<layer>/<seg>/<sample_size>``."""

    def __init__(self, outdir="results", model="church", layers=None,
                 seg="netpqc", sample_size=1000):
        layers = layers or ["layer%d" % i for i in range(1, 15)]
        labels, iou, images = {}, {}, {}
        dirname = None
        for k in layers:
            dirname = os.path.join(outdir, model, k, seg, str(sample_size))
            with open(os.path.join(dirname, "labels.json")) as f:
                labels[k] = json.load(f)["units"]
            iou[k] = np.load(os.path.join(dirname, "iou.npy"))
            images[k] = [None] * len(iou[k])
        with open(os.path.join(dirname, "seglabels.json")) as f:
            self.seglabels = json.load(f)
        self.labels = labels
        self.ioutable = iou
        self.images = images
        self.basedir = os.path.join(outdir, model)
        self.setting = os.path.join(seg, str(sample_size))

    def label(self, layer, unit):
        return self.labels[layer][unit]["label"]

    def iou(self, layer, unit):
        return self.labels[layer][unit]["iou"]

    def top_units(self, layer, seglabel, k=20):
        col = self.seglabels.index(seglabel)
        return self.ioutable[layer][:, col].argsort()[::-1][:k].tolist()

    def image(self, layer, unit) -> np.ndarray:
        """The unit's strip of top images in its file's own mode ((H, W,
        3) uint8 as dissection writes it)."""
        result = self.images[layer][unit]
        if result is None:
            result = read_image(os.path.join(self.basedir, layer,
                                             self.setting,
                                             "imgs/unit_%d.png" % unit))
            self.images[layer][unit] = result
        return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="quickdissect")
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--model", default="church",
                    help="a ProgGAN of the zoo, or a checkpoint file")
    ap.add_argument("--layer", default="layer4")
    ap.add_argument("--seg", default="netpqc")
    ap.add_argument("--sample_size", type=int, default=1000)
    args = ap.parse_args(argv)
    from .models.zoo import load_proggan
    from .segment import load_segmenter
    path = args.model if os.path.isfile(args.model) else None
    name = os.path.splitext(os.path.basename(path))[0] if path \
        else args.model
    outdir = os.path.join(args.outdir, name, args.layer, args.seg,
                          str(args.sample_size))
    pidfile.reserve_dir(outdir)
    model, params = load_proggan(name, path=path)
    segmodel, seglabels = load_segmenter(args.seg)
    dissect(model, params, args.layer, segmodel, seglabels, outdir,
            sample_size=args.sample_size, device=model.device)
    pidfile.mark_job_done(outdir)


if __name__ == "__main__":
    main()
