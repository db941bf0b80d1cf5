"""Single-pass fused metrics pipeline: sample -> segment -> FID features
in one device pass per batch.

The port's counterpart of the JAX package's ``metrics/fused_pipeline.py``.
The reference runs three artifact-staged processes (reference
experiments.sh:10-48): sample 10k PNGs (``metrics/sample.py``), re-read
and segment them (``metrics/seg_stats.py``), re-read them again for FID's
feature statistics (``metrics/fid.py``).  This driver writes the same
artifacts -- per-image PNGs, per-image label ``.npz``, the ``mu``/``sigma``
statistics file -- in one pass: each sampled batch is segmented and
featurized while it is still on the card, so pixels and labels cross to
the host once each and nothing is uploaded back; the FID features never
leave the card (``stats.RunningCovariance`` there).  Each batch's image
and label copies are queued behind it on the stream, and the host waits
for batch i's copies only after it has queued batch i+1.

Exactness: the PNGs come from the same uint8 batches ``sample_clean``
quantizes, the labels from ``seg_stats.segment_images`` on the same bytes
the staged path decodes (PNG is lossless), the features from the same
bytes the staged FID pass reads; at the same batch size the artifacts
match (``tests/test_torch_seg_pipeline.py``).  On the card they match
where both paths run with cuDNN's deterministic algorithms
(``ops.precision.deterministic``): its default ones vary run to run, so
two passes over the same z may then differ by a unit in the last place
of a pixel, and a label at a near tie.

Command line (runs on the card)::

    python3 -m rewriting_torch.metrics.fused_pipeline --dataset church
        [--n 10000] [--batch_size 64] [--results results/fused]
        [--seg church_clean] [--fid_stats]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from ..utils import pbar
from ..utils.imgsave import SaveImagePool
from .sample import (_queue_copy, default_sample_fn, pad_batch, per_image_z,
                     quantize_uint8, write_lightbox)
from .seg_stats import SaveSegPool, queue_labels, segment_images


def run_fused(model, params, outdir: str, segmodel=None, feature_fn=None,
              n: int = 10000, batch_size: int = 64, offset: int = 0,
              seg_dir: Optional[str] = None,
              stats_path: Optional[str] = None,
              sample_fn=None, seg_downsample: int = 1):
    """Sample n images under the per-image z-seed contract and, per
    device batch, optionally segment them (labels -> {seg_dir}/{i}.npz,
    default ``{outdir}/seg``) and accumulate FID feature statistics
    (returned as (mu, sigma), and written to `stats_path` if given).

    The layout is the staged drivers' (``sample_clean``,
    ``seg_stats.process``, ``get_fid.save_model_stats``), so later stages
    (``seg_correct_mod``, ``distances``, FID comparisons) read either."""
    write_lightbox(outdir)
    if sample_fn is None:
        sample_fn = default_sample_fn(model)
    if segmodel is not None:
        seg_dir = seg_dir or os.path.join(outdir, "seg")
        os.makedirs(seg_dir, exist_ok=True)
    cov = None
    if feature_fn is not None:
        from ..stats.running import RunningCovariance
        cov = RunningCovariance()
        # the plain callables fid.compute_feature_stats takes, too
        dev_feature_fn = getattr(feature_fn, "device_features", feature_fn)

    img_saver = SaveImagePool()
    seg_saver = SaveSegPool() if segmodel is not None else None

    def write(nums, images, labels):
        for _, copied in (images, labels or (None, None)):
            if copied is not None:
                copied.synchronize()
        for num, img in zip(nums, images[0].numpy()):
            img_saver.add(img, os.path.join(outdir, f"{num}.png"))
        if labels is not None:
            for num, seg in zip(nums, labels[0].numpy()):
                seg_saver.add(os.path.join(seg_dir, f"{num}.npz"), seg)

    try:
        pending = None
        for lo in pbar.pbar(range(0, n, batch_size), desc="fused pipeline"):
            nums = list(range(lo, min(lo + batch_size, n)))
            zs = pad_batch(per_image_z(model, [i + offset for i in nums]),
                           batch_size)
            imgs = quantize_uint8(sample_fn(params, zs))
            images = _queue_copy(imgs[:len(nums)])
            labels = None
            if segmodel is not None:
                # seg_stats.process's dispatch, so the labels match
                labels = queue_labels(segment_images(
                    segmodel, imgs, seg_downsample)[:len(nums)])
            if cov is not None:
                feats = dev_feature_fn(imgs)
                cov.add(torch.as_tensor(feats,
                                        dtype=torch.float32)[:len(nums)])
            if pending is not None:
                write(*pending)    # batch i-1, while batch i runs
            pending = (nums, images, labels)
        if pending is not None:
            write(*pending)
    finally:
        img_saver.close()
        if seg_saver is not None:
            seg_saver.close()

    if cov is None:
        return None
    mu = cov.mean().cpu().numpy()
    sigma = cov.covariance(unbiased=True).cpu().numpy()
    if stats_path:
        from . import fid as fid_mod
        fid_mod.save_stats(stats_path, mu, sigma)
    return mu, sigma


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        "fused sample+segment+FID pipeline (one device pass)")
    ap.add_argument("--dataset", default="church")
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--results", default="results/fused")
    ap.add_argument("--seg", default=None,
                    help="experiment name for the load_seg registry "
                         "(omit to skip segmentation)")
    ap.add_argument("--fid_stats", action="store_true",
                    help="also accumulate Inception feature stats")
    args = ap.parse_args(argv)
    from ..models.zoo import load_seq_stylegan
    from ..utils.pidfile import mark_job_done, reserve_dir
    outdir = os.path.join(args.results, args.dataset)
    reserve_dir(outdir)
    model, params = load_seq_stylegan(args.dataset, truncation=0.5)
    segmodel = None
    if args.seg:
        from .load_seg import load_seg_model
        segmodel = load_seg_model(args.seg)
    feature_fn = None
    if args.fid_stats:
        from .fid import FeatureExtractor
        feature_fn = FeatureExtractor(batch_size=args.batch_size)
    run_fused(model, params, outdir, segmodel=segmodel,
              feature_fn=feature_fn, n=args.n, batch_size=args.batch_size,
              stats_path=(os.path.join(outdir, "fid_stats.npz")
                          if args.fid_stats else None))
    mark_job_done(outdir)


if __name__ == "__main__":
    main()
