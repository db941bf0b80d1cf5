"""Generate notebooks/torch/stats/: the port's ten stats notebooks.

Each is the counterpart of the notebook of the same name under
notebooks/stats/ (written by scripts/make_stats_notebooks.py, or by hand
for segmentation-stats, face-label-stats and attribute-comparison), on
rewriting_torch instead of the JAX package.  Every notebook opens with a
parameters cell (tagged ``parameters``, as papermill reads it) that sets
``device = "cuda"``, then a model cell that builds only the generator, its
params and the depth variables (``n_images``, ``batch``): the released
checkpoint from $REWRITING_TPU_WEIGHTS when it is there, else a tiny
model seeded by ``init_params``, both on ``device``.  A runner may run a
cell of its own after each of the two (tests set ``device = "cpu"``; a
card run cuts ``n_images``).

Run: python scripts/make_torch_stats_notebooks.py   (idempotent; the
files are saved as notebooks/ipynb_strip_output.py leaves them.)
"""

import json
import os

OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "notebooks", "torch", "stats")

PARAMETERS = """\
# the device of every model, segmenter and statistic below; "cpu" runs
# the notebook without a card
device = "cuda"
"""


def nb(cells):
    """A notebook of (kind, source) cells, "parameters" tagging the
    parameters cell, as notebooks/ipynb_strip_output.py saves it."""
    out = []
    for kind, src in cells:
        cell = {"cell_type": "code" if kind == "parameters" else kind,
                "metadata": {"tags": ["parameters"]}
                if kind == "parameters" else {},
                "source": src.splitlines(keepends=True)}
        if cell["cell_type"] == "code":
            cell.update(outputs=[], execution_count=None)
        out.append(cell)
    return {
        "cells": out,
        "metadata": {"kernelspec": {"display_name": "Python 3",
                                    "language": "python",
                                    "name": "python3"},
                     "language_info": {"name": "python"}},
        "nbformat": 4, "nbformat_minor": 5,
    }


def dumps(notebook) -> str:
    return json.dumps(notebook, indent=1, sort_keys=True) + "\n"


def intro(title, jax_name, text):
    return ("markdown", f"""\
# {title}

The port's counterpart of `notebooks/stats/{jax_name}.ipynb`, on
PyTorch and CUDA (`rewriting_torch`). {text}

Everything runs on `device` (the card unless the first cell says
otherwise); checkpoints come from `$REWRITING_TPU_WEIGHTS`, and without
them tiny seeded models keep the notebook executable end to end.""")


CHURCH = """\
import numpy as np, torch, os, tempfile
from rewriting_torch.utils.show import show
from rewriting_torch.utils import renormalize, segviz

# generator: real zoo checkpoint when present, else a tiny random model
try:
    from rewriting_torch.models.zoo import load_seq_stylegan
    model, params = load_seq_stylegan('church', truncation=0.5,
                                      device=device)
    n_images, batch = 200, 10
except FileNotFoundError:
    from rewriting_torch.models import ProgressiveGenerator
    model = ProgressiveGenerator(sizes=[16, 16, 8, 8], device=device)
    params = model.init_params(seed=0)
    n_images, batch = 24, 8
"""


def segmenter(labels, owner, tail="len(seglabels)"):
    return f"""\
# segmenter: released unified-parsing model, or a tiny random one
try:
    from rewriting_torch.segment import load_segmenter
    segmodel, seglabels = load_segmenter('netpqc', device=device)
except FileNotFoundError:
    from rewriting_torch.segment import load_segmenter
    from rewriting_torch.segment.upernet import UPerNet
    labeldata = {{"object": {labels},
                 "part": ["-", "top"], "material": ["-", "matte"],
                 "scene": ["-", "{owner[1]}"],
                 "object_part": {{"{owner[0]}": ["top"]}}}}
    net = UPerNet({{"object": 4, "part": 1, "material": 2, "scene": 2}},
                  [1], {{1: [1]}})
    segmodel, seglabels = load_segmenter(
        'netq', params=net.init_params(seed=1), labeldata=labeldata,
        device=device)
{tail}
"""


TINY_SEG = segmenter('["-", "dome", "sky", "tree"]', ("dome", "outdoor"))

REWRITER = """\
from rewriting_torch.rewrite import (ProgressiveGanRewriter,
                                     SeqStyleGanRewriter)
from rewriting_torch.utils.zdataset import z_dataset_for_model
from rewriting_torch.utils.renormalize import mask_to_url
zds = z_dataset_for_model(model, n_images)
"""

SAMPLE_DIRS = """\
# sample a 'before' directory and an edited 'after' directory (the
# reference analyzes results/samples dirs written by experiments.sh)
from rewriting_torch.metrics.sample import sample_clean
workdir = tempfile.mkdtemp()
before_dir = os.path.join(workdir, 'before')
sample_clean(model, params, before_dir, n=n_images, batch_size=batch)

# the 'after' condition: a rank-1 weight edit applied via the rewriter
""" + REWRITER + """\
if model.__class__.__name__ == 'SeqStyleGAN2':
    gw = SeqStyleGanRewriter(model, params, zds, layernum=8,
                             stats_batch_size=batch, device=device)
else:
    gw = ProgressiveGanRewriter(model, params, zds, layernum=2,
                                stats_batch_size=batch, device=device)
m = np.zeros((4, 4), np.float32); m[1:3, 1:3] = 1
url = mask_to_url(m)
gw.apply_edit({"object": [0, url], "paste": [1, url], "key": [[2, url]]},
              rank=1, niter=21, piter=10, lr=0.05)
after_dir = os.path.join(workdir, 'after')
sample_clean(model, gw.params, after_dir, n=n_images, batch_size=batch)
sorted(os.listdir(before_dir))[:3], sorted(os.listdir(after_dir))[:3]
"""

# a batch of a directory's {i}.png as zc images, and its labels on the
# device
READ_ZC = """\
def read_zc(path, nums):
    return np.stack([
        renormalize.renormalize(
            read_image_rgb(os.path.join(path, f"{i}.png")).astype(
                np.float32) / 255.0, "pt", "zc")
        for i in nums])
"""

SEG_DIR_FN = """\
# per-label pixel counts of every image in a directory, streamed
from rewriting_torch.stats import RunningBincount
from rewriting_torch.native import read_image_rgb

""" + READ_ZC + """

def dir_label_counts(path, n):
    rb = RunningBincount(size=len(seglabels) + 1)
    for lo in range(0, n, batch):
        imgs = read_zc(path, range(lo, min(lo + batch, n)))
        seg = segmodel.segment_batch(torch.as_tensor(imgs, device=device))
        rb.add(seg[:, 0].reshape(len(imgs), -1))
    return rb.result().cpu().numpy()
"""

# merge the per-image label files of a directory into one histogram
MERGE_SEGS = """\
counts = np.zeros(len(seglabels) + 1, np.int64)
for i in range(n_images):
    seg = np.load(os.path.join(seg_path, f"{i}.npz"))["seg"]
    counts += np.bincount(seg[0].reshape(-1), minlength=len(counts))
[(seglabels[i] if i < len(seglabels) else i, int(counts[i]))
 for i in np.argsort(-counts)[:8] if counts[i] > 0]
"""


def gen_segmentation_stats():
    return nb([
        intro("Segmentation statistics over generated images",
              "segmentation-stats", """\
Sample images from a generator, segment them, and tabulate per-label
pixel statistics and unit/label IoU through the streaming statistics
(the reference's `Generic_Segmentation.ipynb` family). The segmenter is
the released `netpqc` unified-parsing model when its files are there."""),
        ("parameters", PARAMETERS),
        ("code", """\
import numpy as np, torch
from rewriting_torch.utils.zdataset import z_dataset_for_model
from rewriting_torch.utils.show import show
from rewriting_torch.utils import segviz, renormalize

try:
    from rewriting_torch.models.zoo import load_seq_stylegan
    model, params = load_seq_stylegan('church', truncation=0.5,
                                      device=device)
    n_images, batch = 200, 10
except FileNotFoundError:
    from rewriting_torch.models import ProgressiveGenerator
    model = ProgressiveGenerator(sizes=[16, 16, 8, 8], device=device)
    params = model.init_params(seed=0)
    n_images, batch = 30, 10
"""),
        ("code", segmenter('["-", "wall", "sky", "floor"]', ("wall", "room"),
                           "len(seglabels), "
                           "segmodel.get_label_and_category_names()[1]")),
        ("code", """\
# per-label pixel counts over the sample, streamed with RunningBincount
from rewriting_torch.stats import RunningBincount
zds = z_dataset_for_model(model, n_images)
rb = RunningBincount(size=len(seglabels) + 1)
sample_fn = model    # (params, z) -> (B, H, W, 3) images on the device
segs = []
for lo in range(0, n_images, batch):
    z = zds.zs[lo:lo + batch]
    imgs = sample_fn(params, z).clamp(-1, 1)
    seg = segmodel.segment_batch(imgs)
    segs.append((imgs.cpu().numpy(), seg.cpu().numpy()))
    rb.add(seg[:, 0].reshape(len(z), -1))
counts = rb.result().cpu().numpy()
order = np.argsort(-counts)[:10]
[(seglabels[i] if i < len(seglabels) else i, int(counts[i]))
 for i in order if counts[i] > 0][:10]
"""),
        ("code", """\
# visualize: image / segmentation pairs for the first batch (the port's
# show takes uint8 arrays)
imgs, seg = segs[0]
show([[renormalize.as_image(imgs[i]),
       segviz.segment_visualization(seg[i, 0])]
      for i in range(3)])
"""),
        ("code", """\
# unit/label IoU on a generator layer (mini-dissection): which units
# activate where a label appears (reference quickdissect.py:10-92)
from rewriting_torch.dissect import dissect
import tempfile, os
outdir = os.path.join(tempfile.mkdtemp(), 'dissect')
layer = [s.name for s in model.pipeline.stages
         if s.name.endswith('.activate') or s.name.endswith('.conv')][1]
records = dissect(model, params, layer, segmodel, seglabels, outdir,
                  sample_size=min(n_images, 20), batch_size=10,
                  save_unit_images=False, device=device)
sorted(records['units'], key=lambda r: -r['iou'])[:5]
"""),
    ])


def gen_dome2tree():
    return nb([
        intro("Segmentation change statistics: dome2tree (ours vs baseline)",
              "segmentation-stats-dome2tree", """\
Compare per-class pixel areas between a clean sample directory and an
edited one, and compute the effectiveness ratio (source pixels that
became the target class): the dome2tree instance of the reference's
before/after class-area family (`Generic_Segmentation-stats-Copy1`)."""),
        ("parameters", PARAMETERS),
        ("code", CHURCH),
        ("code", TINY_SEG),
        ("code", SAMPLE_DIRS),
        ("code", SEG_DIR_FN + """\
before_counts = dir_label_counts(before_dir, n_images)
after_counts = dir_label_counts(after_dir, n_images)
total = before_counts.sum()
rows = [("label", "before%", "after%", "delta pp")]
for i in np.argsort(-np.abs(after_counts - before_counts))[:8]:
    if before_counts[i] + after_counts[i] == 0: continue
    name = seglabels[i] if i < len(seglabels) else str(i)
    rows.append((name, round(100 * before_counts[i] / total, 2),
                 round(100 * after_counts[i] / total, 2),
                 round(100 * (after_counts[i] - before_counts[i]) / total,
                       2)))
rows
"""),
        ("code", """\
# effectiveness-style summary: total area moved between classes
moved = float(np.abs(after_counts - before_counts).sum()) / 2 / total
print(f"fraction of pixels whose class area shifted: {moved:.4f}")
assert np.isfinite(moved)
"""),
    ])


def gen_comparison():
    return nb([
        intro("Multi-condition segmentation comparison",
              "segmentation-stats-comparison", """\
The before/after class-area analysis re-run across several experiment
conditions (ours at rank 1 against the all-weights 'overfit' baseline)
and collected into one table (the reference's
`Generic_Segmentation-stats-Copy{2,3,4}`)."""),
        ("parameters", PARAMETERS),
        ("code", CHURCH),
        ("code", TINY_SEG),
        ("code", """\
# build three conditions: clean, rank-1 edit ('ours'), all-weights
# overfit baseline (reference ganrewrite.py:300-331)
from rewriting_torch.metrics.sample import sample_clean
from rewriting_torch.rewrite import ProgressiveGanRewriter
from rewriting_torch.utils.zdataset import z_dataset_for_model
from rewriting_torch.utils.renormalize import mask_to_url
workdir = tempfile.mkdtemp()
zds = z_dataset_for_model(model, n_images)
m = np.zeros((4, 4), np.float32); m[1:3, 1:3] = 1
url = mask_to_url(m)
request = {"object": [0, url], "paste": [1, url], "key": [[2, url]]}
conditions = {}
clean_dir = os.path.join(workdir, 'clean')
sample_clean(model, params, clean_dir, n=n_images, batch_size=batch)
conditions['clean'] = clean_dir
for name, kw in [("ours_rank1", dict(rank=1)),
                 ("overfit", dict(overfit=True))]:
    if model.__class__.__name__ == 'SeqStyleGAN2':
        from rewriting_torch.rewrite import SeqStyleGanRewriter
        gw = SeqStyleGanRewriter(model, params, zds, layernum=8,
                                 stats_batch_size=batch, device=device)
    else:
        gw = ProgressiveGanRewriter(model, params, zds, layernum=2,
                                    stats_batch_size=batch, device=device)
    if kw.get("overfit"):
        gw.apply_overfit(request, niter=11, lr=0.01)
    else:
        gw.apply_edit(request, rank=kw["rank"], niter=21, piter=10,
                      lr=0.05)
    d = os.path.join(workdir, name)
    sample_clean(model, gw.params, d, n=n_images, batch_size=batch)
    conditions[name] = d
list(conditions)
"""),
        ("code", SEG_DIR_FN + """\
counts = {name: dir_label_counts(d, n_images)
          for name, d in conditions.items()}
total = counts['clean'].sum()
top = np.argsort(-counts['clean'])[:6]
rows = [tuple(["label"] + list(counts))]
for i in top:
    name = seglabels[i] if i < len(seglabels) else str(i)
    rows.append(tuple([name] + [round(100 * c[i] / total, 2)
                                for c in counts.values()]))
rows
"""),
        ("code", """\
# damage proxy: L1 distance of the class-area histograms vs clean
for name, c in counts.items():
    if name == 'clean': continue
    print(name, "histogram L1 vs clean:",
          round(float(np.abs(c - counts['clean']).sum()) / total, 4))
"""),
    ])


def gen_area_profile():
    return nb([
        intro("Per-image region-area profile", "dome-area-profile", """\
Profile the per-image area of the region that an edit changes most,
before and after it: the distributional view behind the aggregate
numbers (the reference's scratch `Untitled.ipynb`)."""),
        ("parameters", PARAMETERS),
        ("code", CHURCH),
        ("code", TINY_SEG),
        ("code", SAMPLE_DIRS),
        ("code", """\
# per-IMAGE area fraction of the most-affected class, before vs after
from rewriting_torch.native import read_image_rgb
from rewriting_torch.stats import RunningBincount

""" + READ_ZC + """

def per_image_areas(path, label):
    fracs = []
    for i in range(n_images):
        img = torch.as_tensor(read_zc(path, [i]), device=device)
        seg = segmodel.segment_batch(img)
        fracs.append(float((seg[0, 0] == label).float().mean()))
    return np.asarray(fracs)

# pick the class whose total area changed most
def totals(path):
    rb = RunningBincount(size=len(seglabels) + 1)
    for lo in range(0, n_images, batch):
        imgs = read_zc(path, range(lo, min(lo + batch, n_images)))
        seg = segmodel.segment_batch(torch.as_tensor(imgs, device=device))
        rb.add(seg[:, 0].reshape(len(imgs), -1))
    return rb.result().cpu().numpy()

tb, ta = totals(before_dir), totals(after_dir)
label = int(np.argmax(np.abs(ta.astype(np.int64) - tb.astype(np.int64))))
name = seglabels[label] if label < len(seglabels) else str(label)
fb = per_image_areas(before_dir, label)
fa = per_image_areas(after_dir, label)
print(f"class '{name}': mean area before {fb.mean():.4f} "
      f"after {fa.mean():.4f}")
"""),
        ("code", """\
# distribution: histogram of per-image area fractions
bins = np.linspace(0, max(fb.max(), fa.max(), 1e-6), 8)
hb, _ = np.histogram(fb, bins)
ha, _ = np.histogram(fa, bins)
rows = [("bin<=", "before", "after")]
for i in range(len(hb)):
    rows.append((round(float(bins[i + 1]), 4), int(hb[i]), int(ha[i])))
rows
"""),
    ])


def gen_folder_seg():
    return nb([
        intro("Segment an image folder", "folder-segmentation", """\
Segment every image in a directory (the reference's
`UnsupervisedImageFolder`, `Generic_Segmentation-Copy{1,2}`) and
tabulate class areas."""),
        ("parameters", PARAMETERS),
        ("code", CHURCH),
        ("code", TINY_SEG),
        ("code", """\
# make an image folder to analyze (any directory of PNGs works)
from rewriting_torch.metrics.sample import sample_clean
img_path = os.path.join(tempfile.mkdtemp(), 'imgs')
sample_clean(model, params, img_path, n=n_images, batch_size=batch)
files = sorted(f for f in os.listdir(img_path) if f.endswith('.png'))
len(files)
"""),
        ("code", """\
# stream the folder through the segmenter -> per-class area histogram
from rewriting_torch.stats import RunningBincount
from rewriting_torch.native import read_image_rgb
rb = RunningBincount(size=len(seglabels) + 1)
segs = []
for lo in range(0, len(files), batch):
    imgs = np.stack([
        renormalize.renormalize(
            read_image_rgb(os.path.join(img_path, f)).astype(
                np.float32) / 255.0, "pt", "zc")
        for f in files[lo:lo + batch]])
    seg = segmodel.segment_batch(torch.as_tensor(imgs, device=device))
    segs.append((imgs, seg.cpu().numpy()))
    rb.add(seg[:, 0].reshape(len(imgs), -1))
counts = rb.result().cpu().numpy()
[(seglabels[i] if i < len(seglabels) else i, int(counts[i]))
 for i in np.argsort(-counts)[:8] if counts[i] > 0]
"""),
        ("code", """\
# image / segmentation visual check, built incrementally with show.a
# (the reference stats notebooks' row-builder, utils/show.py:122-141)
from rewriting_torch.utils import show as showmod
imgs, seg = segs[0]
showmod.reset()
for i in range(min(3, len(imgs))):
    showmod.a(renormalize.as_image(imgs[i]))
    showmod.a(segviz.segment_visualization(seg[i, 0]), cols=2)
showmod.flush()
"""),
        ("code", """\
# color legend for the top labels in the first image
# (segviz.segment_key / swatch_image, reference segviz.py:12-27)
class _Labels:
    def get_label_and_category_names(self):
        return [(l, 'object') for l in seglabels], ['object']
legend = segviz.segment_key(seg[0, 0], _Labels(), max_labels=5)
show([[sw, name] for sw, name in legend])
"""),
    ])


SEG_FOLDER = """\
from rewriting_torch.metrics.sample import sample_clean
from rewriting_torch.native import read_image_rgb
workdir = tempfile.mkdtemp()
img_path = os.path.join(workdir, 'imgs')
seg_path = os.path.join(workdir, 'segs')
"""


def gen_folder_seg_resumable():
    return nb([
        intro("Resumable folder segmentation",
              "folder-segmentation-resumable", """\
The long-running variant, re-opened across sessions: it skips the
images whose segmentation file already exists, so the notebook resumes
where it stopped (the reference's `Generic_Segmentation-Copy{3..8}`,
whose cells build a sampler over the paths not yet done)."""),
        ("parameters", PARAMETERS),
        ("code", CHURCH),
        ("code", TINY_SEG),
        ("code", SEG_FOLDER + """\
from rewriting_torch.metrics import seg_stats
sample_clean(model, params, img_path, n=n_images, batch_size=batch)

# first pass: segment only HALF the images (simulating an interrupted
# session), writing one npz per image like the reference's .pth-per-image
seg_stats.process(segmodel, img_path, seg_path, n=n_images // 2,
                  batch_size=batch)
done0 = len(os.listdir(seg_path))
done0
"""),
        ("code", """\
# resume: enumerate only the images whose seg file does NOT exist yet
# (the reference's custom not-done Sampler), then finish the directory
todo = [i for i in range(n_images)
        if not os.path.isfile(os.path.join(seg_path, f"{i}.npz"))]
print(f"resuming: {len(todo)} of {n_images} remain")
for lo in range(0, len(todo), batch):
    nums = todo[lo:lo + batch]
    imgs = np.stack([
        renormalize.renormalize(
            read_image_rgb(os.path.join(img_path, f"{i}.png")).astype(
                np.float32) / 255.0, "pt", "zc")
        for i in nums])
    seg = segmodel.segment_batch(torch.as_tensor(imgs, device=device))
    for i, s in zip(nums, seg.cpu().numpy()):
        np.savez_compressed(os.path.join(seg_path, f"{i}.npz"), seg=s)
assert len(os.listdir(seg_path)) == n_images
len(os.listdir(seg_path))
"""),
        ("code", """\
# aggregate the per-image files into the class-area histogram
""" + MERGE_SEGS),
    ])


def gen_folder_seg_sharded():
    return nb([
        intro("Sharded folder segmentation", "folder-segmentation-sharded",
              """\
The reference ran one analysis as four notebooks, one per shard, on
different machines (`Generic_Segmentation-Copy3-{0,1,2,3}`). Here the
shard is a parameter (`SHARD`/`NSHARDS` through
`utils.hostshard.shard_units`), and one notebook runs every shard and
merges their outputs."""),
        ("parameters", PARAMETERS),
        ("code", CHURCH),
        ("code", TINY_SEG),
        ("code", SEG_FOLDER + """\
from rewriting_torch.utils import hostshard
os.makedirs(seg_path)
sample_clean(model, params, img_path, n=n_images, batch_size=batch)
NSHARDS = 4
units = list(range(n_images))
for shard in range(NSHARDS):   # the reference ran these as 4 notebooks
    mine = hostshard.shard_units(units, shard, NSHARDS)
    for lo in range(0, len(mine), batch):
        nums = mine[lo:lo + batch]
        imgs = np.stack([
            renormalize.renormalize(
                read_image_rgb(os.path.join(
                    img_path, f"{i}.png")).astype(np.float32) / 255.0,
                "pt", "zc") for i in nums])
        seg = segmodel.segment_batch(torch.as_tensor(imgs, device=device))
        for i, s in zip(nums, seg.cpu().numpy()):
            np.savez_compressed(os.path.join(seg_path, f"{i}.npz"),
                                seg=s)
    print(f"shard {shard}/{NSHARDS}: {len(mine)} images")
assert len(os.listdir(seg_path)) == n_images
"""),
        ("code", """\
# merge all shards' outputs into one histogram (disjoint by construction)
""" + MERGE_SEGS),
    ])


def gen_face_label_stats():
    return nb([
        intro("Face-label statistics over a faces generator",
              "face-label-stats", """\
Sample from the faces model, run the BiSeNet face parser, and tabulate
per-class pixel fractions and the mouth-visibility rate that backs the
smile metric (`metrics/num_smiles.py`)."""),
        ("parameters", PARAMETERS),
        ("code", """\
import numpy as np, torch
from rewriting_torch.utils.zdataset import z_dataset_for_model
from rewriting_torch.utils.show import show
from rewriting_torch.utils import renormalize, segviz

try:
    from rewriting_torch.models.zoo import load_seq_stylegan
    model, params = load_seq_stylegan('faces', truncation=0.5,
                                      device=device)
    n_images, batch = 100, 4
except FileNotFoundError:
    from rewriting_torch.models import SeqStyleGAN2
    model = SeqStyleGAN2(size=32, style_dim=32, n_mlp=2, device=device)
    params = model.init_params(seed=0)
    n_images, batch = 16, 4
"""),
        ("code", """\
# face parser: the released BiSeNet, or a random one
from rewriting_torch.segment.faceparse import (BiSeNet, FACE_CLASSES,
                                               FaceSegmenter)
zds = z_dataset_for_model(model, n_images)
try:
    seg = FaceSegmenter(device=device)
except FileNotFoundError:
    net = BiSeNet(n_classes=19)
    seg = FaceSegmenter(params=net.init_params(seed=1), device=device)
"""),
        ("code", """\
# per-class pixel fractions over the sample (RunningMean of indicators)
from rewriting_torch.stats import RunningMean
rm = RunningMean()
sample_fn = model    # (params, z) -> (B, H, W, 3) images on the device
mouth = FACE_CLASSES.index('mouth')
classes = torch.arange(len(FACE_CLASSES), device=device)
mouth_visible = 0
segs = []
for lo in range(0, n_images, batch):
    z = zds.zs[lo:lo + batch]
    imgs = sample_fn(params, z).clamp(-1, 1)
    labels = seg.segment_batch(imgs)[:, 0]
    segs.append((imgs.cpu().numpy(), labels.cpu().numpy()))
    onehot = (labels[..., None] == classes).reshape(len(z), -1,
                                                    len(FACE_CLASSES))
    rm.add(onehot.float().mean(1))
    mouth_visible += int(((labels == mouth).float().mean((1, 2))
                          > 0.001).sum())
fracs = rm.mean().cpu().numpy()
table = sorted(zip(FACE_CLASSES, fracs), key=lambda t: -t[1])[:8]
print(f"mouth visible: {mouth_visible}/{n_images}")
table
"""),
        ("code", """\
# visualize image / face-parse pairs
imgs, labels = segs[0]
show([[renormalize.as_image(imgs[i]),
       segviz.segment_visualization(labels[i])]
      for i in range(min(3, len(imgs)))])
"""),
    ])


def gen_attribute_comparison():
    return nb([
        intro("Attribute-rate comparison across edit baselines",
              "attribute-comparison", """\
Label several directories of edited samples with an attribute
classifier and tabulate per-attribute rates and their deltas against
the clean baseline: the table behind the paper's smile and mustache
effectiveness numbers (the reference's `Generic_Label.ipynb`, cells
6-20).

The classifier is pluggable (`metrics/num_smiles.py`); this notebook
runs the face parser's mouth-visibility heuristic. Sample directories
come from `metrics/sample.py` runs; without them, the notebook writes a
clean and an edited directory of a tiny stand-in generator."""),
        ("parameters", PARAMETERS),
        ("code", """\
import os, glob, tempfile
import numpy as np
import torch

from rewriting_torch.models import SeqStyleGAN2
from rewriting_torch.metrics.sample import sample_clean
from rewriting_torch.metrics.num_smiles import mouth_heuristic_classifier
from rewriting_torch.utils.zdataset import z_dataset_for_model

# the stand-in generator of the directories below, and their depth
model = SeqStyleGAN2(size=32, style_dim=64, n_mlp=2, device=device)
params = model.init_params(seed=0)
n_images, batch = 8, 4
"""),
        ("code", """\
# directories to compare: {condition_name: image_dir}. Point these at real
# metrics/sample.py outputs (clean vs edited vs ablation) to reproduce the
# paper tables; the fallback below generates tiny stand-ins.
data = {}
if not data:
    base = tempfile.mkdtemp(prefix='attr_cmp_')
    # 'edited': perturb one mid layer's conv (a stand-in for an applied rule)
    edited = dict(params)
    k = 'layer4.sconv.mconv.dconv'
    edited[k] = {'weight': params[k]['weight'] * 1.5}
    for name, p in (('clean', params), ('edited', edited)):
        d = os.path.join(base, name)
        sample_clean(model, p, d, n=n_images, batch_size=batch)
        data[name] = d
data
"""),
        ("code", """\
# label every directory: classifier(images_zc) -> (B, n_attr) bools
from rewriting_torch.utils import renormalize
import PIL.Image

# with $REWRITING_TPU_WEIGHTS populated this uses the published BiSeNet
# face parser; the random-weight fallback keeps the workflow executable
try:
    classifier = mouth_heuristic_classifier(device=device)
except FileNotFoundError:
    from rewriting_torch.segment.faceparse import BiSeNet
    net = BiSeNet(n_classes=19)
    classifier = mouth_heuristic_classifier(
        params=net.init_params(seed=0), device=device)
attrs = ['mouth_visible']   # a SlimNet-style classifier has 40 of these

def label_dir(d, batch=batch):
    files = sorted(glob.glob(os.path.join(d, '**', '*.png'), recursive=True))
    rates = []
    for lo in range(0, len(files), batch):
        imgs = np.stack([renormalize.from_image(PIL.Image.open(f))
                         for f in files[lo:lo + batch]])
        out = np.atleast_2d(classifier(imgs).cpu().numpy())
        if out.shape[0] != len(imgs):
            out = out.T
        rates.append(out.astype(np.float64))
    return np.concatenate(rates, 0)  # (n_images, n_attr)

info = {name: label_dir(d) for name, d in data.items()}
{k: v.shape for k, v in info.items()}
"""),
        ("code", """\
# per-attribute rates and deltas vs the clean condition
import pandas as pd
baseline = info['clean'].mean(0)
rows = []
for name, m in info.items():
    rate = m.mean(0)
    rows.append({'condition': name,
                 **{a: rate[i] for i, a in enumerate(attrs)},
                 **{f'delta_{a}': rate[i] - baseline[i]
                    for i, a in enumerate(attrs)}})
table = pd.DataFrame(rows).set_index('condition')
table
"""),
        ("code", """\
# the same rates via the metric-pipeline entry point (count_smiles is
# the CLI the experiments DAG calls on sample dirs)
from rewriting_torch.metrics.num_smiles import count_smiles
{name: count_smiles(d, n=n_images, batch_size=batch, classifier=classifier)
 for name, d in data.items()}
"""),
    ])


def gen_ffhq_label():
    return nb([
        intro("Attribute statistics over an image folder (FFHQ-style)",
              "ffhq-label-stats", """\
Run the SlimNet CelebA attribute classifier over a directory of face
images and tabulate per-attribute frequencies, plus a single-image
inspection cell (the reference's `FFHQ_Label.ipynb`). It uses the real
`celeba_20.pth` checkpoint when `$REWRITING_TPU_WEIGHTS` provides it,
else a randomly initialized SlimNet (frequencies are then arbitrary but
the whole pipeline runs)."""),
        ("parameters", PARAMETERS),
        ("code", """\
import numpy as np, torch, os, tempfile
from rewriting_torch.metrics.sample import sample_clean

# the faces to analyze: real faces if a faces model is present, else
# tiny random renders
try:
    from rewriting_torch.models.zoo import load_seq_stylegan
    model, params = load_seq_stylegan('faces', truncation=0.5,
                                      device=device)
    n_images, batch = 100, 10
except FileNotFoundError:
    from rewriting_torch.models import ProgressiveGenerator
    model = ProgressiveGenerator(sizes=[16, 16, 8, 8], device=device)
    params = model.init_params(seed=0)
    n_images, batch = 24, 8
"""),
        ("code", """\
from rewriting_torch.metrics import slimnet
from rewriting_torch.models.zoo import weights_dir

ckpt = os.path.join(weights_dir(), "celeba_20.pth")
if os.path.isfile(ckpt):
    clf = slimnet.SlimNetClassifier(checkpoint=ckpt, device=device)
else:
    clf = slimnet.SlimNetClassifier(
        state_dict=slimnet.init_random_state_dict(0), device=device)
len(slimnet.CELEBA_ATTRS)
"""),
        ("code", """\
# an image folder of the faces
img_path = os.path.join(tempfile.mkdtemp(), 'faces')
sample_clean(model, params, img_path, n=n_images, batch_size=batch)
len(os.listdir(img_path))
"""),
        ("code", """\
# per-attribute frequency over the folder (sigmoid > 0.5 per attribute,
# the reference's criterion)
from rewriting_torch.native import read_image_rgb
from rewriting_torch.utils import renormalize
freq = np.zeros(len(slimnet.CELEBA_ATTRS), np.int64)
for lo in range(0, n_images, batch):
    imgs = np.stack([
        renormalize.renormalize(
            read_image_rgb(os.path.join(img_path, f"{i}.png")).astype(
                np.float32) / 255.0, "pt", "zc")
        for i in range(lo, min(lo + batch, n_images))])
    probs = torch.sigmoid(clf.logits(imgs))
    freq += (probs > 0.5).sum(0).cpu().numpy()
rows = sorted(zip(slimnet.CELEBA_ATTRS, freq), key=lambda t: -t[1])
[(a, int(c), f"{100 * c / n_images:.0f}%") for a, c in rows[:12]]
"""),
        ("code", """\
# single-image inspection (the reference's PATH_TO_IMAGE cell)
img = renormalize.renormalize(
    read_image_rgb(os.path.join(img_path, "0.png")).astype(
        np.float32) / 255.0, "pt", "zc")
probs = torch.sigmoid(clf.logits(img[None]))[0].cpu().numpy()
pred = [slimnet.CELEBA_ATTRS[i] for i in np.where(probs > 0.5)[0]]
print("image 0 attributes:", pred)
print("smiling prob:", float(probs[slimnet.SMILING]))
"""),
    ])


# in the order of notebooks/stats/'s families
GENERATED = {
    "segmentation-stats.ipynb": gen_segmentation_stats,
    "segmentation-stats-dome2tree.ipynb": gen_dome2tree,
    "segmentation-stats-comparison.ipynb": gen_comparison,
    "dome-area-profile.ipynb": gen_area_profile,
    "folder-segmentation.ipynb": gen_folder_seg,
    "folder-segmentation-resumable.ipynb": gen_folder_seg_resumable,
    "folder-segmentation-sharded.ipynb": gen_folder_seg_sharded,
    "face-label-stats.ipynb": gen_face_label_stats,
    "attribute-comparison.ipynb": gen_attribute_comparison,
    "ffhq-label-stats.ipynb": gen_ffhq_label,
}


def main():
    os.makedirs(OUT, exist_ok=True)
    for name, gen in GENERATED.items():
        path = os.path.join(OUT, name)
        with open(path, "w") as f:
            f.write(dumps(gen()))
        print(path)


if __name__ == "__main__":
    main()
