#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``rewriting_torch/csrc`` with nvcc
(one process per source, all at once), holds each kernel against its
plain PyTorch version on the card at the shapes its path gives it, compares
a full-width church-256 forward on the card with the same forward on the
CPU, and drives the port's paths end to end, each with the launch counts
set to 0 just before it and read just after:

- the edit loop of the paper: the 1000-z key statistics at layer 8, the
  ``dome2tree`` edit request (rank 1, 2001 Adam steps), edited renders,
  revert (the FIR blur K2);
- the 2x upsample op ``upsample2d`` on wide maps (K3), which no model
  path reaches;
- church-256 sampling through ``sample_clean`` and ``pipeline_fast`` in
  the three modes of K1's gate (off, the default; on, which takes the
  256-pixel layer; on with ``min_res=0``, all six up-conv layers), and the
  port's PNG files decoded against a direct render;
- ``sample_edited``: the dome2tree edit, then 32 samples of the edited
  model;
- an edit at the upsampling layer 7, whose solve runs K2's backward;
- a checkpoint file: the params written under rosinality's key names as
  ``stylegan2_church.pt`` in a temporary directory, loaded back through
  ``models/zoo.py`` bit for bit, then the two command lines
  ``python3 -m rewriting_torch.metrics.sample --dataset church --n 32``
  and ``python3 -m rewriting_torch.metrics.sample_edited --mask dome2tree
  --n 16``, each in its own process, on that file;
- the server's solves at layer 7 on the dome2tree goal: ``insert`` and
  ``linear_insert`` (201 steps) and ``fast_linear_insert`` (2001), their
  seconds a step, the fast and the direct Λ·D solve held together;
- at layer 8, ``apply_erase``, ``zero``, the svd and mean keys, the
  renders (plain, with the query key outlined, an object with its box),
  and 201-step edits in the Pre and Tiny windows;
- ProgGAN church-256 at its published widths: seeded weights written as a
  reference-format ``.pth`` under the old ``features.N`` names, loaded by
  ``zoo.load_proggan`` bit for bit, the card's forward against the CPU's,
  then ``ProgressiveGanRewriter.apply_edit`` of ProgGAN's spire2tree
  (1000-z statistics, 2001 steps); no kernel is on this path;
- four edit requests solved as one batch at layer 7
  (``rewrite/multi.batch_apply_edits``, 1001 steps, one K2 forward and
  backward a step for all four), twice (bit for bit), against two of them
  solved alone with cuDNN's deterministic and its default algorithms,
  their previews (batched and one edit at a time) and the edited params
  through ``utils/paramio``;
- ``InstrumentedPipeline``: layer 8's retained keys against the
  rewriter's, a per-channel ablation against a zeroing rule;
- the §5.2 watermark erase (``metrics/watermark.py``): statistics of the
  truncation-1.0 model, two 2001-step erases of the truncation-0.5 one,
  64 images; then ``python3 -m rewriting_torch.metrics.watermark`` in its
  own process on the checkpoint file;
- the solves repeat: ``fast_linear_insert`` (1001 steps) and ``insert``
  (201) at layer 7, and both (201) at layer 8, run twice bit for bit with
  cuDNN's deterministic algorithms, timed in turns against its default
  ones;
- the quantile sketch: 256k rows x 512 units on the card and the CPU, the
  same level buffers; the adversarial stream's 0.001 rank bound;
- the watermark erase by GANdissect's baseline (the units of the key
  selections' quantile ranks over a sketch of 1000 z, zeroed);
- Search: ``ranking_for_key`` at layer 8 over 1000 z against a direct
  ranking, and the renders with the key outlined;
- ``dissect`` of ProgGAN church-256 ``layer4`` over 400 z upsampled to
  64x64, with a toy segmenter (phase 28 runs the real one); no kernel
  on this path;
- the all-weights "overfit" baseline (``apply_overfit``, 201 steps, plain
  and with a seeded VGG16's relu3_3 features): K2 forward and backward at
  all six upsampling layers a step; then ``compute_dl`` (l1, LPIPS) of the
  clean against the edited PNGs;
- the metric networks and segmenters on seeded weights written under the
  released file names (``write_seeded_weights``) and read through
  ``$REWRITING_TPU_WEIGHTS``: FID (the pytorch-fid Inception at 299
  pixels; decode and Inception rates, ``compute_fid`` of the clean against
  the edited PNGs and of a set with itself, card against CPU features,
  ``get_fid.model_stats`` over 256 z of church-256, the ``fid`` and
  ``get_fid --compare`` command lines); ``load_segmenter("netpqc")``
  (UPerNet-50 at the released head widths with all parts and quads,
  merged with the colour segmenter) and the face parser, card against
  CPU, ``predict_single_class``; the smile count with the mouth heuristic
  and with SlimNet; ``python3 -m rewriting_torch.dissect`` of phase 15's
  checkpoint at ``layer4`` with ``--seg netpqc``.  No kernel is on these
  paths but the blur (K2) of ``model_stats``'s sampling;
- the editing server over a layer-8 rewriter of the checkpoint file, in a
  thread, over a real socket: status, previews against the in-process
  render, the dome2tree edit (bit for bit the same edit made in this
  thread), the fast and erase solves, four edits as one batch with their
  previews, commit, revert, save, the error answers; then ``python3 -m
  rewriting_torch.serve`` in its own process; then the notebook app
  (``GanRewriteApp``) headless: pick, paste, key, execute, toggle,
  search, revert;
- the paper's metric pipeline: ``seg_stats`` with netpqc over the clean
  and edited PNGs, ``seg_correct_mod``, and ``run_fused`` (sample,
  segment and FID features in one pass) against the staged chain; the
  experiment DAG's church chain (sample, edit, segment, correct,
  distances), each stage a child process; the patch FID sweep at layer 8
  against phase 5's edit, FID statistics of real images and the
  generated samples.  K2 runs in every served render and edit, the UI's
  canvases, the fused pass and the patch renders;
- the multi-device paths (``rewriting_torch/parallel``), each job a set
  of child processes on this card: one rank on NCCL (``sample_clean``
  with a mesh against phase 9's PNGs, the layer-8 rewriter's sharded key
  moment against phase 5's, the four edits of phase 16 with a mesh
  against its losses, tp and GPipe at one rank), then 2 and 4 ranks
  sharing the card over gloo (dp sampling, the sharded moment, the edits
  over 2 ranks, tp 2- and 4-way with K1's gate off and on, dp x sp 1x2,
  2x2 and 1x4, GPipe of the 8-layer style MLP over 2 and 4 stages), each
  rank's K1, K2 and K3 launches, the collectives built from all-reduces
  (``comm.built``; 0 on NCCL) and its seconds, which are ranks sharing one
  card and not a scaling figure;
- faces-1024 (StyleGAN2, ``channel_multiplier=2``) from a seeded
  ``stylegan2_faces.pt`` loaded through the zoo, batch 8:
  ``pipeline_fast`` with its s2d tail, ``fused=True`` (K2 after the
  subpixel up-convs) and K1 on at every layer against the seq pipeline;
  the recommended schedule, an int8 schedule (``_int_mm`` at the dconvs)
  and a "default" schedule from 256 px with K1 on (its one-pass bf16
  kernel, ``csrc/upconv_blur_bf16.cu``)
  against "highest", PSNR beside a floor, images/s of each; K1's bf16
  mode against its plain version and timed; an edit bit for bit with and
  without an int8 schedule on every stage; the RGB skip upsample's two
  forms timed;
- ProgGAN celebhq-1024 from a seeded ``proggan_celebhq-620d161c.pth``:
  its s2d tail against the seq stages, its mixed schedule against
  "highest";
- each encoder and decoder of ``SemanticSegmenter`` on seeded weights,
  the card against the CPU over phase 9's PNGs;
- the Neural Best Buddies copy-paste baseline (``baselines/nbb.py``) on
  two of phase 9's PNGs at VGG16's full widths: ``neural_best_buddies``
  with 10 pairs a level on the card and on the CPU, the pyramids and
  every level's mappings held together (a near-tie of the top two
  candidates may swap), then ``nbb_paste`` with its defaults on the card,
  copying the dome2tree request's object region, each level's counts and
  each stage's seconds.  No kernel is on this path;
- the sharded samplers at faces-1024 (``parallel/``), 4 ranks sharing the
  card over gloo in a child job: K1 and its one-pass mode against their
  plain versions at the slab shapes the spatial bands give them; the
  1 x 4 and 2 x 2 bands with K1's gate on at every layer, and under the
  "default" schedule from 256 px, against one device's
  ``pipeline_fast``; the int8 schedule on dp, tp and the 1 x 4 bands
  against one device's, each quantization's int8 values counted; each
  rank's launches and seconds, which are ranks sharing one card;
- JPEG reading (``csrc/jpegdec.cpp``, host C++ built with the host
  compiler at first use): each fixture of ``tests/data/jpeg`` against
  PIL's decode of it stored as a PNG, 0 LSB apart; ``read_batches``
  images/s of a 256x256 4:2:0 JPEG (on its default pool and on one
  thread) and of its PNG twin, one decode's ms; FID's statistics
  (phase 25's seeded Inception) and ``get_gt_samples`` of a directory of
  64 JPEGs against the same pixels as PNGs; a truncated JPEG refused by
  name, a CMYK one read as PIL reads it; every file of
  ``tests/data/images`` (palette, 1/2/4/16-bit and interlaced PNG, WebP,
  BMP, GIF, 4:1:1 and multi-scan JPEG ...) through ``read_image_rgb``,
  ``read_image`` and ``read_batches`` against PIL's decode on the card's
  host, 0 values apart.  No kernel is on this path;
- the port's twelve notebooks (``notebooks/torch/``), read as JSON and
  run cell by cell in one namespace with no Jupyter, each on its
  released-checkpoint branch (seeded files under the released names:
  phase 12's church-256, phase 34's faces-1024, phase 25's SlimNet, face
  parser and netpqc, and a ProgGAN kitchen-256): the editing interface
  (1000 z, the 2001-step dome2spire edit at layer 8, nine canvases; it
  must launch K2), the reflection study (its renders held against the
  same cells on the CPU) and the ten stats notebooks, cut to 24 images;
  each notebook's seconds, launches and whether its results are finite;
- the published files downloaded on a miss: a loopback HTTP server laid
  out as the publication servers serves phase 12's church-256 checkpoint,
  phase 15's ProgGAN church in the legacy serialization, the repo's
  ``dome2tree.json`` and phase 25's files; with empty weights and masks
  directories the zoo, the mask registry and
  ``scripts/torch_fetch_weights.py`` fetch them byte for byte, the
  downloaded church-256 samples 16 z (K2), and a file the server lacks
  raises naming its URL.

K2 has two kernels: the separable row-band kernel, which every path runs
(the model's blur taps are rank 1), and the general k x k kernel for taps
that are not; both are held against the plain version, forward and
backward, and no path may launch the general one.  K3 likewise has a separable
polyphase kernel, which ``upsample2d`` must take, and a general one, held
on a rank-2 kernel; it is timed at each of ``UP2_SHAPES``, in turns with
the general kernel.

Weights are random, drawn from a seed.  Every phase prints one line with
its elapsed seconds; any failure raises and exits non-zero.  The
second-to-last line is a JSON object with each kernel's launches on its
path, its error against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.

Without CUDA, or without the ``rewriting_torch`` package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MASKS = os.path.join(ROOT, "notebooks", "masks", "stylegan")
MASK = os.path.join(MASKS, "church", "dome2tree.json")

# H100 SXM data sheet: device memory rate, fp32 (non-tensor-core) peak and
# the dense TF32 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

BLUR_TOL = 1e-5        # K2 and its backward vs plain version, absolute
UPCONV_RTOL = 1e-5     # K1 vs plain, of max |plain| (tests/test_pallas.py)
UP2_TOL = 1e-5         # K3 vs plain version, absolute
FORWARD_RTOL = 1e-4    # card vs CPU forward and fast vs seq, of max |ref|
SPAN_TOL = 1e-4        # weight change outside span(D), relative
# the fast and the direct linear insert's first 201 losses, absolute: the
# same Λ·D trajectory with the conv split by linearity (measured 1.2e-7 on
# an H100 at layer 7, 4.5e-8 on the CPU at 32 px)
FAST_LINEAR_TOL = 1e-5

BLUR_TAPS = (1, 3, 3, 1)
# (C, H) of the blur inputs on the church-256 path: after the up-convs of
# layers 3, 5, 7, 9, 11 and 13, (2h+1)-square maps
MAIN_SHAPES = ((512, 9), (512, 17), (512, 33), (512, 65), (256, 129),
               (128, 257))
# (N, C, H, W, pad): pads (1,1) and (2,1), odd and prime sizes, narrow C
EDGE_CASES = ((2, 128, 32, 32, (2, 1)), (2, 64, 33, 33, (1, 1)),
              (1, 8, 16, 16, (2, 1)), (1, 8, 35, 35, (1, 1)),
              (1, 8, 18, 18, (1, 1)), (1, 64, 12, 20, (1, 1)))
# (I, H, O) of K1 on the church-256 path: layers 3 .. 13
UPCONV_SHAPES = ((512, 4, 512), (512, 8, 512), (512, 16, 512),
                 (512, 32, 512), (512, 64, 256), (256, 128, 128))
# phase 15: ProgGAN church-256's edit (no TPU kernel on its path)
PROGGAN_MASK = os.path.join(ROOT, "notebooks", "masks", "proggan", "church",
                            "spire2tree.json")
PROGGAN_LAYER = 5     # the 512-channel 16x16 conv
# phase 16: the requests solved as one batch at layer 7
BATCH_REQUESTS = ("dome2tree", "sky2tree", "spire2tree", "tree2building")
# the batch, run twice, must repeat bit for bit (the solves run cuDNN's
# deterministic algorithms); against each edit solved alone it is held
# within 3x the gap between that single solve under cuDNN's default
# algorithms and under its deterministic ones, measured in the same call
# (the largest of BATCH_DEFAULT_RUNS default runs: one run's gap is a
# single draw of the rounding noise, and the share below read 0.011 on
# one run and 0.111 on another, so one draw can fall far below the noise
# the batch's own rounding makes), plus a floor: the final losses
# (BATCH_LOSS_TOL, absolute) and the share
# of the single solve's change in the window output's L1 to the goal that
# the batch makes (|1 - share|, BATCH_OUTPUT_FLOOR; a batch that changed
# nothing reads 0; on seeded weights the change is a rise: the solves end
# above the unedited output's L1).  The norm of the output's difference
# relative to the edit's change is printed, not held: two sound solves
# read 1.2-1.4 on it, further apart than a batch that changed nothing
# (1.0).  The weights are printed, not held: element by element they
# differ by whole Adam steps, since L1's sign and Adam's first step turn
# rounding in a near-0 gradient into a step of lr, and the batch's
# grouped convolutions round otherwise than one edit's
# (scripts/probe_solve_determinism.py)
BATCH_LOSS_TOL = 1e-4
BATCH_OUTPUT_FLOOR = 0.05
BATCH_DEFAULT_RUNS = 3
# the solves' steps in phases 16 and 33 (whose losses are held to phase
# 16's), and phase 19's layer-7 fast solve: 2001 until phase 40 came
BATCH_STEPS = 1001
DISSECT_SIZE = 400      # phase 23's z (1000 until then)
# phase 18: the erase's units, as the paper's watermark.sh runs it (30
# and 60; the command line's default, 1, is one unit of the 512, and on
# seeded weights its goal lies so near the unedited output that the
# solve's first steps of lr raise the loss); the command line's request
# names images below its 100 z
WATERMARK_DRANK = 30
WATERMARK_CLI_REQUEST = "building2sky"
# (N, C, H, W, taps) of K3: the wide maps upsample2d sends it, and edges
UP2_SHAPES = ((16, 512, 32, 32), (16, 256, 64, 64), (16, 128, 128, 128))
UP2_EDGES = ((2, 64, 33, 17, (1, 3, 3, 1)), (1, 64, 5, 7, (1, 2, 1)),
             (1, 72, 9, 9, (1, 1)), (1, 64, 16, 16, (1, 2, 3, 1)))


def sync(device) -> None:
    """Wait for the card, where `device` is one."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.time() - t0:.3f} s", flush=True)


@contextlib.contextmanager
def default_algorithms():
    """The solves run with cuDNN's default algorithms within (the port's
    ``precision.deterministic`` made a no-op): the yardstick of phases 16
    and 19."""
    from rewriting_torch.ops import precision
    pinned = precision.deterministic
    precision.deterministic = contextlib.nullcontext
    try:
        yield
    finally:
        precision.deterministic = pinned


def time_ms(torch, fn, runs: int = 25, warmup: int = 3) -> float:
    """Median over `runs` of one call's stream span: the time between CUDA
    events recorded before and after it, gaps while the host launches
    included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what sets it): the bytes over the memory rate
    or the operations over the fp32 peak, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def blur_bound_ms(x_shape, y_shape, k: int):
    """Least time for the blur: each input read once, each output written
    once, at the memory rate; or its FMAs at the fp32 peak."""
    nx = y_numel = 1
    for d in x_shape:
        nx *= d
    for d in y_shape:
        y_numel *= d
    return bound_ms(4.0 * (nx + y_numel), 2.0 * k * k * y_numel)


def _upconv_counts(b, i, h, o, w=None):
    """K1 with its epilogue on (b, i, h, w) maps (w = h by default):
    (bytes, MACs of the conv, outputs).  x, the weights, demod, noise and
    bias are read once, the output written once; the conv does 9 MACs per
    (input pixel, I, O)."""
    w = h if w is None else w
    outputs = b * o * 4 * h * w
    nbytes = 4.0 * (b * i * h * w + 9 * i * o + b * o + 4 * h * w + o
                    + outputs)
    return nbytes, 9.0 * i * o * h * w * b, outputs


def upconv_bound_ms(b, i, h, o):
    """K1's least time at the parity tier: the conv's products on the
    tensor cores as 3xTF32 (3 * 2 * MACs at the TF32 peak), plus the blur
    (8 MACs an output: its taps are always an outer product, so it is
    separable) and the epilogue (5 operations an output: the demod-noise
    FMA, the bias add, the leaky slope and the sqrt(2) gain) at the fp32
    peak; or the bytes, whichever is larger."""
    nbytes, macs, outputs = _upconv_counts(b, i, h, o)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (3 * 2.0 * macs / TF32_FLOPS_PER_S
              + (2.0 * 8 + 5) * outputs / FP32_FLOPS_PER_S) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def upconv_bound_fp32_ms(b, i, h, o):
    """The same work with every operation at the fp32 peak (the bound of
    the first, FFMA version of K1)."""
    nbytes, macs, outputs = _upconv_counts(b, i, h, o)
    return bound_ms(nbytes, 2.0 * macs + (2.0 * 8 + 5) * outputs)


def library_up_kernel(torch, wf, kf):
    """(I, O, 6, 6): the transposed conv's weight ``flip(wf)`` (I, O, 3, 3)
    fully convolved with the blur ``outer(kf, kf)`` in FIR orientation, so
    that one ``conv_transpose2d`` with stride 2 and padding 2 computes K1's
    function before the epilogue: a yardstick, used nowhere in the port."""
    w = torch.flip(wf, (2, 3)).transpose(0, 1)
    k2 = torch.outer(torch.tensor(kf), torch.tensor(kf))
    w6 = w.new_zeros(w.shape[:2] + (6, 6))
    for a in range(4):
        for c in range(4):
            w6[:, :, a:a + 3, c:c + 3] += w * float(k2[a, c])
    return w6.contiguous()


def library_upconv(torch, x, w6):
    """The one-call yardstick: (B, O, 2H, 2W)."""
    return torch.nn.functional.conv_transpose2d(x, w6, stride=2, padding=2)


def composite_up_kernel(torch, wf, kf):
    """(4O, I, 3, 3) per-phase taps of blur(convT(x, w)) over the
    undilated input, phase-major channels (the JAX package's
    ``_composite_up_kernel``, models/stylegan2.py:378-397): a yardstick,
    used nowhere in the port."""
    o, i = wf.shape[:2]
    k2 = torch.outer(torch.tensor(kf), torch.tensor(kf)).flip((0, 1))
    comp = wf.new_zeros((o, i, 6, 6))
    for by in range(4):
        for bx in range(4):
            comp[:, :, by:by + 3, bx:bx + 3] += wf * float(k2[by, bx])
    idx = torch.tensor([[1, 3, 5], [0, 2, 4]], device=wf.device)
    k = comp[:, :, idx, :][:, :, :, :, idx]             # (O, I, p, 3, q, 3)
    return k.permute(2, 4, 0, 1, 3, 5).reshape(4 * o, i, 3, 3)


def composite_upconv(torch, x, comp):
    """Yardstick (b): one F.conv2d with the composite kernel, then the
    phase interleave, (B, O, 2H, 2W)."""
    b, _, h, w = x.shape
    o = comp.shape[0] // 4
    ph = torch.nn.functional.conv2d(x, comp, padding=1)  # (B, 4O, H, W)
    ph = ph.reshape(b, 2, 2, o, h, w).permute(0, 3, 4, 1, 5, 2)
    return ph.reshape(b, o, 2 * h, 2 * w)


def up2_library(torch, x, kernel):
    """K3's yardstick: a depthwise stride-2 conv_transpose2d with the
    unflipped taps and padding 1 (4-tap FIRs with pad (2, 1))."""
    c = x.shape[1]
    w = torch.from_numpy(kernel).to(x.device).expand(c, 1, 4, 4)
    return torch.nn.functional.conv_transpose2d(x, w.contiguous(), stride=2,
                                                padding=1, groups=c)


def up2_bound_ms(x_shape, k: int):
    """Least time for K3: each input read once, each (2H, 2W) output
    written once, at the memory rate; or about k FMAs an output (k/2
    along each axis, the taps being separable) at the fp32 peak."""
    nx = 1
    for d in x_shape:
        nx *= d
    return bound_ms(4.0 * 5 * nx, 2.0 * k * 4 * nx)


def general_up2(torch, kup2, x, taps):
    """K3's general kernel on any taps, its launcher called straight
    (uncounted), to hold it against the plain version where the wrapper
    would take the separable kernel."""
    n, c, h, w = x.shape
    y = torch.empty((n, c, 2 * h, 2 * w), device=x.device)
    rc = kup2.library().upsample2x_f32(
        x.data_ptr(), y.data_ptr(), n * c, h, w, taps.pad[0], taps.k,
        taps.taps_ptr, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"general upsample2x kernel: CUDA error {rc}")
    return y


def rank2_kflip(np):
    """A 4x4 blur whose taps are not rank 1 (the sum of two outer
    products): the general kernel's case."""
    k = (np.outer([1, 3, 3, 1], [1, 2, 2, 1])
         + np.outer([2, 0, 1, 1], [0, 1, 3, 1]))
    return (k / 40.0).astype(np.float32)


def general_blur(torch, kblur, x, taps):
    """K2's general k x k kernel on any taps, its launcher called
    straight (uncounted), to hold it against the plain version where the
    wrapper would take the separable kernel."""
    n, c, h, w = x.shape
    shape = kblur.output_shape(x.shape, taps.k, taps.pad)
    y = torch.empty(shape, device=x.device)
    rc = kblur.library().blur2d_f32(
        x.data_ptr(), y.data_ptr(), n * c, h, w, shape[2], shape[3],
        taps.pad[0], taps.k, taps.taps_ptr,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"general blur2d kernel: CUDA error {rc}")
    return y


def check_upsample2x(torch, np, gen) -> dict:
    """K3 on the card: both kernels against the plain version at
    ``UP2_SHAPES`` and ``UP2_EDGES`` (make_kernel taps, which must take
    the separable kernel) and on two rank-2 kernels (the general one);
    the times at each of ``UP2_SHAPES``, the general kernel and the
    separable one in turns; then ``upsample2d`` on the wide maps, which
    must launch the separable kernel once each.  Returns K3's entry of
    the kernels line; raises on any failure."""
    from rewriting_torch.ops import make_kernel
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.upfirdn2d import upsample2d

    rank2 = rank2_kflip(np)
    max_err = gen_err = 0.0
    up2_rows = []
    cases = []
    for n, c, h, w, taps in [s + ((1, 3, 3, 1),) for s in UP2_SHAPES] + \
            list(UP2_EDGES):
        kern = make_kernel(list(taps)) * 4.0
        k = kern.shape[0]
        p = k - 2
        pad = ((p + 1) // 2 + 1, p // 2)
        cases.append((n, c, h, w, np.ascontiguousarray(np.flip(kern, (0, 1))),
                      pad, kern))
    cases += [(1, 64, 12, 20, rank2, (2, 1), None),
              (16, 128, 32, 32, rank2, (2, 1), None)]
    kup2.launches = kup2.general_launches = 0
    for n, c, h, w, kflip, pad, kern in cases:
        x = torch.randn((n, c, h, w), generator=gen, device="cuda")
        taps = kup2.up2_taps(kflip, pad)
        got = kup2.upsample2x_cuda(x, taps, pad)
        want = kup2.upsample2x_reference(x, taps, pad)
        general = general_up2(torch, kup2, x, taps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        gerr = float((general - want).abs().max())
        max_err, gen_err = max(max_err, err), max(gen_err, gerr)
        path = "general" if taps.phases is None else "separable"
        print(f"upsample2x {(n, c, h, w)} k{taps.k} pad {pad} -> "
              f"{tuple(got.shape)}: {path} kernel max abs diff {err:.3e}, "
              f"general kernel {gerr:.3e}")
        if tuple(got.shape) != (n, c, 2 * h, 2 * w) or \
                not max(err, gerr) <= UP2_TOL:
            raise AssertionError(f"upsample2x kernels differ from their "
                                 f"plain version by {err}, {gerr}")
        if (kern is None) != (taps.phases is None):
            raise AssertionError(f"upsample2x took the {path} kernel for "
                                 f"{'rank-2' if kern is None else 'rank-1'} "
                                 "taps")
        if (n, c, h, w) in UP2_SHAPES and kern is not None:
            lib = up2_library(torch, x, kern)
            lerr = float((lib - want).abs().max())
            if not lerr <= UP2_TOL:
                raise AssertionError(f"conv_transpose2d yardstick differs "
                                     f"by {lerr}")
            del lib
            # the general kernel and the separable one in turns
            t = [time_ms(torch, f) for f in (
                lambda: general_up2(torch, kup2, x, taps),
                lambda: kup2.upsample2x_cuda(x, taps, pad),
                lambda: kup2.upsample2x_cuda(x, taps, pad),
                lambda: general_up2(torch, kup2, x, taps))]
            p_ms = time_ms(torch, lambda: kup2.upsample2x_reference(
                x, taps, pad))
            l_ms = time_ms(torch, lambda: up2_library(torch, x, kern))
            bound, by = up2_bound_ms(x.shape, taps.k)
            up2_rows.append({"shape": [n, c, h, w], "ms": (t[1] + t[2]) / 2,
                             "ms_turns": t[1:3], "general_ms": (t[0] + t[3])
                             / 2, "general_ms_turns": t[::3],
                             "plain_ms": p_ms, "library_ms": l_ms,
                             "bound_ms": bound, "bound_by": by})
            print(f"upsample2x time {(n, c, h, w)}: separable kernel "
                  f"(upsample2x_cuda) {t[1]:.4f} / {t[2]:.4f} ms, general "
                  f"kernel {t[0]:.4f} / {t[3]:.4f} ms, plain {p_ms:.4f} ms, "
                  f"conv_transpose2d depthwise {l_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by})")
        del x, got, want, general
    print(f"upsample2x launches on the checks: {kup2.launches}, of the "
          f"general kernel {kup2.general_launches} (the rank-2 cases)")
    if kup2.general_launches != 2:
        raise AssertionError("the rank-2 checks did not launch K3's general "
                             "kernel")
    print(json.dumps({"upsample2x_rows": up2_rows}))
    # the path: the public op upsample2d on the wide maps
    maps = [torch.randn(s, generator=gen, device="cuda") for s in UP2_SHAPES]
    kup2.launches = kup2.general_launches = 0
    outs = [upsample2d(m, make_kernel(list(BLUR_TAPS))) for m in maps]
    up2_launches, up2_general = kup2.launches, kup2.general_launches
    torch.cuda.synchronize()
    print(f"upsample2x launches on ops.upsample2d over {len(maps)} wide "
          f"maps: {up2_launches}, of the general kernel {up2_general}")
    if up2_launches != len(maps):
        raise AssertionError("upsample2d did not launch K3 on wide maps")
    if up2_general != 0:
        raise AssertionError("upsample2d launched K3's general kernel")
    del maps, outs
    head = up2_rows[-1]
    return {
        "name": "upsample2x", "route": "cuda",
        "source": "rewriting_torch/csrc/upsample2x.cu",
        "replaces": "rewriting_tpu/ops/pallas_upfirdn.py:162 "
                    "(upsample2x_pallas :150)",
        "path": "rewriting_torch.ops.upfirdn2d.upsample2d on maps of >= 64 "
                "channels", "launches": up2_launches,
        "general_launches": up2_general, "max_abs_err": max_err,
        "general_max_abs_err": gen_err, "at": head["shape"],
        "ms": head["ms"], "general_ms": head["general_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "rows": up2_rows}


def rosinality_checkpoint(model, params) -> dict:
    """``{"g_ema": state dict, "latent_avg": ...}`` of the port's params
    under rosinality's key names, FIR buffers and ``noises.*`` included: the
    inverse of ``models.stylegan2._seq_names_from_rosinality``, as a
    published checkpoint file holds it.  CPU tensors."""
    import numpy as np
    import torch

    from rewriting_torch.ops import make_kernel

    def cpu(t):
        return t.detach().cpu().clone()

    # rosinality keeps the FIR of an up-conv and of the rgb upsample as
    # make_kernel(blur_kernel) times the factor squared
    fir = torch.from_numpy(np.array(make_kernel(model.blur_kernel) * 4.0,
                                    np.float32))
    sd = {}
    for i in range(1, model.n_mlp + 1):
        for name in ("weight", "bias"):
            sd[f"style.{i}.{name}"] = cpu(params[f"style.{i}"][name])
    sd["input.input"] = cpu(params["input"]["input"])
    for name, buf in params["noises"].items():
        sd[f"noises.{name}"] = cpu(buf)
    for n in range(2, model.num_layers + 2):
        prefix = "layer2.conv" if n == 2 else f"layer{n}.sconv"
        head = "conv1" if n == 2 else f"convs.{n - 3}"
        sd[f"{head}.conv.weight"] = cpu(params[f"{prefix}.mconv.dconv"]
                                        ["weight"])
        for name in ("weight", "bias"):
            sd[f"{head}.conv.modulation.{name}"] = cpu(
                params[f"{prefix}.mconv.modulation"][name])
        if n % 2 == 1:
            sd[f"{head}.conv.blur.kernel"] = fir.clone()
        sd[f"{head}.noise.weight"] = cpu(params[f"{prefix}.noise"]["weight"])
        sd[f"{head}.activate.bias"] = cpu(params[f"{prefix}.activate"]
                                          ["bias"])
    for j in range(1, model.log_size):
        rgb = params[f"to_rgb{j}.rgb"]
        head = "to_rgb1" if j == 1 else f"to_rgbs.{j - 2}"
        if j > 1:
            sd[f"{head}.upsample.kernel"] = fir.clone()
        sd[f"{head}.conv.weight"] = cpu(rgb["weight"])
        for name in ("weight", "bias"):
            sd[f"{head}.conv.modulation.{name}"] = cpu(
                rgb["modulation"][name])
        sd[f"{head}.bias"] = cpu(rgb["bias"]).reshape(1, 3, 1, 1)
    return {"g_ema": sd,
            "latent_avg": cpu(params["latents"]["latent_avg"])}


# runs a module's command line as ``python3 -m`` does, then prints the
# kernels' launch counts of that process as one JSON line
CLI_WRAPPER = """
import json, runpy, sys
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
from rewriting_torch.ops import blur2d, upconv_blur, upsample2x
print("launches " + json.dumps({
    "k2": blur2d.launches, "k2_backward": blur2d.backward_launches,
    "k2_general": blur2d.general_launches, "k1": upconv_blur.launches,
    "k3": upsample2x.launches}))
"""


def run_cli(module: str, args, cwd: str, env: dict) -> dict:
    """Run ``python3 -m module args`` (through CLI_WRAPPER) in `cwd`;
    returns its wall time, the last line it printed and its launch counts;
    raises if it fails."""
    t1 = time.time()
    proc = subprocess.run([sys.executable, "-c", CLI_WRAPPER, module]
                          + list(args), cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.time() - t1
    if proc.returncode != 0:
        raise AssertionError(f"python3 -m {module} {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    counts = [line for line in lines if line.startswith("launches ")]
    printed = [line for line in lines if line and not line.startswith(
        "launches ")]
    print(f"python3 -m {module} {' '.join(args)}: {wall:.3f} s wall")
    return {"wall_s": wall, "output": printed[-1] if printed else "",
            **json.loads(counts[-1][len("launches "):])}


def _decode(np, path):
    from rewriting_torch.utils.renormalize import decode_png
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.int16)


def with_latent_avg(model, params) -> dict:
    """The params with ``latent_avg`` set to the mean W of 4096 seeded z:
    the truncation centre a published checkpoint carries."""
    import torch

    from rewriting_torch.utils.zdataset import standard_z_sample

    mapping = model.pipeline.subsequence(upto_layer="latents")
    with torch.no_grad():
        w = mapping(params, model.make_bag(standard_z_sample(
            4096, model.z_dim, seed=3)))
    written = dict(params)
    written["latents"] = {"latent_avg": w["latent"].mean(0)}
    return written


def check_checkpoint_and_command_lines(model, params, workdir: str) -> dict:
    """Phase 12: write the params as a rosinality checkpoint (with the mean
    W of 4096 z as latent_avg), load it back through the zoo bit for bit,
    then run the two samplers' command lines on it in `workdir`, each in
    its own process: 32 clean images, and the dome2tree edit with 16
    edited images.  Returns the phase's numbers; raises on any failure."""
    import numpy as np
    import torch

    from rewriting_torch.core import leaves
    from rewriting_torch.metrics.sample import per_image_z
    from rewriting_torch.models.zoo import load_seq_stylegan
    from rewriting_torch.utils.renormalize import mask_from_url, renormalize

    written = with_latent_avg(model, params)
    weights = os.path.join(workdir, "weights")
    os.makedirs(weights)
    path = os.path.join(weights, "stylegan2_church.pt")
    t1 = time.time()
    torch.save(rosinality_checkpoint(model, written), path)
    save_s = time.time() - t1
    old = os.environ.get("REWRITING_TPU_WEIGHTS")
    os.environ["REWRITING_TPU_WEIGHTS"] = weights
    try:
        t1 = time.time()
        loaded_model, loaded = load_seq_stylegan("church", truncation=0.5)
        load_s = time.time() - t1
    finally:
        if old is None:
            del os.environ["REWRITING_TPU_WEIGHTS"]
        else:
            os.environ["REWRITING_TPU_WEIGHTS"] = old

    got, want = dict(leaves(loaded)), dict(leaves(written))
    if got.keys() != want.keys():
        raise AssertionError("the loaded params have other names")
    for k in got:
        if got[k].device != want[k].device or \
                not torch.equal(got[k], want[k]):
            raise AssertionError(f"loaded param {k} differs from the file's")
    mb = os.path.getsize(path) / 2 ** 20
    print(f"rosinality checkpoint {mb:.1f} MiB: saved in {save_s:.3f} s, "
          f"loaded by the zoo (truncation 0.5) in {load_s:.3f} s, "
          f"{len(got)} tensors bit for bit")

    env = dict(os.environ, REWRITING_TPU_WEIGHTS=weights,
               REWRITING_TPU_MASKS=MASKS,
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cli = os.path.join(workdir, "cli")
    os.makedirs(cli)
    clean = run_cli("rewriting_torch.metrics.sample",
                    ["--dataset", "church", "--n", "32"], cli, env)
    clean_dir = os.path.join(cli, "results", "samples", "church_clean")
    pngs = [n for n in os.listdir(clean_dir) if n.endswith(".png")]
    if not os.path.isfile(os.path.join(clean_dir, "done.txt")) or \
            len(pngs) != 32:
        raise AssertionError(f"sample wrote {len(pngs)} images, done marker "
                             f"{os.path.isfile(clean_dir + '/done.txt')}")
    direct = renormalize(np.clip(loaded_model(loaded, per_image_z(
        loaded_model, [3]))[0].cpu().numpy(), -1, 1), "zc", "byte")
    lsb = int(np.abs(_decode(np, os.path.join(clean_dir, "3.png"))
                     - direct.astype(np.int16)).max())
    print(f"  32 clean PNGs and done.txt; image 3 within {lsb} LSB of a "
          f"direct render; K2 launches {clean['k2']} (general "
          f"{clean['k2_general']}), K1 {clean['k1']}")
    if lsb > 1:
        raise AssertionError(f"clean image 3 is {lsb} LSB from a direct "
                             "render")
    if clean["k2"] <= 0 or clean["k2_general"] != 0:
        raise AssertionError(f"sample's K2 launches: {clean}")

    edited = run_cli("rewriting_torch.metrics.sample_edited",
                     ["--mask", "dome2tree", "--n", "16"], cli, env)
    edited_dir = os.path.join(cli, "results", "samples", "dome2tree")
    if not os.path.isfile(os.path.join(edited_dir, "done.txt")):
        raise AssertionError("sample_edited left no done marker")
    with open(MASK) as f:
        region = mask_from_url(json.load(f)["paste"][1],
                               size=(model.size, model.size)) > 0.5
    inside, outside = [], []
    for i in range(16):
        diff = np.abs(_decode(np, os.path.join(edited_dir, f"{i}.png"))
                      - _decode(np, os.path.join(clean_dir, f"{i}.png")))
        diff = diff.mean(-1)
        inside.append(float(diff[region].mean()))
        outside.append(float(diff[~region].mean()))
    print(f"  16 edited PNGs and done.txt; mean |edited - clean| inside the "
          f"paste mask {np.mean(inside):.3f}, outside {np.mean(outside):.3f} "
          f"(of 255); K2 launches {edited['k2']}, backward "
          f"{edited['k2_backward']} (general {edited['k2_general']})")
    if not max(inside) > 0:
        raise AssertionError("the edited images equal the clean ones inside "
                             "the mask")
    if edited["k2_general"] != 0:
        raise AssertionError(f"sample_edited's K2 launches: {edited}")
    return {"checkpoint_mib": mb, "save_s": save_s, "load_s": load_s,
            "sample_cli": clean, "sample_edited_cli": edited,
            "clean_lsb": lsb, "edited_inside": float(np.mean(inside)),
            "edited_outside": float(np.mean(outside))}


def check_server_solves(rw, kblur, insert: dict, fast_steps: int = 2001,
                        steps: int = 201) -> dict:
    """Phase 13: the server's solves on the rewriter of phase 11's edit
    (`rw`, at layer 7, whose window runs the blur) and on the dome2tree
    goal, built as apply_edit builds it: ``linear_insert`` for `steps`
    steps, ``fast_linear_insert`` for `fast_steps`; ``insert`` (the
    projected Adam) is phase 11's own solve, `insert` its numbers.  Checks
    the losses fall, the fast solve's first `steps` losses match the
    direct one's, both changes lie in span(D), and K2's forward and
    backward run every step.  Returns the seconds per step."""
    import numpy as np

    from rewriting_torch.rewrite.solve import projected_conv

    with open(MASK) as f:
        request = json.load(f)
    rw.revert()
    obj = rw.object_from_selection(*request["object"])
    goal_in, goal_out, _, _ = rw.paste_from_selection(*request["paste"],
                                                      obj[0], obj[2])
    d = rw.multi_key_from_selection(request["key"], rank=1)
    w0 = rw.target_weight().clone()
    out = {"insert": {"steps": insert["steps"],
                      "s_per_step": insert["solve_ms"] / 1e3
                      / insert["steps"],
                      "loss_first": insert["loss_first"],
                      "loss_last": insert["loss_last"],
                      "span_rel": insert["span_rel"]}}
    print(f"layer {insert['layer']} insert (phase 11), {insert['steps']} "
          f"steps: {insert['solve_ms'] / insert['steps']:.4f} ms a step")
    losses_of = {}
    for name, fn, n in (("linear_insert", rw.linear_insert, steps),
                        ("fast_linear_insert", rw.fast_linear_insert,
                         fast_steps)):
        rw.revert()
        kblur.launches = kblur.backward_launches = kblur.general_launches = 0
        seen = []
        losses, ms = fn(goal_in, goal_out, d, niter=n, return_timing=True,
                        update_callback=lambda i, l: seen.append(i))
        delta = rw.target_weight() - w0
        span = float((delta - projected_conv(delta, d)).norm()
                     / delta.norm())
        losses_of[name] = losses
        out[name] = {"steps": n, "s_per_step": ms / 1e3 / n,
                     "loss_first": float(losses[0]),
                     "loss_last": float(losses[-1]), "span_rel": span,
                     "k2": kblur.launches,
                     "k2_backward": kblur.backward_launches,
                     "k2_general": kblur.general_launches}
        print(f"layer {insert['layer']} {name}, {n} steps: {ms / n:.4f} ms "
              f"a step ({ms / 1e3:.3f} s); loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}; change outside span(D) {span:.3e}; K2 "
              f"launches {kblur.launches} forward, "
              f"{kblur.backward_launches} backward (general "
              f"{kblur.general_launches})")
        if seen != list(range(n)):
            raise AssertionError(f"{name}: update_callback saw {len(seen)} "
                                 "steps")
        if not losses[-1] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"{name} did not lower the loss")
        if not span <= SPAN_TOL:
            raise AssertionError(f"{name}: the change leaves span(D) by "
                                 f"{span}")
        if kblur.launches < n or kblur.backward_launches < n or \
                kblur.general_launches != 0:
            raise AssertionError(f"{name}: K2 launched {kblur.launches} "
                                 f"forward, {kblur.backward_launches} "
                                 f"backward, general "
                                 f"{kblur.general_launches} in {n} steps")
    rw.revert()
    gap = float(np.abs(losses_of["fast_linear_insert"][:steps]
                       - losses_of["linear_insert"]).max())
    print(f"fast vs direct linear insert, first {steps} losses: max abs "
          f"difference {gap:.3e} (limit {FAST_LINEAR_TOL})")
    if not gap <= FAST_LINEAR_TOL:
        raise AssertionError(f"fast and direct linear inserts differ by "
                             f"{gap}")
    out["fast_vs_direct_max_abs"] = gap
    return out


def check_erase_keys_renders(model, params, kblur, steps: int = 201,
                             layernum: int = 8) -> dict:
    """Phase 14, at `layernum`: apply_erase (drank 30), zero, the svd and mean
    keys, render_image_batch plain and with the query key's response
    outlined, render_object with its box, then a `steps`-step apply_edit
    in the Pre (adain .. activate) and Tiny (dconv) windows."""
    import numpy as np
    import torch

    from rewriting_torch.rewrite import (SeqPreStyleGanRewriter,
                                         SeqStyleGanRewriter,
                                         SeqTinyStyleGanRewriter)
    from rewriting_torch.rewrite.solve import projected_conv
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    with open(MASK) as f:
        request = json.load(f)
    zds = z_dataset_for_model(model, 1000)
    size = model.size
    out = {}
    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    kblur.launches = kblur.general_launches = 0
    t1 = time.time()
    rw = SeqStyleGanRewriter(model, params, zds, layernum=layernum,
                             device=model.device)
    losses = rw.apply_erase(request, rank=1, drank=30, niter=steps)
    sync()
    out["erase_s"] = time.time() - t1
    out["erase_loss"] = [float(losses[0]), float(losses[-1])]
    print(f"layer {layernum} apply_erase (drank 30, {steps} steps, the unit scales "
          f"over 1000 z included): {out['erase_s']:.3f} s; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("apply_erase did not lower the loss")
    rw.revert()
    d = rw.multi_key_from_selection(request["key"], rank=1)
    rw.zero(d)
    left = float(projected_conv(rw.target_weight(), d).norm())
    rw.revert()
    print(f"zero: the weight's component along D is {left:.3e}")
    if not left <= 1e-4 * float(rw.target_weight().norm()):
        raise AssertionError(f"zero left {left} along D")
    for method in ("svd", "mean"):
        k = rw.multi_key_from_selection(request["key"], rank=1,
                                        key_method=method)
        norm = float(k.norm())
        print(f"{method} key: shape {tuple(k.shape)}, norm {norm:.6f}")
        if tuple(k.shape) != (1, rw.k_shape[-1]) or abs(norm - 1) > 1e-4:
            raise AssertionError(f"{method} key is not a unit row")
    t1 = time.time()
    plain = rw.render_image_batch(list(range(8)))
    key = rw.query_key_from_selection(*request["paste"])
    heat = (rw.context_acts(rw.context_of(request["paste"][0])) * key).sum(-1)
    level = float(torch.quantile(heat.flatten(), 0.9))
    lit = rw.render_image_batch(list(range(8)), key=key, level=level)
    obj = rw.object_from_selection(*request["object"])
    boxed = rw.render_object(obj[1], box=obj[3])
    out["render_s"] = time.time() - t1
    images = plain + lit + [boxed]
    if any(im.dtype != np.uint8 or im.shape != (size, size, 3)
           for im in images):
        raise AssertionError("a render is not uint8 (H, W, 3)")
    if not (boxed == np.array([255, 0, 0], np.uint8)).all(-1).any():
        raise AssertionError("render_object drew no red box")
    print(f"render_image_batch 8 plain + 8 with the query key at level "
          f"{level:.4f}, render_object with its box: {out['render_s']:.3f} "
          f"s, all uint8 {images[0].shape}")
    for name, cls in (("pre", SeqPreStyleGanRewriter),
                      ("tiny", SeqTinyStyleGanRewriter)):
        t1 = time.time()
        var = cls(model, params, zds, layernum=layernum, device=model.device)
        w0 = var.target_weight().clone()
        losses = var.apply_edit(request, niter=steps)
        sync()
        delta = var.target_weight() - w0
        span = float((delta - projected_conv(delta, var.multi_key_from_selection(
            request["key"]))).norm() / delta.norm())
        out[f"{name}_s"] = time.time() - t1
        out[f"{name}_loss"] = [float(losses[0]), float(losses[-1])]
        print(f"Seq{name.capitalize()}StyleGanRewriter ({var.firstlayer}"
              f" .. {var.lastlayer}): statistics and a {steps}-step "
              f"apply_edit {out[f'{name}_s']:.3f} s; loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}; change outside span(D) {span:.3e}")
        if not losses[-1] < losses[0] or not span <= SPAN_TOL:
            raise AssertionError(f"{name} edit: loss {out[f'{name}_loss']}, "
                                 f"span {span}")
    out["k2"], out["k2_general"] = kblur.launches, kblur.general_launches
    if kblur.general_launches != 0:
        raise AssertionError("phase 14 launched the general blur kernel")
    return out


def proggan_checkpoint(model, params) -> dict:
    """The ProgGAN params as a reference-format state dict in the old
    ``features.N`` naming (reference utils/proggan.py:298-325), as the
    published ``proggan_*.pth`` files hold it.  CPU tensors."""
    import collections

    def cpu(t):
        return t.detach().cpu().clone()

    blocks = list(model._conv_specs)     # layer1 .. layerN, output_DxD
    sd = collections.OrderedDict()
    for n, name in enumerate(blocks[:-1]):
        sd[f"features.{n}.conv.weight"] = cpu(params[f"{name}.conv"]["weight"])
        sd[f"features.{n}.wscale.b"] = cpu(params[f"{name}.wscale"]["bias"])
    sd["output.conv.weight"] = cpu(params[f"{blocks[-1]}.conv"]["weight"])
    sd["output.wscale.b"] = cpu(params[f"{blocks[-1]}.wscale"]["bias"])
    return sd


def check_proggan(model, workdir: str, counters, niter: int = 2001,
                  layernum: int = PROGGAN_LAYER) -> dict:
    """Phase 15: a ProgGAN (church-256 at its published widths) with seeded
    weights written as a reference-format ``.pth`` under the old
    ``features.N`` names, loaded by ``zoo.load_proggan`` bit for bit; its
    forward on the model's device against the CPU's; then
    ``ProgressiveGanRewriter`` at `layernum` (1000-z statistics) and the
    spire2tree request (`niter` steps).  `counters()` reads the kernels'
    launch counts, which must stay 0: no kernel is on this path."""
    import torch

    from rewriting_torch.models.proggan import ProgressiveGenerator
    from rewriting_torch.models.stylegan2 import params_to
    from rewriting_torch.models.zoo import load_proggan
    from rewriting_torch.rewrite import ProgressiveGanRewriter
    from rewriting_torch.rewrite.solve import projected_conv
    from rewriting_torch.utils.zdataset import (standard_z_sample,
                                                z_dataset_for_model)

    device, resolution = model.device, model.resolution
    params = model.init_params(seed=0)
    nparams = sum(t.numel() for sub in params.values() for t in sub.values())
    path = os.path.join(workdir, "proggan", "proggan_churchoutdoor.pth")
    os.makedirs(os.path.dirname(path))
    t1 = time.time()
    torch.save(proggan_checkpoint(model, params), path)
    save_s = time.time() - t1
    t1 = time.time()
    loaded_model, loaded = load_proggan("church", path=path, device=device)
    load_s = time.time() - t1
    if loaded_model.sizes != model.sizes or loaded.keys() != params.keys():
        raise AssertionError("load_proggan built another model")
    for stage, sub in params.items():
        for name, t in sub.items():
            if not torch.equal(loaded[stage][name], t):
                raise AssertionError(f"loaded {stage}.{name} differs")
    mb = os.path.getsize(path) / 2 ** 20
    print(f"ProgGAN church-{resolution} {model.sizes}: {nparams} parameters, "
          f"{mb:.1f} MiB .pth in the features.N naming saved in "
          f"{save_s:.3f} s, loaded by zoo.load_proggan in {load_s:.3f} s, "
          f"{2 * len(params)} tensors bit for bit")
    z = standard_z_sample(2, model.z_dim, seed=1)
    img = loaded_model(loaded, z)
    cpu_model = ProgressiveGenerator(sizes=model.sizes, device="cpu")
    img_cpu = cpu_model(params_to(loaded, "cpu"), z)
    rel = float((img.cpu() - img_cpu).abs().max() / img_cpu.abs().max())
    print(f"ProgGAN forward (NHWC {tuple(img.shape)}), card vs CPU: max "
          f"diff / max |CPU| = {rel:.3e} (limit {FORWARD_RTOL})")
    if tuple(img.shape) != (2, resolution, resolution, 3) or \
            not rel <= FORWARD_RTOL:
        raise AssertionError(f"ProgGAN card forward differs by {rel}")

    with open(PROGGAN_MASK) as f:
        request = json.load(f)
    sync(device)
    t1 = time.time()
    rw = ProgressiveGanRewriter(loaded_model, loaded,
                                z_dataset_for_model(loaded_model, 1000),
                                layernum=layernum, device=device)
    sync(device)
    stats_s = time.time() - t1
    w0 = rw.target_weight().clone()
    t1 = time.time()
    losses, solve_ms = rw.apply_edit(request, niter=niter, return_timing=True)
    sync(device)
    edit_s = time.time() - t1
    d = rw.multi_key_from_selection(request.get("key", [request["paste"]]))
    delta = rw.target_weight() - w0
    span = float((delta - projected_conv(delta, d)).norm() / delta.norm())
    launches = counters()
    print(f"ProgressiveGanRewriter layer {layernum} ({rw.firstlayer}, "
          f"window {rw.v_shape}): statistics (1000 z) {stats_s:.3f} s; "
          f"spire2tree edit {edit_s:.3f} s, of it the {niter}-step solve "
          f"{solve_ms / 1e3:.3f} s ({solve_ms / niter:.4f} ms a step); loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; change outside span(D) "
          f"{span:.3e}; launches {launches}")
    if not losses[-1] < losses[0] or not span <= SPAN_TOL:
        raise AssertionError(f"ProgGAN edit: loss {losses[0]} -> "
                             f"{losses[-1]}, span {span}")
    if any(launches.values()):
        raise AssertionError(f"the ProgGAN path launched a kernel: "
                             f"{launches}")
    rw.revert()
    return {"path": path, "parameters": nparams, "checkpoint_mib": mb,
            "save_s": save_s,
            "load_s": load_s, "card_vs_cpu_rel": rel, "layer": layernum,
            "stats_s": stats_s, "edit_s": edit_s, "solve_ms": solve_ms,
            "steps": niter, "loss": [float(losses[0]), float(losses[-1])],
            "span_rel": span, "launches": launches}


def check_batched_edits(rw, kblur, workdir: str, steps: int = 2001,
                        npreview: int = 8) -> dict:
    """Phase 16, on phase 11's layer-7 rewriter `rw` (an upsampling layer:
    the window runs K2 forward and backward): the four requests of
    ``BATCH_REQUESTS`` solved as one batch by ``batch_apply_edits``
    (`steps` steps), twice, against the first and last solved one at a
    time by ``fast_linear_insert``, with cuDNN's deterministic and with
    its default algorithms; their previews at `npreview` z, batched and
    one edit at a time; the edited params through ``paramio``.  Returns
    the phase's numbers; raises on any failure."""
    import numpy as np
    import torch

    from rewriting_torch.core import DataBag, leaves
    from rewriting_torch.rewrite.multi import (batch_apply_edits,
                                               build_goals, preview_edits)
    from rewriting_torch.rewrite.solve import projected_conv
    from rewriting_torch.utils.paramio import load_params, save_params

    requests = []
    for name in BATCH_REQUESTS:
        with open(os.path.join(MASKS, "church", f"{name}.json")) as f:
            requests.append(json.load(f))
    edits = len(requests)
    rw.revert()
    w0 = rw.target_weight().clone()
    kblur.launches = kblur.backward_launches = kblur.general_launches = 0
    goals = build_goals(rw, requests)
    goal_launches = kblur.launches
    kblur.launches = kblur.backward_launches = kblur.general_launches = 0
    sync(rw.device)
    t1 = time.time()
    weights, losses, batch_ms = batch_apply_edits(rw, requests, niter=steps,
                                                  return_timing=True)
    sync(rw.device)
    batch_s = time.time() - t1
    # the goals again, each edit's unedited window output (out0) and the
    # one window forward at Λ = 0 that anchors the loop; the rest is the loop
    loop_fwd = kblur.launches - goal_launches - edits - 1
    batch_k2 = [kblur.launches, kblur.backward_launches,
                kblur.general_launches]
    print(f"batch_apply_edits, {edits} requests ({', '.join(BATCH_REQUESTS)})"
          f" at {rw.firstlayer}, {steps} steps: {batch_s:.3f} s, of it the "
          f"solve {batch_ms / 1e3:.3f} s ({batch_ms / steps:.4f} ms a step); final "
          f"losses {np.array2string(losses, precision=6)}; K2 launches "
          f"{batch_k2[0]} forward ({goal_launches} for the goals, {edits + 1} "
          f"for the unedited outputs and the anchor, {loop_fwd} in the loop), "
          f"{batch_k2[1]} backward, general {batch_k2[2]}")
    if loop_fwd != steps or batch_k2[1] != steps or batch_k2[2] != 0:
        raise AssertionError(f"the batch launched K2 {loop_fwd} times "
                             f"forward and {batch_k2[1]} backward in its "
                             f"{steps}-step loop, want {steps} each")
    if not torch.equal(rw.target_weight(), w0):
        raise AssertionError("batch_apply_edits changed the rewriter's "
                             "params")
    again, again_losses = batch_apply_edits(rw, requests, niter=steps)
    repeat = all(torch.equal(a, b) for a, b in zip(weights, again)) and \
        np.array_equal(losses, again_losses)
    print(f"batch_apply_edits run again: weights and final losses bit for "
          f"bit the same: {repeat}")
    if not repeat:
        raise AssertionError("the batch does not repeat bit for bit")
    rows = []
    for i in (0, edits - 1):
        gin, gout, d = goals[i]
        runs = []
        for algorithms in ((contextlib.nullcontext,)
                           + (default_algorithms,) * BATCH_DEFAULT_RUNS):
            rw.revert()
            with algorithms():
                seq_losses, ms = rw.fast_linear_insert(
                    gin, DataBag(gin, fmap=gout), d, niter=steps,
                    return_timing=True)
            runs.append((rw.target_weight().clone(), seq_losses, ms))
        rw.revert()
        (w_a, l_a, ms_a), defaults = runs[0], runs[1:]
        w_b, l_b, ms_b = defaults[0]
        wgap = max(float((w_a - w).abs().max()) for w, _, _ in defaults)
        lgaps = [float(abs(l_a[-1] - l[-1])) for _, l, _ in defaults]
        lgap = max(lgaps)
        wdiff = float((weights[i] - w_a).abs().max())
        wrel = float((weights[i] - w_a).norm() / (w_a - w0).norm())
        ldiff = float(abs(losses[i] - l_a[-1]))
        with torch.no_grad():
            y0, ya, yb = (rw._window_fn(w, (gin, rw.params))
                          for w in (w0, w_a, weights[i]))
            ydef = [rw._window_fn(w, (gin, rw.params)) for w, _, _ in defaults]
        # the share of the single solve's change in the goal's L1 that a
        # run makes: 1 for the single solve, 0 for no change at all
        goal = [float(torch.mean(torch.abs(gout - y)))
                for y in (y0, ya, ydef[0], yb)]
        share = (goal[0] - goal[3]) / (goal[0] - goal[1])
        shares = [(goal[0] - float(torch.mean(torch.abs(gout - y))))
                  / (goal[0] - goal[1]) for y in ydef]
        share_gap = max(shares, key=lambda v: abs(1 - v))
        orel = float((yb - ya).norm() / (ya - y0).norm())
        ogap = float((ydef[0] - ya).norm() / (ya - y0).norm())
        delta = weights[i] - w0
        span = float((delta - projected_conv(delta, d)).norm() / delta.norm())
        rows.append({"edit": BATCH_REQUESTS[i], "final_loss_abs": ldiff,
                     "default_vs_deterministic_final_loss_abs": lgap,
                     "default_runs_final_loss_abs": lgaps,
                     "goal_l1": goal, "goal_share": share,
                     "default_vs_deterministic_goal_share": share_gap,
                     "default_runs_goal_share": shares,
                     "output_rel": orel,
                     "default_vs_deterministic_output_rel": ogap,
                     "weights_max_abs": wdiff, "weights_rel": wrel,
                     "default_vs_deterministic_max_abs": wgap,
                     "span_rel": span,
                     "single_ms_per_step": [ms_a / steps, ms_b / steps]})
        print(f"  {BATCH_REQUESTS[i]}: fast_linear_insert alone, "
              f"deterministic / default algorithms {ms_a / steps:.4f} / "
              f"{ms_b / steps:.4f} ms a step; final loss {l_a[-1]:.6f} / "
              f"{l_b[-1]:.6f}, the batch's {losses[i]:.6f} ({ldiff:.3e} "
              f"from the deterministic one; limit 3x the largest of the "
              f"{BATCH_DEFAULT_RUNS} default runs' "
              f"{np.array2string(np.array(lgaps), precision=3)} + "
              f"{BATCH_LOSS_TOL}); the window's output: L1 to the goal "
              f"unedited / alone / default / batch {goal[0]:.6f} / "
              f"{goal[1]:.6f} / {goal[2]:.6f} / {goal[3]:.6f}, the share "
              f"of the change alone the batch makes {share:.6f}, the "
              f"default runs' {np.array2string(np.array(shares), precision=6)}"
              f" (limit |1 - share| within 3x the default runs' largest + "
              f"{BATCH_OUTPUT_FLOOR}); |diff| / |change by the "
              f"edit| "
              f"(not held: a batch that changed nothing reads 1): batch vs "
              f"alone {orel:.3e}, default vs deterministic {ogap:.3e}; "
              f"weights batch vs alone: max abs "
              f"diff {wdiff:.3e}, |diff| / |edit| {wrel:.3e}; default vs "
              f"deterministic: max abs diff {wgap:.3e}; batch change outside "
              f"span(D) {span:.3e}")
        if not ldiff <= 3 * lgap + BATCH_LOSS_TOL or \
                not span <= SPAN_TOL or \
                not abs(1 - share) <= 3 * abs(1 - share_gap) + \
                BATCH_OUTPUT_FLOOR:
            raise AssertionError(f"batch edit {i}: final loss {ldiff} from "
                                 f"the single solve's, {share} of its "
                                 f"change in the goal's L1, span {span}")
    single_ms = float(np.mean([r["single_ms_per_step"][0] for r in rows]))
    print(f"ms a step: the {edits}-edit batch {batch_ms / steps:.4f}, one "
          f"edit alone {single_ms:.4f} ({batch_ms / steps / single_ms:.2f}x "
          f"for {edits}x the edits), both with deterministic algorithms")

    zs = rw.zds.zs[:npreview]
    previews = {}
    for batched in (True, False):
        kblur.launches = kblur.general_launches = 0
        sync(rw.device)
        t1 = time.time()
        images = preview_edits(rw, weights, zs, batched=batched)
        previews[batched] = (images, time.time() - t1, kblur.launches)
    (pv, pv_s, pv_k2), (p1, p1_s, p1_k2) = previews[True], previews[False]
    size = rw.x_shape[1]
    rel = float(np.abs(pv - p1).max() / np.abs(p1).max())
    print(f"preview_edits {edits} edits x {npreview} z -> {pv.shape}: batched "
          f"{pv_s:.3f} s, K2 {pv_k2} launches; one edit at a time {p1_s:.3f} "
          f"s, K2 {p1_k2} launches; max diff / max = {rel:.3e} (limit "
          f"{FORWARD_RTOL})")
    if pv.shape != (edits, npreview, size, size, 3) or \
            not np.isfinite(pv).all() or not rel <= FORWARD_RTOL:
        raise AssertionError(f"previews {pv.shape}, {rel} apart")
    if not 0 < pv_k2 < p1_k2 or kblur.general_launches != 0:
        raise AssertionError(f"preview K2 launches {pv_k2} batched, "
                             f"{p1_k2} one at a time")

    stage = rw.weight_stage()
    edited = dict(rw.params)
    edited[stage] = {**edited[stage], "weight": weights[0]}
    path = os.path.join(workdir, "batch", "edited.npz")
    t1 = time.time()
    save_params(path, edited)
    back = load_params(path, device=rw.device)
    io_s = time.time() - t1
    got, want = dict(leaves(back)), dict(leaves(edited))
    nleaves = len(want)
    if got.keys() != want.keys() or any(
            got[k].device != t.device or not torch.equal(got[k], t)
            for k, t in want.items()):
        raise AssertionError("the paramio round trip changed the params")
    mb = os.path.getsize(path) / 2 ** 20
    print(f"paramio: the edited params ({mb:.1f} MiB npz, {nleaves} "
          f"tensors) saved and loaded back in {io_s:.3f} s, bit for bit")
    return {"edits": edits, "steps": steps, "batch_s": batch_s,
            "batch_repeats": repeat, "batch_ms_per_step": batch_ms / steps,
            "single_ms_per_step": single_ms,
            "final_losses": [float(v) for v in losses],
            "k2_loop": [loop_fwd, batch_k2[1]], "k2_batch_total": batch_k2,
            "k2_goals": goal_launches, "vs_single": rows,
            "preview_s": [pv_s, p1_s], "preview_k2": [pv_k2, p1_k2],
            "preview_rel": rel, "paramio_s": io_s, "paramio_mib": mb}


def check_instrumented(model, params, rw8, kblur, nz: int = 8) -> dict:
    """Phase 17: ``InstrumentedPipeline`` over the church-256 model: the
    retained context of layer 8 against the rewriter's ``context_acts``
    there (phase 5's rewriter `rw8`), the forward against the seq
    pipeline's, and a per-channel ablation of 1.0 with replacement 0
    against a zeroing rule; K2 launches per forward."""
    import numpy as np
    import torch

    from rewriting_torch.core.instrument import InstrumentedPipeline

    inst = InstrumentedPipeline(model, params)
    layer = rw8.context_pipe.stage_names()[-1]    # the last stage before
    inst.retain_layer(layer)                      # the window: its keys
    zs = rw8.zds.zs[:nz]
    kblur.launches = kblur.general_launches = 0
    sync(model.device)
    t1 = time.time()
    out = inst(zs)
    sync(model.device)
    fwd_s = time.time() - t1
    launches = kblur.launches
    # row 0: a batch's noise inputs are prefix-stable
    got = inst.retained_layer(layer)["fmap"][:1]
    want = rw8.context_acts(rw8.context_of(0))
    kdiff = float((got - want).abs().max() / want.abs().max())
    seq = model(params, zs, fast=False)
    odiff = float((out - seq).abs().max() / seq.abs().max())
    block = rw8.lastlayer.rsplit(".", 1)[0]     # the window's layer
    channels = params[f"{block}.activate"]["bias"].shape[0]
    inst.edit_layer(block, ablation=np.ones(channels, np.float32),
                    replacement=np.zeros(channels, np.float32))
    ablated = inst(zs)
    inst.edit_layer(block, rule=lambda x: x * 0.0)
    zeroed = inst(zs)
    adiff = float((ablated - zeroed).abs().max())
    moved = float((zeroed - out).abs().mean())
    print(f"InstrumentedPipeline church-256, {nz} z: forward {fwd_s:.3f} s "
          f"with {launches} K2 launches; retained {layer} {tuple(got.shape)} "
          f"(NHWC) vs the layer-8 rewriter's context_acts: max diff / max "
          f"{kdiff:.3e}; output vs the seq pipeline {odiff:.3e} (limit "
          f"{FORWARD_RTOL}); per-channel ablation 1.0 / replacement 0 of "
          f"{block} ({channels} channels) vs a zeroing rule: max diff "
          f"{adiff:.3e}, mean change of the image {moved:.4f}")
    if not max(kdiff, odiff) <= FORWARD_RTOL or adiff > 1e-6 or \
            not moved > 0:
        raise AssertionError(f"instrumented forward: keys {kdiff}, output "
                             f"{odiff}, ablation {adiff}, change {moved}")
    if launches <= 0 or kblur.general_launches != 0:
        raise AssertionError(f"instrumented forward K2 launches {launches}, "
                             f"general {kblur.general_launches}")
    return {"forward_s": fwd_s, "k2_per_forward": launches,
            "keys_rel": kdiff, "output_rel": odiff, "ablation_abs": adiff}


def check_watermark(model, params, workdir: str, kblur, steps: int = 2001,
                    nimages: int = 64, layer: int = 6) -> dict:
    """Phase 18: the §5.2 watermark erase on church-256 (`params` with a
    latent_avg): the key statistics from the truncation-1.0 `model`, the
    erase (``multikey_markandbottom``, ``ours`` with ``WATERMARK_DRANK``
    units, two repetitions of `steps` steps) on a truncation-0.5 model,
    `nimages` images of the erased model written by ``save_zds_images``."""
    import numpy as np
    import torch

    from rewriting_torch.metrics.watermark import (erase_watermark,
                                                   save_zds_images)
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.utils.renormalize import renormalize

    with open(os.path.join(MASKS, "church",
                           "multikey_markandbottom.json")) as f:
        request = json.load(f)
    model05 = SeqStyleGAN2(model.size, style_dim=model.style_dim,
                           n_mlp=model.n_mlp, truncation=0.5,
                           device=model.device)
    outdir = os.path.join(workdir, "watermark")
    losses = {}
    kblur.launches = kblur.general_launches = 0
    sync(model.device)
    t1 = time.time()
    gw = erase_watermark(
        model05, params, params, request, layer, outdir, niters=steps,
        nreps=2, drank=WATERMARK_DRANK, erasemethod="ours",
        sample_size=1000, save_images=False,
        covariance_model=model,
        update_callback=lambda r, i, l: losses.setdefault(r, []).append(
            float(l)))
    sync(model.device)
    erase_s = time.time() - t1
    erase_k2 = kblur.launches
    t1 = time.time()
    imgdir = os.path.join(outdir, "images")
    save_zds_images(imgdir, model05, gw.params, gw.zds, indices=range(nimages))
    save_s = time.time() - t1
    names = [n for n in os.listdir(imgdir) if n.endswith(".png")]
    probe = nimages - 1
    direct = renormalize(np.clip(model05(gw.params, gw.zds.zs[probe:probe + 1])
                                 [0].cpu().numpy(), -1, 1), "zc", "byte")
    lsb = int(np.abs(_decode(np, os.path.join(imgdir, f"image_{probe}.png"))
                     - direct.astype(np.int16)).max())
    # the statistics are the truncation-1.0 model's, not the erased one's
    c05 = SeqStyleGanRewriter(model05, params, gw.zds, layer,
                              device=model.device).c_matrix
    crel = float((c05 - gw.c_matrix).norm() / gw.c_matrix.norm())
    first, last = losses[0][0], losses[max(losses)][-1]
    print(f"erase_watermark church-256 layer {layer}, ours, drank "
          f"{WATERMARK_DRANK}, 2 x {steps} "
          f"steps: {erase_s:.3f} s (statistics of both models included), K2 "
          f"{erase_k2} launches; loss rep 0 {losses[0][0]:.6f} -> "
          f"{losses[0][-1]:.6f}, rep 1 {losses[1][0]:.6f} -> "
          f"{losses[1][-1]:.6f}; {len(names)} images in {save_s:.3f} s, "
          f"image {probe} within {lsb} LSB of a direct render; the moment "
          f"of the truncation-0.5 model is {crel:.3e} (relative) from the "
          f"one used")
    if len(losses) != 2 or not last < first or \
            not np.isfinite(losses[0] + losses[1]).all():
        raise AssertionError(f"the erase's loss went {first} -> {last}")
    if len(names) != nimages or lsb > 1 or not crel > 0:
        raise AssertionError(f"{len(names)} images, {lsb} LSB, moments "
                             f"{crel} apart")
    if kblur.general_launches != 0:
        raise AssertionError("the erase launched K2's general kernel")
    return {"erase_s": erase_s, "save_s": save_s, "k2": erase_k2,
            "loss": {r: [v[0], v[-1]] for r, v in losses.items()},
            "lsb": lsb, "moment_rel": crel}


def check_watermark_command_line(workdir: str) -> dict:
    """Phase 18, then: ``python3 -m rewriting_torch.metrics.watermark``
    (its defaults, drank 1) in its own process on phase 12's checkpoint
    file in `workdir`; 100 images and the done marker."""
    env = dict(os.environ, REWRITING_TPU_WEIGHTS=os.path.join(workdir,
                                                               "weights"),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cli_dir = os.path.join(workdir, "watermark_cli")
    os.makedirs(cli_dir)
    args = ["--request", WATERMARK_CLI_REQUEST, "--requestdir",
            os.path.join(ROOT, "notebooks", "masks"), "--sample_size", "100",
            "--niters", "201"]
    cli = run_cli("rewriting_torch.metrics.watermark", args, cli_dir, env)
    done = os.path.join(cli_dir, "results", "watermark",
                        f"erase-stylegan-church-{WATERMARK_CLI_REQUEST}-6-1-"
                        "201-0.05-ours-1-2")
    pngs = [n for n in os.listdir(os.path.join(done, "images"))
            if n.endswith(".png")]
    print(f"  {len(pngs)} PNGs and done.txt; K2 launches {cli['k2']}, "
          f"backward {cli['k2_backward']} (general {cli['k2_general']})")
    if not os.path.isfile(os.path.join(done, "done.txt")) or \
            len(pngs) != 100 or cli["k2_general"] != 0:
        raise AssertionError(f"the watermark command line wrote {len(pngs)} "
                             f"images: {cli}")
    return cli


def _dome2tree_goal(rw):
    """(goal_in, goal_out, D) of the dome2tree request on `rw`, as
    ``apply_edit`` builds them."""
    with open(MASK) as f:
        request = json.load(f)
    rw.revert()
    obj = rw.object_from_selection(*request["object"])
    goal_in, goal_out, _, _ = rw.paste_from_selection(*request["paste"],
                                                      obj[0], obj[2])
    return goal_in, goal_out, rw.multi_key_from_selection(request["key"],
                                                          rank=1)


def check_determinism(rw, fast_steps: int = 2001, steps: int = 201) -> dict:
    """Phase 19, the repair of the solves' run-to-run spread, on a
    rewriter `rw` (phase 11's at layer 7, then phase 5's at layer 8) and
    the dome2tree goal: ``fast_linear_insert``
    (`fast_steps`) and the projected ``insert`` (`steps`), each run with
    cuDNN's deterministic algorithms (the solves' own) and with its
    default ones, in turns, twice: the deterministic runs must repeat bit
    for bit in weights and losses.  Returns ms a step of each."""
    import numpy as np
    import torch

    goal_in, goal_out, d = _dome2tree_goal(rw)
    out = {}
    for name, fn, n in (("fast_linear_insert", rw.fast_linear_insert,
                         fast_steps), ("insert", rw.insert, steps)):
        runs = {"deterministic": [], "default": []}
        for label in ("deterministic", "default") * 2:
            rw.revert()
            with (contextlib.nullcontext() if label == "deterministic"
                  else default_algorithms()):
                losses, ms = fn(goal_in, goal_out, d, niter=n,
                                return_timing=True)
            runs[label].append((rw.target_weight().clone(), losses, ms))
        rw.revert()
        (wa, la, _), (wb, lb, _) = runs["deterministic"]
        (wc, lc, _), (wd, ld, _) = runs["default"]
        same = bool(torch.equal(wa, wb)) and np.array_equal(la, lb)
        spread = float((wc - wd).abs().max())
        gap = float((wa - wc).abs().max())
        ms = {k: [r[2] / n for r in v] for k, v in runs.items()}
        out[name] = {"steps": n, "bit_for_bit": same,
                     "ms_per_step": ms, "default_spread_max_abs": spread,
                     "deterministic_vs_default_max_abs": gap,
                     "loss_last": [float(la[-1]), float(lc[-1])]}
        print(f"layer {rw.firstlayer} {name}, {n} steps, twice with cuDNN's "
              f"deterministic algorithms and twice with its default ones, "
              f"in turns: ms a step deterministic "
              f"{ms['deterministic'][0]:.4f} / {ms['deterministic'][1]:.4f}"
              f", default {ms['default'][0]:.4f} / {ms['default'][1]:.4f}; "
              f"deterministic runs bit for bit equal: {same}; the default "
              f"runs' weights {spread:.3e} apart (max abs), deterministic "
              f"vs default {gap:.3e}; final loss {la[-1]:.6f} / "
              f"{lc[-1]:.6f}")
        if not same:
            raise AssertionError(f"{name} does not repeat bit for bit with "
                                 "deterministic algorithms")
    return out


def _adversarial_stream(np, n: int = 50000):
    """tests/test_stats.py's adversarial stream: 0 .. n-1 in a strided
    order, at three scales."""
    base = np.arange(n, dtype=np.float32)
    stream = base[np.argsort((np.arange(n) * 37) % n, kind="stable")]
    scales = np.array([1.0, 0.01, 100.0], np.float32)
    return stream[:, None] * scales[None, :], scales


def check_quantile_sketch(rows: int = 262144, units: int = 512,
                          batch: int = 2560, device: str = "cuda") -> dict:
    """Phase 20: ``RunningQuantile`` fed a seeded stream of `rows` x
    `units` in batches of `batch` (a statistics batch of 10 z at 16x16)
    on the card and on the CPU: the same level buffers and extremes; ms a
    batch of ingest on the card.  Then the adversarial stream of
    tests/test_stats.py on the card: rank error under 0.001 of the range
    at the default resolution."""
    import numpy as np
    import torch

    from rewriting_torch.stats import RunningQuantile

    gen = torch.Generator().manual_seed(0)
    stream = torch.randn((rows, units), generator=gen) * (
        1 + torch.arange(units) / units)
    on_card = stream.to(device)
    card, host = RunningQuantile(device=device), RunningQuantile()
    sync(device)
    t1 = time.time()
    for lo in range(0, rows, batch):
        card.add(on_card[lo:lo + batch])
    sync(device)
    card_s = time.time() - t1
    t1 = time.time()
    for lo in range(0, rows, batch):
        host.add(stream[lo:lo + batch])
    host_s = time.time() - t1
    sd, hsd = card.state_dict(), host.state_dict()
    same = sorted(sd) == sorted(hsd) and all(
        np.array_equal(sd[k], hsd[k]) for k in hsd if k != "constructor")
    nbatches = -(-rows // batch)
    t1 = time.time()
    qs = card.quantiles(np.linspace(0, 1, 101))
    query_s = time.time() - t1
    print(f"RunningQuantile, {rows} x {units} seeded stream in batches of "
          f"{batch}: card {card_s:.3f} s ({card_s * 1e3 / nbatches:.3f} ms "
          f"a batch; {len(card.fill)} levels, fills {card.fill}), CPU "
          f"{host_s:.3f} s; level buffers, fills and extremes the same: "
          f"{same}; 101 quantiles of the {units} units {query_s:.3f} s")
    if not same or not np.isfinite(qs).all():
        raise AssertionError("the card's sketch differs from the CPU's")
    x, scales = _adversarial_stream(np)
    n = len(x)
    adv = RunningQuantile(device=device)
    for lo in range(0, n, 1999):
        adv.add(torch.as_tensor(x[lo:lo + 1999], device=device))
    qs = np.linspace(0, 1, 101)
    est = adv.quantiles(qs)
    want = qs[None, :] * (n - 1) * scales[:, None]
    rank_err = float((np.abs(est - want)
                      / ((n - 1) * scales[:, None])).max())
    print(f"adversarial stream of tests/test_stats.py ({n} values, 3 "
          f"scales) on the card: max rank error {rank_err:.3e} of the range "
          f"(limit 1e-3), extremes {adv.min().tolist()} .. "
          f"{adv.max().tolist()}")
    if not rank_err < 1e-3 or not np.array_equal(adv.max(),
                                                 (n - 1) * scales):
        raise AssertionError(f"adversarial rank error {rank_err}")
    return {"rows": rows, "units": units, "batch": batch,
            "card_s": card_s, "card_ms_per_batch": card_s * 1e3 / nbatches,
            "cpu_s": host_s, "same_as_cpu": same, "levels": len(card.fill),
            "query_s": query_s, "adversarial_rank_err": rank_err}


@contextlib.contextmanager
def timed_methods(store: dict, device, *methods):
    """Each (owner, name) of `methods` sums the seconds of its calls into
    ``store[name]`` (`device` synchronised at the end of each) within."""
    originals = []
    for owner, name in methods:
        fn = getattr(owner, name)
        originals.append((owner, name, fn))

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t1 = time.time()
            try:
                return _fn(*args, **kwargs)
            finally:
                sync(device)
                store[_name] = store.get(_name, 0.0) + time.time() - t1
        setattr(owner, name, timed)
    try:
        yield store
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def check_gandissect_erase(model, params, workdir: str, kblur,
                           nimages: int = 64, layer: int = 6) -> dict:
    """Phase 21: the §5.2 watermark erase by GANdissect's baseline,
    ``erase_watermark(erasemethod="gandissect")`` at `layer`
    (``multikey_markandbottom``, ``WATERMARK_DRANK`` units, the statistics
    of the truncation-1.0 `model`, the quantile sketch over 1000 z of the
    truncation-0.5 one), `nimages` images.  The weight must change only
    along the one-hot units, to 0 there, and those units must equal a
    host recomputation from the same sketch (each unit's values searched
    in its sorted summary one by one)."""
    import numpy as np
    import torch

    from rewriting_torch.metrics.watermark import (erase_watermark,
                                                   save_zds_images)
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.stats import RunningQuantile

    with open(os.path.join(MASKS, "church",
                           "multikey_markandbottom.json")) as f:
        request = json.load(f)
    model05 = SeqStyleGAN2(model.size, style_dim=model.style_dim,
                           n_mlp=model.n_mlp, truncation=0.5,
                           device=model.device)
    outdir = os.path.join(workdir, "watermark_gandissect")
    times = {}
    kblur.launches = kblur.general_launches = 0
    sync(model.device)
    t1 = time.time()
    with timed_methods(times, model.device,
                       (SeqStyleGanRewriter, "collect_2nd_moment"),
                       (SeqStyleGanRewriter, "quantiles_for_units"),
                       (RunningQuantile, "normalize"),
                       (SeqStyleGanRewriter, "zero")):
        gw = erase_watermark(model05, params, params, request, layer, outdir,
                             drank=WATERMARK_DRANK, erasemethod="gandissect",
                             sample_size=1000, save_images=False,
                             covariance_model=model)
    sync(model.device)
    erase_s = time.time() - t1
    erase_k2 = kblur.launches
    t1 = time.time()
    save_zds_images(os.path.join(outdir, "images"), model05, gw.params,
                    gw.zds, indices=range(nimages))
    save_s = time.time() - t1

    rq = gw.quantiles_for_units()
    obs, w = gw._gather_masked_obs(request["key"], keep_all=True)
    v, wts = rq._summary()
    cum = np.cumsum(wts, axis=1)
    ranks = np.empty_like(obs)
    for u in range(obs.shape[1]):
        idx = np.searchsorted(v[u], obs[:, u], side="right")
        r = np.where(idx > 0, cum[u, np.maximum(idx - 1, 0)], 0.0)
        ranks[:, u] = np.clip(r / cum[u, -1], 0.0, 1.0)
    score = (-np.log(np.maximum(1.0 - ranks, 1e-20)) * w).sum(0) / w.sum()
    want = set(np.argsort(-score)[:WATERMARK_DRANK].tolist())
    key = gw.multi_key_from_selection(request["key"], rank=WATERMARK_DRANK)
    units = key.argmax(1)
    got = set(units.tolist())
    w1 = gw.target_weight()
    w0 = gw.original_params[gw.weight_stage()]["weight"]
    changed = torch.nonzero((w1 != w0).flatten(0, -4).any(0).any(-1)
                            .any(-1))[:, 0].tolist()
    zeroed = float(w1[..., units, :, :].abs().max())
    untouched = torch.ones(w0.shape[-3], dtype=torch.bool,
                           device=w0.device)
    untouched[units] = False
    kept = bool(torch.equal(w1[..., untouched, :, :],
                            w0[..., untouched, :, :]))
    print(f"erase_watermark church-256 layer {layer}, gandissect, drank "
          f"{WATERMARK_DRANK}: {erase_s:.3f} s, of it the second moments "
          f"(both models) {times.get('collect_2nd_moment', 0):.3f} s, the "
          f"quantile sketch over {rq.count:.0f} key rows x {rq.units} units "
          f"{times.get('quantiles_for_units', 0):.3f} s, the units' ranks "
          f"(normalize of {obs.shape[0]} pixels x {obs.shape[1]} units) "
          f"{times.get('normalize', 0):.3f} s, zero "
          f"{times.get('zero', 0):.4f} s; K2 launches {erase_k2} (general "
          f"{kblur.general_launches}); {nimages} images in {save_s:.3f} s; "
          f"the units equal the host recomputation's: {got == want}; the "
          f"weight changed at {len(changed)} input units (the one-hot "
          f"ones: {set(changed) == got}), max |w| there {zeroed:.1e}, "
          f"elsewhere bit for bit: {kept}")
    if got != want or set(changed) != got or zeroed != 0.0 or not kept:
        raise AssertionError("the gandissect erase zeroed other units "
                             "than the sketch's")
    if kblur.general_launches != 0 or erase_k2 <= 0:
        raise AssertionError(f"the gandissect erase launched K2 {erase_k2} "
                             f"times, general {kblur.general_launches}")
    return {"erase_s": erase_s, "times_s": times, "save_s": save_s,
            "k2": erase_k2, "sketch_rows": rq.count, "units": sorted(got)}


def check_search(rw, kblur, k: int = 12, nrender: int = 12) -> dict:
    """Phase 22, the UI's Search on phase 5's layer-8 rewriter `rw`:
    ``ranking_for_key`` of the dome2tree query key over the 1000 z, then
    ``render_image_batch`` of the ranking with the key's response outlined
    at its 0.99 quantile.  The top `k` must equal a direct ranking: each
    image's largest response from a plain forward of the context, sorted
    (or, where two peaks lie within 1e-5, the same images)."""
    import numpy as np
    import torch

    with open(MASK) as f:
        request = json.load(f)
    rw.revert()
    key = rw.query_key_from_selection(*request["paste"])
    kblur.launches = kblur.general_launches = 0
    sync(rw.device)
    t1 = time.time()
    idx, rq = rw.ranking_for_key(key, k=k)
    sync(rw.device)
    rank_s = time.time() - t1
    rank_k2 = kblur.launches
    level = float(rq.quantiles([0.99])[0, 0])
    kblur.launches = 0
    t1 = time.time()
    renders = rw.render_image_batch(list(idx[:nrender]), key=key,
                                    level=level)
    render_s = time.time() - t1
    render_k2 = kblur.launches
    peaks = []
    with torch.no_grad():
        for lo in range(0, len(rw.zds), rw.stats_batch_size):
            z = torch.as_tensor(rw.zds.zs[lo:lo + rw.stats_batch_size],
                                device=rw.device)
            acts = rw.context_pipe(rw.params, rw.model.make_bag(z))["fmap"]
            peaks.append((acts * key[None, :, None, None]).sum(1)
                         .flatten(1).amax(1))
    peaks = torch.cat(peaks).cpu().numpy()
    direct = np.argsort(-peaks, kind="stable")[:k]
    close = np.allclose(peaks[idx], peaks[direct], rtol=1e-5, atol=0)
    same = list(idx) == list(direct)
    size = rw.x_shape[1]
    print(f"ranking_for_key at {rw.firstlayer} (1000 z, k={k}): "
          f"{rank_s:.3f} s, K2 launches {rank_k2}; top {k} {idx.tolist()}; "
          f"a direct ranking's the same: {same} (peaks within 1e-5: "
          f"{close}); the response's sketch over {rq.count:.0f} pixels, 0.99 "
          f"quantile {level:.4f}; render_image_batch of {nrender} with the "
          f"key outlined: {render_s:.3f} s, K2 launches {render_k2}")
    if not same and not (set(idx) == set(direct) and close):
        raise AssertionError(f"Search ranked {idx}, a direct ranking "
                             f"{direct}")
    if len(renders) != nrender or any(
            im.dtype != np.uint8 or im.shape != (size, size, 3)
            for im in renders):
        raise AssertionError("the Search renders are not uint8 images")
    if kblur.general_launches != 0 or rank_k2 <= 0:
        raise AssertionError(f"Search launched K2 {rank_k2} times, general "
                             f"{kblur.general_launches}")
    return {"rank_s": rank_s, "render_s": render_s, "k2_rank": rank_k2,
            "k2_render": render_k2, "top": idx.tolist(), "level": level,
            "direct_equal": same}


class ToySegmenter:
    """Phases 23 and 24's segmenter: class 1 where an image's red channel
    is above 0, else 2 (tests/test_dissect.py's): a cheap, known labelling."""

    def segment_batch(self, imgs):
        import torch
        return torch.where(imgs[..., 0] > 0, 1, 2)[:, None]


def check_dissect(checkpoint: str, workdir: str, counters,
                  sample_size: int = 1000, layer: str = "layer4",
                  device: str = "cuda") -> dict:
    """Phase 23: ``dissect`` of ProgGAN church-256 (phase 15's checkpoint,
    loaded by the zoo) at `layer` over `sample_size` z upsampled to 64x64,
    with the toy segmenter; ``iou.npy`` finite in [0, 1], a strip per unit,
    ``DissectVis`` reading them back.  `counters()` must stay 0: no kernel
    is on ProgGAN's path."""
    import numpy as np

    from rewriting_torch.dissect import DissectVis, dissect
    from rewriting_torch.models.zoo import load_proggan
    from rewriting_torch.stats import tally

    model, params = load_proggan("church", path=checkpoint, device=device)
    root = os.path.join(workdir, "dissect")
    outdir = os.path.join(root, "church", layer, "toy", str(sample_size))
    times = {}
    t1 = time.time()
    with timed_methods(times, device, (tally, "tally_quantile"),
                       (tally, "tally_conditional_mean"),
                       (tally, "tally_topk")):
        records = dissect(model, params, layer, ToySegmenter(),
                          ["-", "red", "notred"], outdir,
                          sample_size=sample_size, device=device)
    total_s = time.time() - t1
    passes = sum(times.values())
    iou = np.load(os.path.join(outdir, "iou.npy"))
    units = len(records["units"])
    strips = [n for n in os.listdir(os.path.join(outdir, "imgs"))
              if n.endswith(".png")]
    vis = DissectVis(outdir=root, model="church", layers=[layer], seg="toy",
                     sample_size=sample_size)
    strip = vis.image(layer, units - 1)
    launches = counters()
    print(f"dissect ProgGAN church-256 {layer} ({units} units), "
          f"{sample_size} z upsampled to 64x64: {total_s:.3f} s; the "
          f"quantile pass {times.get('tally_quantile', 0):.3f} s, the "
          f"conditional-mean pass "
          f"{times.get('tally_conditional_mean', 0):.3f} s, the top-k pass "
          f"{times.get('tally_topk', 0):.3f} s, the unit strips "
          f"{total_s - passes:.3f} s; iou {iou.shape} in [{iou.min():.4f}, "
          f"{iou.max():.4f}]; {len(strips)} strips, DissectVis read "
          f"{strip.shape} {strip.dtype}; launches {launches}")
    if not np.isfinite(iou).all() or iou.min() < 0 or iou.max() > 1 or \
            iou.shape[0] != units or units != 512 or len(strips) != units:
        raise AssertionError(f"dissect wrote iou {iou.shape}, {len(strips)} "
                             "strips")
    if strip.dtype != np.uint8 or strip.ndim != 3 or any(launches.values()):
        raise AssertionError(f"DissectVis read {strip.shape}; launches "
                             f"{launches}")
    return {"total_s": total_s, "times_s": times, "units": units,
            "iou_range": [float(iou.min()), float(iou.max())],
            "launches": launches}


def check_overfit(rw, kblur, steps: int = 201, repeat_steps: int = 21
                  ) -> dict:
    """Phase 24, the all-weights "overfit" baseline on StyleGAN2
    church-256 (phase 5's rewriter `rw`): ``apply_overfit`` of dome2tree,
    `steps` steps, without and then with a VGG16 relu3_3 feature term
    (seeded VGG16); the loss must fall, every leaf the forward reads must
    move (the noise buffers and latent_avg, which it does not read at
    truncation 1, must not), ``revert`` must restore every leaf bit for
    bit, two runs of `repeat_steps` must be bit for bit equal, and K2 must
    run forward and backward at each upsampling layer (six at 256 px) a
    step."""
    import numpy as np
    import torch

    from rewriting_torch.core import leaves
    from rewriting_torch.metrics.lpips import LPIPS, init_params

    with open(MASK) as f:
        request = json.load(f)
    rw.revert()
    w0 = dict(leaves(rw.params))
    unread = {n for n in w0 if n.startswith(("noises.", "latents."))}
    nup = int(math.log2(rw.model.size)) - 2       # upsampling layers
    vgg = LPIPS(init_params(0), device=rw.device)
    nvgg = sum(p.numel() for p in vgg.convs.parameters())

    def feats(img):
        return vgg.taps(img.permute(0, 3, 1, 2))[2]        # relu3_3

    out = {"vgg_parameters": nvgg}
    for name, fn in (("plain", None), ("vgg_relu3_3", feats)):
        rw.revert()
        kblur.launches = kblur.backward_launches = kblur.general_launches = 0
        sync(rw.device)
        t1 = time.time()
        losses = rw.apply_overfit(request, niter=steps, feature_loss_fn=fn)
        sync(rw.device)
        run_s = time.time() - t1
        after = dict(leaves(rw.params))
        moved = {n for n in w0 if not torch.equal(after[n], w0[n])}
        # two renders build the target (rgb_from_selection and
        # rgbpaste_from_selection): one launch at each upsampling layer
        bwd = kblur.backward_launches / steps
        fwd = (kblur.launches - 2 * nup) / steps
        out[name] = {"s": run_s, "ms_per_step": run_s * 1e3 / steps,
                     "loss": [float(losses[0]), float(losses.min()),
                              float(losses[-1])],
                     "moved": len(moved), "leaves": len(w0),
                     "k2_per_step": [fwd, bwd]}
        print(f"apply_overfit church-256, dome2tree, {steps} steps, "
              f"feature term {name} (VGG16 {nvgg} parameters): {run_s:.3f} "
              f"s ({run_s * 1e3 / steps:.3f} ms a step, the target's "
              f"renders included); loss {losses[0]:.6f} -> {losses[-1]:.6f} "
              f"(least {losses.min():.6f}); {len(moved)} of {len(w0)} "
              f"leaves moved (unread: {sorted(unread)}); K2 launches a step "
              f"{fwd:.2f} forward, {bwd:.2f} backward, general "
              f"{kblur.general_launches}")
        if not losses[-1] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"overfit {name}: loss {losses[0]} -> "
                                 f"{losses[-1]}")
        if moved != set(w0) - unread:
            raise AssertionError(f"overfit {name}: {len(moved)} leaves "
                                 f"moved, unread ones "
                                 f"{sorted(moved & unread)}")
        if fwd != nup or bwd != nup or kblur.general_launches != 0:
            raise AssertionError(f"overfit {name}: K2 {fwd} forward, {bwd} "
                                 f"backward a step, want {nup} each")
        rw.revert()
        back = dict(leaves(rw.params))
        if any(not torch.equal(back[n], t) for n, t in w0.items()):
            raise AssertionError("revert left a leaf of the overfit")
    runs = []
    for _ in range(2):
        rw.revert()
        losses = rw.apply_overfit(request, niter=repeat_steps)
        runs.append((dict(leaves(rw.params)), losses))
    rw.revert()
    same = np.array_equal(runs[0][1], runs[1][1]) and all(
        torch.equal(runs[0][0][n], runs[1][0][n]) for n in w0)
    print(f"apply_overfit {repeat_steps} steps run twice: every leaf and "
          f"loss bit for bit equal: {same}; revert restores all {len(w0)} "
          f"leaves bit for bit")
    if not same:
        raise AssertionError("the overfit does not repeat bit for bit")
    out["repeat_bit_for_bit"] = same
    return out


def check_damage_metric(clean_dir: str, edited_dir: str, workdir: str,
                        n: int = 32, device: str = "cuda") -> dict:
    """Phase 24, then: ``compute_dl`` with l1 and lpips (seeded VGG16)
    over phase 9's `n` clean PNGs against phase 10's edited ones, the
    clean images' segmentations written by the phase as npz files
    (channel 2 holds label 1708 where the toy segmenter says class 1);
    each total against a direct recomputation on the card's tensors
    (1e-5 relative)."""
    import numpy as np
    import torch

    from rewriting_torch.metrics.distances import compute_dl
    from rewriting_torch.metrics.lpips import LPIPS, init_params
    from rewriting_torch.utils.renormalize import decode_png

    def load(d):
        imgs = []
        for i in range(n):
            with open(os.path.join(d, f"{i}.png"), "rb") as f:
                imgs.append(decode_png(f.read()))
        x = torch.as_tensor(np.stack(imgs), device=device).float()
        return x / 255.0 * 2.0 - 1.0                 # zc NHWC
    before, after = load(clean_dir), load(edited_dir)
    seg = ToySegmenter().segment_batch(before)[:, 0]
    segdir = os.path.join(workdir, "damage_seg")
    os.makedirs(segdir)
    for i in range(n):
        s = np.zeros((3,) + tuple(seg.shape[1:]), np.int64)
        s[2] = np.where(seg[i].cpu().numpy() == 1, 1708, 0)
        np.savez(os.path.join(segdir, f"{i}.npz"), seg=s)
    masks = (seg != 1).float()                      # the pixels kept
    params = init_params(0)
    lp = LPIPS(params, device=device)
    out = {}
    for metric in ("l1", "lpips"):
        sync(device)
        t1 = time.time()
        total, count = compute_dl(clean_dir, segdir, edited_dir, range(n),
                                  src=(1708,), srcc=2, metric=metric,
                                  lpips_params=params, batch_size=16,
                                  device=device)
        sync(device)
        dl_s = time.time() - t1
        with torch.no_grad():
            if metric == "l1":
                want = float(((after - before).abs().sum(-1) * masks).sum())
                want_count = int(masks.sum())
            else:
                want = float(lp(before.permute(0, 3, 1, 2),
                                after.permute(0, 3, 1, 2), masks).sum())
                want_count = n
        rel = abs(total - want) / abs(want)
        out[metric] = {"total": total, "count": count, "direct": want,
                       "rel": rel, "s": dl_s}
        print(f"compute_dl {metric} over {n} clean vs edited church-256 "
              f"PNGs: total {total:.6f} over {count} ({dl_s:.3f} s); direct "
              f"on the card's tensors {want:.6f} over {want_count}: "
              f"{rel:.3e} apart (limit 1e-5)")
        if count != want_count or not rel <= 1e-5:
            raise AssertionError(f"compute_dl {metric} {total} over {count}"
                                 f", direct {want} over {want_count}")
    return out


# -- slice 9: the metric networks and the segmenters ---------------------------

# the released unified-parsing model's head widths (its labels.json): 335
# objects and 26 materials, "-" first in each, 365 scenes, 153 parts of 40
# objects.  The labels chip_smoke.py writes are stand-ins at these widths.
UPP_WIDTHS = {"object": 335, "material": 26, "scene": 365, "owners": 40,
              "parts": 153}
# the netdissect colour model's vocabulary
COLOURS = ("black", "blue", "brown", "gray", "green", "orange", "pink",
           "purple", "red", "white", "yellow")
SEG_TOL = 1e-4          # heads' scores card vs CPU, of max; label margins
QUICKDISSECT_SIZE = 100   # z of phase 28's command line (200 until PR 22)


def upp_labeldata(widths=UPP_WIDTHS) -> dict:
    """A unified-parsing labels json at `widths`: "sky", "building" and
    "person" among the objects with parts (the reference's default part
    owners), parts shared between objects, and one part ("window") that is
    also an object, which the segmenter numbers as the object."""
    objects = ["-", "sky", "building", "person", "tree", "window"]
    objects += [f"object{i}" for i in range(len(objects), widths["object"])]
    pool = [f"part{i}" for i in range(max(widths["parts"] - 13, 1))]
    pool.append("window")
    object_part, n = {}, 0
    for k, owner in enumerate(objects[1:1 + widths["owners"]]):
        count = widths["parts"] // widths["owners"] + (
            k < widths["parts"] % widths["owners"])
        object_part[owner] = [pool[(n + j) % len(pool)]
                              for j in range(count)]
        n += count
    used = {p for names in object_part.values() for p in names}
    return {"object": objects,
            "part": ["-"] + [p for p in pool if p in used],
            "material": ["-"] + [f"material{i}"
                                 for i in range(1, widths["material"])],
            "scene": [f"scene{i}" for i in range(widths["scene"])],
            "object_part": object_part}


def write_seeded_weights(root: str, labeldata: dict,
                         which=("inception", "slimnet", "face", "upp",
                                "color"), colour_segsizes=None) -> dict:
    """Seeded weights of the slice-9 networks under the released file
    names in `root` (the layout ``$REWRITING_TPU_WEIGHTS`` gives): the
    pytorch-fid Inception, SlimNet's training checkpoint, the face parser,
    unified parsing with `labeldata`, the colour segmenter; with "faces"
    and "celebhq" in `which`, the StyleGAN2 faces-1024 (rosinality's
    layout) and ProgGAN celebhq-1024 (the reference's) generators of
    phases 34-35.  BatchNorms are identities.  Returns {file: MiB}."""
    import torch

    from rewriting_torch.metrics import fid, inception, slimnet
    from rewriting_torch.segment import faceparse, semantic
    from rewriting_torch.segment.segmenter import upernet_for

    files = {}

    def save(obj, *names):
        path = os.path.join(root, *names)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if isinstance(obj, dict) and all(isinstance(v, (str, list, dict))
                                         for v in obj.values()):
            with open(path, "w") as f:
                json.dump(obj, f)
        else:
            torch.save(obj, path)
        files[os.path.join(*names)] = os.path.getsize(path) / 2 ** 20

    if "inception" in which:
        save(inception.state_dict_from_params(inception.init_params(0)),
             fid.WEIGHTS_FILENAME)
    if "slimnet" in which:
        save({"epoch": 20, "model_state_dict": {
            k: torch.from_numpy(v)
            for k, v in slimnet.init_random_state_dict(0).items()}},
            slimnet.WEIGHTS_FILENAME)
    if "face" in which:
        net = faceparse.BiSeNet()
        save(net.params_to_torch(net.init_params(0)),
             faceparse.WEIGHTS_FILENAME)
    if "upp" in which:
        net = upernet_for(labeldata)
        enc, dec = net.params_to_torch(net.init_params(0))
        save(enc, "upp", "encoder_epoch_40.pth")
        save(dec, "upp", "decoder_epoch_40.pth")
        save(labeldata, "upp", "labels.json")
    if "faces" in which:
        from rewriting_torch.models import SeqStyleGAN2
        faces = SeqStyleGAN2(1024, style_dim=512, n_mlp=8,
                             channel_multiplier=2, device="cpu")
        save(rosinality_checkpoint(faces, faces.init_params(seed=3)),
             "stylegan2_faces.pt")
    if "celebhq" in which:
        from rewriting_torch.models import ProgressiveGenerator
        from rewriting_torch.models.zoo import PROGGAN_ZOO
        pg = ProgressiveGenerator(resolution=1024, device="cpu")
        save(proggan_checkpoint(pg, pg.init_params(seed=4)),
             PROGGAN_ZOO["celebhq"])
    if "color" in which:
        base = ("segmodel", "color-resnet18dilated-ppm_deepsup")
        save(semantic.resnet18_deepstem_to_torch(
            semantic.init_resnet18_deepstem(1)), *base, "encoder_epoch_20.pth")
        ppm = semantic.PPMDecoder(len(COLOURS), 512)
        save(ppm.params_to_torch(ppm.init_params(2)), *base,
             "decoder_epoch_20.pth")
        meta = {"labels": [{"name": c} for c in COLOURS],
                "imageformat": {"byteorder": "BGR",
                                "mean": [0.485, 0.456, 0.406],
                                "stdev": [0.229, 0.224, 0.225]}}
        if colour_segsizes:
            meta["segsizes"] = list(colour_segsizes)
        save(meta, *base, "labels.json")
    return files


def weights_env(path: str):
    """``$REWRITING_TPU_WEIGHTS`` set to `path` within."""
    return environment(REWRITING_TPU_WEIGHTS=path)


def cli_env(weights: str) -> dict:
    return dict(os.environ, REWRITING_TPU_WEIGHTS=weights,
                PYTHONPATH=os.pathsep.join(
                    [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def png_paths(directory: str):
    """The ``{i}.png`` of a samples directory in image order."""
    stems = sorted(int(n[:-4]) for n in os.listdir(directory)
                   if n.endswith(".png") and n[:-4].isdecimal())
    return [os.path.join(directory, f"{i}.png") for i in stems]


def rel_diff(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def top2_margin(scores):
    """The gap between the two largest entries along axis 1."""
    top = scores.topk(2, dim=1).values
    return top[:, 0] - top[:, 1]


def self_fid_limit(sigma, n: int) -> float:
    """The least error to expect of the FID of a set with itself, from
    scipy's float64 ``sqrtm`` of its singular product: each of the d - r
    zero eigenvalues of the d x d covariance (rank r = n - 1 for n images)
    comes out of the square root as about sqrt(eps) times the norm, which
    the trace bounds."""
    import numpy as np

    d = sigma.shape[0]
    rank = min(n - 1, d)
    trace = float(np.trace(sigma.astype(np.float64)))
    return max(d - rank, 1) * float(np.sqrt(np.finfo(np.float64).eps)) \
        * trace


def check_fid(model, params, clean_dir: str, edited_dir: str,
              workdir: str, weights: str, counters, nz: int = 256,
              batch_size: int = 16, device: str = "cuda") -> dict:
    """Phase 25: FID through the seeded pytorch-fid Inception that
    ``FeatureExtractor()`` reads from `weights` (``$REWRITING_TPU_WEIGHTS``
    within): decode images/s (``native.read_batches`` alone), Inception
    images/s (features of device batches alone), ``compute_fid`` of the
    clean PNGs against the edited ones; the card's features against the
    CPU's on 4 images (FORWARD_RTOL of the largest);
    ``get_fid.model_stats`` over `nz` z of (model, params) with its K2
    launches (`counters()`); the ``fid`` command line on the two
    directories (the in-process FID within 1e-3) and ``get_fid --compare``
    of the clean set's statistics with themselves (within
    ``self_fid_limit``).  Three 2048 x 2048 ``sqrtm`` on the host."""
    import numpy as np
    import torch

    from rewriting_torch import native
    from rewriting_torch.metrics import fid, get_fid

    t1 = time.time()
    fe = fid.FeatureExtractor(batch_size=batch_size, device=device)
    load_s = time.time() - t1
    paths = png_paths(clean_dir)
    t1 = time.time()
    batches = list(native.read_batches(paths, batch_size))
    decode_s = time.time() - t1
    dev = [torch.as_tensor(b).to(device) for b in batches]
    fe.device_features(dev[0])
    sync(device)
    t1 = time.time()
    feats = [fe.device_features(b) for b in dev]
    sync(device)
    inception_s = time.time() - t1
    n = sum(len(b) for b in batches)
    parts = {}
    t1 = time.time()
    with timed_methods(parts, device, (fid, "compute_feature_stats"),
                       (fid, "calculate_frechet_distance")):
        distance = fid.compute_fid(clean_dir, edited_dir, fe, batch_size)
    fid_s = time.time() - t1
    mu, sigma = fid.compute_feature_stats(iter(dev), fe)
    cpu = fid.FeatureExtractor(device="cpu")
    rel = rel_diff(feats[0][:4].cpu(), torch.as_tensor(cpu(batches[0][:4])))
    base = counters()
    sync(device)
    t1 = time.time()
    mu_m, sigma_m = get_fid.model_stats(model, params, n=nz,
                                        batch_size=batch_size, feature_fn=fe)
    model_s = time.time() - t1
    launches = {k: v - base[k] for k, v in counters().items()}
    print(f"FID (seeded Inception, {n} clean church-256 PNGs): checkpoint "
          f"read in {load_s:.3f} s; decode {n / decode_s:.2f} images/s "
          f"(read_batches alone, {decode_s:.3f} s); Inception "
          f"{n / inception_s:.2f} images/s (device batches of {batch_size} "
          f"alone, {inception_s:.3f} s); compute_fid clean vs edited "
          f"{distance:.6e} in {fid_s:.3f} s (the two sets' statistics "
          f"{parts['compute_feature_stats']:.3f} s, the Fréchet distance "
          f"{parts['calculate_frechet_distance']:.3f} s); card vs CPU features "
          f"{rel:.3e} of max (limit {FORWARD_RTOL}); model_stats over {nz} "
          f"z at batch {batch_size} {model_s:.3f} s ({nz / model_s:.2f} "
          f"images/s), launches {launches}")
    if not (np.isfinite(distance) and distance > 0):
        raise AssertionError(f"FID clean vs edited {distance}")
    if not rel <= FORWARD_RTOL:
        raise AssertionError(f"Inception card vs CPU {rel}")
    if mu_m.shape != (2048,) or sigma_m.shape != (2048, 2048) or \
            not np.isfinite(sigma_m).all():
        raise AssertionError(f"model_stats {mu_m.shape} {sigma_m.shape}")
    if launches["k2"] <= 0 or launches["k2_general"] or launches["k1"] or \
            launches["k3"] or launches["k3_general"]:
        raise AssertionError(f"model_stats launches {launches}")
    clean_npz = os.path.join(workdir, "fid_clean.npz")
    fid.save_stats(clean_npz, mu, sigma)
    fid.save_stats(os.path.join(workdir, "fid_model.npz"), mu_m, sigma_m)
    env = cli_env(weights)
    cli = run_cli("rewriting_torch.metrics.fid",
                  [clean_dir, edited_dir, "--batch_size", str(batch_size)],
                  workdir, env)
    compare = run_cli("rewriting_torch.metrics.get_fid",
                      ["--compare", clean_npz, clean_npz], workdir, env)
    self_fid = float(compare["output"])
    trace = float(np.trace(sigma.astype(np.float64)))
    limit = self_fid_limit(sigma, n)
    print(f"  fid command line {float(cli['output']):.6e} (in process "
          f"{distance:.6e}, limit 1e-3 of it); get_fid --compare of the "
          f"clean statistics with themselves {self_fid:.3e} (trace "
          f"{trace:.6e}: {abs(self_fid) / trace:.3e} of it; limit "
          f"{limit:.3e}, {limit / trace:.3e} of it); their launches {cli}, "
          f"{compare}")
    if not abs(float(cli["output"]) - distance) <= 1e-3 * distance:
        raise AssertionError(f"fid command line {cli['output']}, in process "
                             f"{distance}")
    if not abs(self_fid) <= limit:
        raise AssertionError(f"FID of a set with itself {self_fid}, limit "
                             f"{limit}")
    return {"images": n, "load_s": load_s,
            "decode_images_per_s": n / decode_s,
            "inception_images_per_s": n / inception_s,
            "compute_fid_s": fid_s, "compute_fid_parts_s": parts,
            "fid_clean_edited": distance,
            "fid_self": self_fid, "trace": trace, "fid_self_limit": limit,
            "card_vs_cpu": rel, "model_stats_s": model_s,
            "model_stats_launches": launches, "cli": cli,
            "compare_cli": compare}


def check_segmenters(clean_dir: str, batch_size: int = 16,
                     device: str = "cuda") -> dict:
    """Phase 26: ``load_segmenter("netpqc")`` (unified parsing with all
    parts and quads, merged with the colour segmenter) and
    ``load_seg_model("faces_clean")`` (BiSeNet at 512) from
    ``$REWRITING_TPU_WEIGHTS``, each over the clean PNGs as uint8 device
    batches (ms a batch); on 2 images the card against the CPU: the
    heads' scores before their softmax within SEG_TOL of their largest,
    labels equal where the top-two margin exceeds SEG_TOL (the quads of an
    image where its object labels all agree); ``predict_single_class`` of
    the most frequent object, material and part against the labels."""
    import torch

    from rewriting_torch import native
    from rewriting_torch.metrics.load_seg import load_seg_model
    from rewriting_torch.segment import load_segmenter
    from rewriting_torch.segment.nn import resize_nearest
    from rewriting_torch.segment.semantic import resnet18_dilated_features

    t1 = time.time()
    seg, labels = load_segmenter("netpqc", device=device)
    face = load_seg_model("faces_clean", device=device)
    load_s = time.time() - t1
    batches = [torch.as_tensor(b).to(device)
               for b in native.read_batches(png_paths(clean_dir),
                                            batch_size)]
    out = {"load_s": load_s, "labels": len(labels)}
    quads = {}
    for name, model in (("netpqc", seg), ("face", face)):
        model.segment_batch(batches[0])
        sync(device)
        t1 = time.time()
        with timed_methods(quads, device, (seg.segmenters[0],
                                           "expand_segment_quad")):
            segs = [model.segment_batch(b) for b in batches]
        sync(device)
        out[f"{name}_ms_per_batch"] = (time.time() - t1) / len(batches) * 1e3
        want = (batch_size, 6 if name == "netpqc" else 1) + tuple(
            batches[0].shape[1:3])
        if tuple(segs[0].shape) != want or segs[0].dtype != torch.int64 or \
                segs[0].device != batches[0].device:
            raise AssertionError(f"{name} labels {segs[0].shape} "
                                 f"{segs[0].dtype} {segs[0].device}")
        out[f"{name}_distinct"] = [int(torch.unique(torch.cat(segs)[:, c])
                                       .numel())
                                   for c in range(segs[0].shape[1])]
    out["quad_ms_per_batch"] = quads["expand_segment_quad"] / len(
        batches) * 1e3

    # the card against the CPU on 2 images (at their size, which is the
    # segmenters' 256): the heads' scores before their softmax, held; the
    # softmax maps, printed (at a near tie a softmax moves by up to a
    # quarter of its logits' change, and seeded logits reach 30-80)
    x = batches[0][:2]
    size = tuple(x.shape[1:3])
    cpu_seg, _ = load_segmenter("netpqc", device="cpu")
    cpu_face = load_seg_model("faces_clean", device="cpu")
    upp, col = seg.segmenters
    cpu_upp, cpu_col = cpu_seg.segmenters

    def colour_logits(s, images):
        feats = resnet18_dilated_features(s.params["encoder"],
                                          s.normalize(images),
                                          s.dilate_scale)
        return s.decoder.logits(s.params["decoder"], feats, seg_size=size)
    with torch.no_grad():
        heads = upp.net.logits(upp.params, upp.normalize(x), size)
        cheads = cpu_upp.net.logits(cpu_upp.params,
                                    cpu_upp.normalize(x.cpu()), size)
        heads["colour"] = colour_logits(col, x)
        cheads["colour"] = colour_logits(cpu_col, x.cpu())
    score_err = {k: rel_diff(heads[k].cpu(), cheads[k]) for k in heads}
    pred, parts = upp.raw_seg_prediction(x)
    cpred, cparts = cpu_upp.raw_seg_prediction(x.cpu())
    ccol = cpu_col.raw_seg_prediction(x.cpu())
    maps = [(pred[k], cpred[k]) for k in pred]
    maps += [(parts[i], cparts[i]) for i in parts]
    maps.append((col.raw_seg_prediction(x), ccol))
    map_err = max(float((a.cpu() - b).abs().max()) for a, b in maps)
    scores, cscores = face.scores(x), cpu_face.scores(x.cpu())
    score_err["face"] = rel_diff(scores.cpu(), cscores)
    card, host = seg.segment_batch(x).cpu(), cpu_seg.segment_batch(x.cpu())
    sure_obj = top2_margin(cpred["object"]) > SEG_TOL
    sure = {0: sure_obj, 1: top2_margin(cpred["material"]) > SEG_TOL,
            2: sure_obj & torch.stack([top2_margin(p) > SEG_TOL
                                       for p in cparts.values()]).all(0),
            5: top2_margin(ccol) > SEG_TOL}
    differ = {c: int(((card[:, c] != host[:, c]) & held).sum())
              for c, held in sure.items()}
    whole = [i for i in range(2) if torch.equal(card[i, 0], host[i, 0])]
    differ["quads"] = int((card[whole][:, 3:5] != host[whole][:, 3:5]).sum())
    fcard, fhost = face.segment_batch(x).cpu(), cpu_face.segment_batch(
        x.cpu())
    fsure = resize_nearest(top2_margin(cscores) > SEG_TOL
                           * cscores.abs().max(), fcard.shape[-2:])
    differ["face"] = int(((fcard[:, 0] != fhost[:, 0]) & fsure).sum())
    held = {c: float(m.float().mean()) for c, m in sure.items()}
    print(f"segmenters (seeded, {len(labels)} labels): netpqc "
          f"{out['netpqc_ms_per_batch']:.3f} ms a batch of {batch_size} "
          f"256-px images (the host quad split "
          f"{out['quad_ms_per_batch']:.3f} ms of it), face parser "
          f"{out['face_ms_per_batch']:.3f} ms "
          f"(at 512); distinct labels a channel {out['netpqc_distinct']}, "
          f"face {out['face_distinct']}; card vs CPU on 2 images: the "
          f"heads' scores {score_err} of their largest (limit {SEG_TOL}), "
          f"softmax maps {map_err:.3e} apart; labels differing where the "
          f"margin exceeds {SEG_TOL}: {differ} (held shares {held}, quads "
          f"of images {whole}); loaded in {load_s:.3f} s")
    if not max(score_err.values()) <= SEG_TOL or any(differ.values()):
        raise AssertionError(f"segmenters card vs CPU: scores {score_err}, "
                             f"labels {differ}")

    # predict_single_class against the labels, where they are sure
    first_part = (len(upp.labeldata["object"]) - 1) * upp.divmult + len(
        upp.labeldata["material"])

    def most_frequent(values):
        values = values[values > 0]
        return int(torch.mode(values).values) if values.numel() else None
    picks = {"object": (most_frequent(card[:, 0]), 0),
             "material": (most_frequent(card[:, 1]), 1),
             "part": (most_frequent(card[:, 2][card[:, 2] >= first_part]),
                      2)}
    checked = {}
    for kind, (classnum, channel) in picks.items():
        if classnum is None:
            checked[kind] = None
            continue
        score, mask = seg.predict_single_class(x, classnum)
        labels_c = card[:, channel] == classnum
        bad = int(((mask.cpu() != labels_c) & sure[channel]).sum())
        checked[kind] = {"class": classnum, "pixels": int(labels_c.sum()),
                         "differ": bad, "score_max": float(score.max())}
        if bad or not bool(torch.isfinite(score).all()):
            raise AssertionError(f"predict_single_class {kind} {classnum}: "
                                 f"{bad} pixels differ from the labels")
    print(f"  predict_single_class against the labels: {checked}")
    if checked["object"] is None or checked["material"] is None:
        raise AssertionError(f"no object or material label to check: "
                             f"{checked}")
    out.update({"score_err": score_err, "map_err": map_err,
                "differ": differ, "held": held,
                "predict_single_class": checked})
    return out


def check_smiles(clean_dir: str, n: int = 64, batch_size: int = 16,
                 device: str = "cuda") -> dict:
    """Phase 27: ``count_smiles`` over the clean PNGs with the mouth
    heuristic (the face parser from ``$REWRITING_TPU_WEIGHTS``) and with
    ``default_classifier()`` (SlimNet, since celeba_20.pth is there); each
    count equals the classifier's direct count on the stacked images;
    images/s of each."""
    import numpy as np
    import torch

    from rewriting_torch.metrics import num_smiles, slimnet
    from rewriting_torch.native import read_image_rgb
    from rewriting_torch.utils.renormalize import renormalize

    stacked = renormalize(np.stack([read_image_rgb(p) for p in png_paths(
        clean_dir)[:n]]).astype(np.float32) / 255.0, "pt", "zc")
    out = {}
    for name, clf in (("mouth", num_smiles.mouth_heuristic_classifier(
                          device=device)),
                      ("slimnet", num_smiles.default_classifier(device))):
        if name == "slimnet" and not isinstance(clf,
                                                slimnet.SlimNetClassifier):
            raise AssertionError("default_classifier is not SlimNet")
        clf(stacked[:batch_size])
        sync(device)
        t1 = time.time()
        count = num_smiles.count_smiles(clean_dir, n=n,
                                        batch_size=batch_size,
                                        classifier=clf)
        sync(device)
        wall = time.time() - t1
        direct = int(torch.as_tensor(clf(stacked)).sum())
        out[name] = {"count": count, "direct": direct, "s": wall,
                     "images_per_s": n / wall}
        print(f"count_smiles {name}: {count} of {n} ({n / wall:.2f} "
              f"images/s, {wall:.3f} s); the direct count {direct}")
        if count != direct:
            raise AssertionError(f"count_smiles {name} {count}, direct "
                                 f"{direct}")
    return out


def check_quickdissect(checkpoint: str, workdir: str, weights: str,
                       sample_size: int = QUICKDISSECT_SIZE,
                       layer: str = "layer4") -> dict:
    """Phase 28: ``python3 -m rewriting_torch.dissect`` on the ProgGAN
    checkpoint file with ``--seg netpqc`` from `weights`: ``iou.npy``
    finite in [0, 1], a strip per unit, the done marker, ``DissectVis``
    reading them back, and no kernel launched."""
    import numpy as np

    from rewriting_torch.dissect import DissectVis

    root = os.path.join(workdir, "quickdissect")
    run = run_cli("rewriting_torch.dissect",
                  ["--model", checkpoint, "--layer", layer, "--seg",
                   "netpqc", "--sample_size", str(sample_size), "--outdir",
                   root], workdir, cli_env(weights))
    name = os.path.splitext(os.path.basename(checkpoint))[0]
    outdir = os.path.join(root, name, layer, "netpqc", str(sample_size))
    iou = np.load(os.path.join(outdir, "iou.npy"))
    strips = [n for n in os.listdir(os.path.join(outdir, "imgs"))
              if n.endswith(".png")]
    vis = DissectVis(outdir=root, model=name, layers=[layer], seg="netpqc",
                     sample_size=sample_size)
    units = len(vis.labels[layer])
    strip = vis.image(layer, units - 1)
    labelled = sorted({vis.label(layer, u) for u in range(units)})
    launches = {k: run[k] for k in ("k1", "k2", "k2_backward", "k2_general",
                                    "k3")}
    print(f"quickdissect command line, ProgGAN {layer} ({units} units) with "
          f"netpqc over {sample_size} z: {run['wall_s']:.3f} s wall; iou "
          f"{iou.shape} in [{iou.min():.4f}, {iou.max():.4f}]; "
          f"{len(strips)} strips; {len(labelled)} distinct best labels; "
          f"DissectVis read {strip.shape} {strip.dtype}; launches {launches}")
    if not np.isfinite(iou).all() or iou.min() < 0 or iou.max() > 1 or \
            iou.shape[0] != units or units != 512 or len(strips) != units:
        raise AssertionError(f"quickdissect wrote iou {iou.shape}, "
                             f"{len(strips)} strips")
    if not os.path.isfile(os.path.join(outdir, "done.txt")) or \
            strip.dtype != np.uint8 or any(launches.values()):
        raise AssertionError(f"quickdissect: done marker, strip {strip.dtype}"
                             f", launches {launches}")
    return {"wall_s": run["wall_s"], "units": units,
            "iou_range": [float(iou.min()), float(iou.max())],
            "labels": len(labelled), "launches": launches}


# -- slice 10: the server, the UI and the paper's metric pipeline ----------

# phase 31: the church chain of the experiment DAG, at PIPELINE_N images
PIPELINE_STAGES = ("sample_church", "edit_dome2spire", "seg_church_clean",
                   "seg_dome2spire", "correct_dome2spire", "dist_dome2spire")
PIPELINE_N = 32
PATCH_CROPS = (8, 16)   # phase 32: two sqrtm of 2048 x 2048 on the host
PATCH_N = 32


def http(method: str, url: str, body=None, timeout: float = 600):
    """(status, content type, body bytes) of one request; an HTTP error
    is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def served(method: str, url: str, body=None):
    """The answer of a request that must succeed: JSON decoded, a PNG as
    its bytes; any other status (a 500 not asked for) raises."""
    code, ctype, data = http(method, url, body)
    if code != 200:
        raise AssertionError(f"{method} {url} answered {code}: "
                             f"{data[:2000]!r}")
    return json.loads(data) if ctype == "application/json" else data


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def lsb_apart(np, a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16)
                      - np.asarray(b, np.int16)).max())


def check_server(gw, workdir: str, counters, steps: int = 2001,
                 side_steps: int = 201, npreview: int = 5) -> dict:
    """Phase 29, the server: ``serve(gw, port=0)`` in a thread over the
    layer-8 rewriter `gw`, and over a real socket, in turn: ``/status``;
    ``/preview`` (`npreview` times, each PNG decoded within 1 LSB of the
    in-process render); ``/edit`` of dome2tree (rank 1, `steps` steps),
    whose weight must equal bit for bit the same ``apply_edit`` made in
    this thread; ``/edit`` by the fast solve and by erase (`side_steps`);
    ``/edit_batch`` of ``BATCH_REQUESTS`` (`side_steps`), each edit's
    preview against ``preview_edits``; ``/commit_batch_edit``;
    ``/revert`` (the original weights exactly); ``/save`` read back through
    ``paramio``; 404 and 500 as JSON.  A 500 not asked for fails the
    phase.  Returns the times and the K2 launches of each request."""
    import threading

    import numpy as np
    import torch

    from rewriting_torch.core import leaves
    from rewriting_torch.rewrite.multi import preview_edits
    from rewriting_torch.serve import serve
    from rewriting_torch.utils import paramio, renormalize

    def timed_request(method, url, body=None):
        before = counters()
        t1 = time.time()
        answer = served(method, url, body)
        wall = time.time() - t1
        now = counters()
        return answer, wall, {k: now[k] - before[k] for k in now}

    def preview(query="imgnum=3"):
        png, wall, launches = timed_request("GET",
                                            f"{base}/preview?{query}")
        if png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"/preview?{query} is not a PNG")
        return renormalize.decode_png(png), wall, launches

    with open(MASK) as f:
        request = json.load(f)
    requests = []
    for name in BATCH_REQUESTS:
        with open(os.path.join(MASKS, "church", f"{name}.json")) as f:
            requests.append(json.load(f))
    gw.revert()
    w0 = gw.target_weight().clone()
    httpd = serve(gw, port=0)
    service = httpd.service
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {}
    try:
        status = served("GET", base + "/status")
        want = {"model": "SeqStyleGAN2", "window": [gw.firstlayer,
                                                    gw.lastlayer],
                "edits_applied": 0, "k_shape": list(gw.k_shape),
                "zds_size": len(gw.zds)}
        if status != want:
            raise AssertionError(f"/status {status}, want {want}")

        walls, launches = [], []
        for _ in range(npreview):
            img, wall, n = preview()
            walls.append(wall)
            launches.append(n)
        first = img
        lsb = lsb_apart(np, img, gw.render_image(3))
        out["preview_ms"] = sorted(walls)[len(walls) // 2] * 1e3
        out["preview_launches"] = launches[-1]
        if lsb > 1 or img.shape != (gw.model.size, gw.model.size, 3):
            raise AssertionError(f"/preview {img.shape}, {lsb} LSB from "
                                 "the in-process render")

        answer, wall, n = timed_request(
            "POST", base + "/edit", {"request": request, "rank": 1,
                                     "niter": steps})
        served_w = gw.target_weight().clone()
        out["edit_s"], out["edit_launches"] = wall, n
        img, _, _ = preview()
        edited_lsb = lsb_apart(np, img, gw.render_image(3))
        with service.lock:      # no request runs meanwhile
            gw.revert()
            t1 = time.time()
            gw.apply_edit(request, rank=1, niter=steps)
            sync(gw.device)
            out["main_thread_edit_s"] = time.time() - t1
            same = torch.equal(gw.target_weight(), served_w)
        print(f"served /edit dome2tree ({steps} steps): {wall:.3f} s, "
              f"answer {answer}, K2 launches {n}; the weight equals the "
              f"same apply_edit in the main thread bit for bit: {same} "
              f"({out['main_thread_edit_s']:.3f} s there); the edited "
              f"preview {edited_lsb} LSB from the in-process render")
        if answer != {"ok": True, "edits_applied": 1} or not same or \
                edited_lsb > 1 or torch.equal(served_w, w0):
            raise AssertionError("the served edit differs from the "
                                 "main thread's or changed nothing")

        for method in ("fast", "erase"):
            before_w = gw.target_weight().clone()
            answer, wall, n = timed_request(
                "POST", base + "/edit", {"request": request,
                                         "niter": side_steps,
                                         "method": method})
            out[f"{method}_s"], out[f"{method}_launches"] = wall, n
            print(f"served /edit method {method} ({side_steps} steps): "
                  f"{wall:.3f} s, K2 launches {n}")
            if not answer["ok"] or torch.equal(gw.target_weight(),
                                               before_w):
                raise AssertionError(f"/edit {method} changed nothing")

        answer, wall, n = timed_request(
            "POST", base + "/edit_batch", {"requests": requests,
                                           "niter": side_steps})
        losses = answer["final_losses"]
        out["batch_s"], out["batch_launches"] = wall, n
        out["batch_losses"] = losses
        batch_lsb = []
        for k in range(len(requests)):
            img, _, n = preview(f"imgnum=3&batch_index={k}")
            direct = renormalize.as_image(np.clip(preview_edits(
                gw, [service._batch_weights[k]], gw.zds.zs[3:4])[0, 0],
                -1, 1))
            batch_lsb.append(lsb_apart(np, img, direct))
        out["batch_preview_launches"] = n
        print(f"served /edit_batch of {len(requests)} ({side_steps} "
              f"steps): {wall:.3f} s, final losses "
              f"{[round(v, 6) for v in losses]}, K2 launches "
              f"{out['batch_launches']}; batch previews {batch_lsb} LSB "
              f"from preview_edits, K2 launches a preview {n}")
        if answer["n"] != len(requests) or not np.isfinite(losses).all() \
                or max(batch_lsb) > 1:
            raise AssertionError(f"/edit_batch {answer}, previews "
                                 f"{batch_lsb} LSB")

        served("POST", base + "/commit_batch_edit", {"index": 2})
        if not torch.equal(gw.target_weight(), service._batch_weights[2]):
            raise AssertionError("/commit_batch_edit did not commit edit 2")
        served("POST", base + "/revert", {})
        now, pristine = dict(leaves(gw.params)), dict(leaves(
            gw.original_params))
        reverted = now.keys() == pristine.keys() and all(
            torch.equal(now[k], pristine[k]) for k in now)
        img, _, _ = preview()
        if not reverted or not torch.equal(gw.target_weight(), w0) or \
                lsb_apart(np, img, first) > 1:
            raise AssertionError("/revert did not restore the original "
                                 "weights and preview")
        path = os.path.join(workdir, "served_params.npz")
        answer = served("POST", f"{base}/save?path={path}", {})
        loaded = dict(leaves(paramio.load_params(path)))
        mine = dict(leaves(gw.params))
        if answer != {"ok": True, "path": path} or loaded.keys() != \
                mine.keys() or not all(torch.equal(loaded[k], mine[k])
                                       for k in mine):
            raise AssertionError("/save does not read back as gw.params")
        errors = {}
        for method, url, body, code in (("GET", "/nope", None, 404),
                                        ("POST", "/nope", {}, 404),
                                        ("POST", "/edit", {}, 500)):
            got, ctype, data = http(method, base + url, body)
            errors[f"{method} {url}"] = got
            if got != code or ctype != "application/json" or \
                    "error" not in json.loads(data):
                raise AssertionError(f"{method} {url} answered {got} "
                                     f"{data[:200]!r}, want {code} JSON")
        status = served("GET", base + "/status")
        if status["edits_applied"] != 0:
            raise AssertionError(f"/status after /revert {status}")
        out["errors"] = errors
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    print(f"server: preview {out['preview_ms']:.3f} ms (median of "
          f"{npreview}), K2 launches a preview "
          f"{out['preview_launches']['k2']}; /edit {out['edit_s']:.3f} s; "
          f"fast {out['fast_s']:.3f} s, erase {out['erase_s']:.3f} s, "
          f"batch {out['batch_s']:.3f} s; commit, revert, save and the "
          f"errors {out['errors']} as asked")
    return out


def check_serve_command_line(gw, workdir: str, weights: str,
                             timeout: float = 300) -> dict:
    """Phase 29, the command line: ``python3 -m rewriting_torch.serve
    --dataset church --layer 8 --port <free port>`` in a child process on
    the checkpoint in `weights`; once it prints "editing server on",
    ``/status`` and ``/preview?imgnum=3`` (within 1 LSB of `gw`'s render:
    the same checkpoint, truncation and z), then it is stopped."""
    import queue
    import threading

    import numpy as np

    from rewriting_torch.utils.renormalize import decode_png

    gw.revert()
    port = free_port()
    log = open(os.path.join(workdir, "serve_stderr.txt"), "w")
    t1 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rewriting_torch.serve", "--dataset",
         "church", "--layer", "8", "--port", str(port)], cwd=workdir,
        env=cli_env(weights), stdout=subprocess.PIPE, stderr=log, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(line) for line in
                                              proc.stdout], daemon=True)
    reader.start()
    try:
        printed = []
        while not any("editing server on" in p for p in printed):
            left = t1 + timeout - time.time()
            if proc.poll() is not None or left <= 0:
                log.flush()
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"the serve command line exited "
                                     f"{proc.returncode} or timed out; "
                                     f"printed {printed}:\n{tail}")
            try:
                printed.append(lines.get(timeout=min(left, 5.0)))
            except queue.Empty:
                pass
        ready_s = time.time() - t1
        base = f"http://127.0.0.1:{port}"
        status = served("GET", base + "/status")
        t2 = time.time()
        img = decode_png(served("GET", base + "/preview?imgnum=3"))
        preview_s = time.time() - t2
        lsb = lsb_apart(np, img, gw.render_image(3))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    print(f"python3 -m rewriting_torch.serve --dataset church --layer 8: "
          f"ready in {ready_s:.3f} s ({printed[-1].strip()!r}); /status "
          f"{status}; /preview in {preview_s * 1e3:.1f} ms, {lsb} LSB from "
          f"the in-process render; stopped (exit {proc.returncode})")
    if status["zds_size"] != 1000 or status["edits_applied"] != 0 or \
            lsb > 1:
        raise AssertionError(f"serve command line: {status}, {lsb} LSB")
    return {"ready_s": ready_s, "preview_s": preview_s, "lsb": lsb}


def check_ui(gw, counters, steps: int = 201) -> dict:
    """Phase 29, the UI headless: ``GanRewriteApp(gw, size=256,
    num_canvases=4)``; dome2tree's object, paste and key painted on the
    canvases of its images and picked; the request equal to the file's;
    ``exec_request`` (`steps` steps); the canvases against the rewriter's
    renders, the original toggled and back, Search, revert.  Canvases are
    decoded PNGs, held within 1 LSB of ``render_image_batch``."""
    import base64
    import re

    import numpy as np

    from rewriting_torch.ui import GanRewriteApp
    from rewriting_torch.utils.renormalize import decode_png

    def shown(app):
        return np.stack([decode_png(base64.b64decode(re.sub(
            "^data:image/.+;base64,", "", c.image))) for c in app.canvases])

    def renders(app):
        return np.stack(gw.render_image_batch(app.canvas_imgnums))

    def launches(before):
        now = counters()
        return {k: now[k] - before[k] for k in now}

    with open(MASK) as f:
        request = json.load(f)
    (o_img, o_mask), (p_img, p_mask) = request["object"], request["paste"]
    k_img, k_mask = request["key"][0]
    gw.revert()
    base = counters()
    t1 = time.time()
    app = GanRewriteApp(gw, size=256, num_canvases=4)
    build_s = time.time() - t1
    build_launches = launches(base)
    if lsb_apart(np, shown(app), renders(app)) > 1:
        raise AssertionError("the canvases differ from the renders")
    imgs = [o_img, p_img] + [i for i in range(4) if i not in (o_img, p_img)]
    app.show_images(imgs[:4])
    pristine = shown(app)
    app.canvases[0].set("mask", o_mask, _from_view=True)
    app.pick_object()
    app.canvases[1].set("mask", p_mask, _from_view=True)
    base = counters()
    app.pick_paste()
    paste_launches = launches(base)
    app.canvases[app.canvas_imgnums.index(k_img)].set("mask", k_mask,
                                                      _from_view=True)
    app.add_key()
    want = {"paste": [p_img, p_mask], "object": [o_img, o_mask],
            "key": [[k_img, k_mask]]}
    if app.current_request() != want:
        raise AssertionError(f"the app's request is not the file's")
    app.niter_box.value = str(steps)
    base = counters()
    t1 = time.time()
    app.exec_request()
    sync(gw.device)
    exec_s = time.time() - t1
    exec_launches = launches(base)
    edited = shown(app)
    if app.status != "edited" or lsb_apart(np, edited, renders(app)) > 1 \
            or lsb_apart(np, edited, pristine) <= 1:
        raise AssertionError("the edited canvases are not the edited "
                             "model's renders")
    app.toggle_original()
    original = shown(app)
    app.toggle_original()
    if lsb_apart(np, original, pristine) > 1 or lsb_apart(
            np, shown(app), edited) > 1:
        raise AssertionError("Toggle Original does not show the original "
                             "and back")
    base = counters()
    t1 = time.time()
    ranking = app.search()
    search_s = time.time() - t1
    search_launches = launches(base)
    if app.canvas_imgnums != [int(i) for i in np.asarray(ranking)[:4]] or \
            app.query_key is None:
        raise AssertionError(f"search showed {app.canvas_imgnums}, ranked "
                             f"{ranking}")
    app.revert()
    if lsb_apart(np, shown(app), renders(app)) > 1 or app.original_shown:
        raise AssertionError("revert did not repaint the original model")
    print(f"UI: GanRewriteApp at {app.size} px, 4 canvases, built in "
          f"{build_s:.3f} s (K2 launches {build_launches['k2']}); the paste "
          f"composite K2 {paste_launches['k2']}; exec_request ({steps} "
          f"steps) {exec_s:.3f} s, K2 {exec_launches['k2']} forward, "
          f"{exec_launches['k2_backward']} backward; search {search_s:.3f} s "
          f"(K2 {search_launches['k2']}), images {app.canvas_imgnums}; "
          f"canvases within 1 LSB of the renders throughout")
    return {"build_s": build_s, "exec_s": exec_s, "search_s": search_s,
            "canvas_launches": build_launches,
            "paste_launches": paste_launches, "exec_launches":
            exec_launches, "search_launches": search_launches}


def netpqc_unsure(seg, x):
    """(B, 6, H, W) bool: where ``load_segmenter("netpqc")``'s labels of
    uint8 images `x` may differ between two runs on the card: the top-two
    margin of a head within SEG_TOL, and a quad channel wherever an object
    label of its image is unsure."""
    import torch

    upp, col = seg.segmenters
    pred, parts = upp.raw_seg_prediction(x)
    obj = top2_margin(pred["object"]) <= SEG_TOL
    mat = top2_margin(pred["material"]) <= SEG_TOL
    part = obj | torch.stack([top2_margin(p) <= SEG_TOL
                              for p in parts.values()]).any(0)
    quad = obj.flatten(1).any(1)[:, None, None].expand_as(obj)
    colour = top2_margin(col.raw_seg_prediction(x)) <= SEG_TOL
    return torch.stack([obj, mat, part, quad, quad, colour], 1)


def label_differences(seg, paths, dir_a: str, dir_b: str,
                      batch_size: int = 16, device: str = "cuda") -> dict:
    """Labels of two label directories compared image by image: the count
    that differ, and of those the count where ``netpqc_unsure`` is false
    on the images of `paths` (which must be 0)."""
    import numpy as np
    import torch

    from rewriting_torch import native

    differ = sure_differ = 0
    for lo in range(0, len(paths), batch_size):
        idx = range(lo, min(lo + batch_size, len(paths)))
        a = np.stack([np.load(os.path.join(dir_a, f"{i}.npz"))["seg"]
                      for i in idx])
        b = np.stack([np.load(os.path.join(dir_b, f"{i}.npz"))["seg"]
                      for i in idx])
        if np.array_equal(a, b):
            continue
        x = torch.as_tensor(next(native.read_batches(
            paths[lo:lo + batch_size], batch_size))).to(device)
        unsure = netpqc_unsure(seg, x).cpu().numpy()
        differ += int((a != b).sum())
        sure_differ += int(((a != b) & ~unsure).sum())
    return {"differ": differ, "sure_differ": sure_differ}


def check_metric_pipelines(model, params, clean_dir: str, edited_dir: str,
                           workdir: str, counters, n: int = 64,
                           batch_size: int = 16, device: str = "cuda"
                           ) -> dict:
    """Phase 30: ``seg_stats.process`` with netpqc (``load_seg_model``,
    from ``$REWRITING_TPU_WEIGHTS``) over `n` clean and n/2 edited PNGs;
    ``seg_correct_mod.compute_dl`` with dome2spire's labels and with the
    two most frequent labels, each equal to a direct count over the files;
    then ``run_fused`` (netpqc, the seeded ``FeatureExtractor``) against the
    staged chain at the same batch size (``sample_clean``,
    ``seg_stats.process``, ``compute_feature_stats`` over the PNGs), both
    with cuDNN's deterministic algorithms: PNGs byte-identical, labels
    equal wherever the heads' margin exceeds SEG_TOL, mu and sigma within
    1e-6 of their largest entry; then the fused pass twice with the
    default algorithms, how far their PNGs lie apart printed."""
    import numpy as np

    from rewriting_torch.metrics import fid, seg_correct_mod, seg_stats
    from rewriting_torch.metrics.fused_pipeline import run_fused
    from rewriting_torch.metrics.load_seg import (
        load_seg_info_from_exp_name, load_seg_model)
    from rewriting_torch.metrics.sample import sample_clean
    from rewriting_torch.native import read_image_rgb
    from rewriting_torch.ops import precision

    def launches_since(before):
        now = counters()
        return {k: now[k] - before[k] for k in now}

    root = os.path.join(workdir, "pipeline30")
    t1 = time.time()
    seg = load_seg_model("church_clean", device=device)
    fe = fid.FeatureExtractor(batch_size=batch_size, device=device)
    load_s = time.time() - t1
    seg_dirs = {}
    seg_s = {}
    for name, src, count in (("church_clean", clean_dir, n),
                             ("dome2spire", edited_dir, n // 2)):
        seg_dirs[name] = os.path.join(root, "seg", name)
        sync(device)
        t1 = time.time()
        seg_stats.process(seg, src, seg_dirs[name], n=count,
                          batch_size=batch_size)
        seg_s[name] = time.time() - t1
        files = sorted(f for f in os.listdir(seg_dirs[name])
                       if f.endswith(".npz"))
        first = np.load(os.path.join(seg_dirs[name], "0.npz"))["seg"]
        if len(files) != count or first.dtype != np.int64 or \
                first.shape != (6, model.size, model.size):
            raise AssertionError(f"seg_stats wrote {len(files)} files, "
                                 f"{first.dtype} {first.shape}")

    def direct_count(tgt, tgtc, src, srcc):
        total = count = 0
        for i in range(n // 2):
            b = np.load(os.path.join(seg_dirs["church_clean"],
                                     f"{i}.npz"))["seg"][srcc]
            a = np.load(os.path.join(seg_dirs["dome2spire"],
                                     f"{i}.npz"))["seg"][tgtc]
            where = np.isin(b, src)
            total += int(np.isin(a[where], tgt).sum())
            count += int(where.sum())
        return total, count

    _, srcc, tgtc, src, tgt = load_seg_info_from_exp_name("dome2spire")
    clean0 = np.stack([np.load(os.path.join(seg_dirs["church_clean"],
                                            f"{i}.npz"))["seg"]
                       for i in range(n // 2)])
    common = [int(np.bincount(clean0[:, c].ravel()).argmax())
              for c in range(clean0.shape[1])]
    correct = {}
    for label, args in (("dome2spire", (tgt, tgtc, src, srcc)),
                        ("most frequent", ([common[0]], 0, [common[2]], 2))):
        got = seg_correct_mod.compute_dl(seg_dirs["church_clean"],
                                         seg_dirs["dome2spire"],
                                         range(n // 2), *args)
        want = direct_count(*args)
        correct[label] = {"labels": [list(args[0]), args[1],
                                     list(args[2]), args[3]],
                          "total": got[0], "count": got[1]}
        if got != want:
            raise AssertionError(f"compute_dl {label} {got}, direct {want}")
    if correct["most frequent"]["count"] == 0:
        raise AssertionError("compute_dl counted no source pixel")
    print(f"seg_stats.process with netpqc: {n} clean PNGs "
          f"{seg_s['church_clean']:.3f} s ({n / seg_s['church_clean']:.2f} "
          f"images/s), {n // 2} edited {seg_s['dome2spire']:.3f} s (segmenter "
          f"and Inception loaded in {load_s:.3f} s); compute_dl equal to a "
          f"direct count: {correct}")

    # the staged chain at the fused pass's batch size, then the fused pass,
    # both with cuDNN's deterministic algorithms: its default ones vary run
    # to run on the H100, forward convolutions too (PERF.md §6), so two
    # passes over the same z agree bit for bit only within that scope
    staged = os.path.join(root, "staged")
    fused = os.path.join(root, "fused")
    with precision.deterministic():
        base = counters()
        sync(device)
        t1 = time.time()
        sample_clean(model, params, staged, n=n, batch_size=batch_size)
        seg_stats.process(seg, staged, os.path.join(staged, "seg"), n=n,
                          batch_size=batch_size)
        mu_s, sigma_s = fid.compute_feature_stats(
            fid._image_dir_batches(staged, batch_size, as_uint8=True), fe)
        staged_s = time.time() - t1
        staged_launches = launches_since(base)
        base = counters()
        sync(device)
        t1 = time.time()
        mu_f, sigma_f = run_fused(model, params, fused, segmodel=seg,
                                  feature_fn=fe, n=n, batch_size=batch_size,
                                  stats_path=os.path.join(fused, "fid.npz"))
        sync(device)
        fused_s = time.time() - t1
        fused_launches = launches_since(base)
    # the fused pass twice with the default algorithms: how far their run
    # to run variation takes the PNGs (printed, not held)
    loose = [os.path.join(root, f"fused_default_{k}") for k in (0, 1)]
    for out in loose:
        sync(device)
        t1 = time.time()
        run_fused(model, params, out, segmodel=seg, feature_fn=fe, n=n,
                  batch_size=batch_size)
        sync(device)
        default_s = time.time() - t1
    loose_lsb = [lsb_apart(np, *(read_image_rgb(os.path.join(out,
                                                             f"{i}.png"))
                                 for out in loose))
                 for i in range(n)]
    differ_png = [i for i in range(n)
                  if file_bytes(os.path.join(staged, f"{i}.png"))
                  != file_bytes(os.path.join(fused, f"{i}.png"))]
    labels = label_differences(seg, png_paths(staged)[:n],
                               os.path.join(staged, "seg"),
                               os.path.join(fused, "seg"), batch_size,
                               device)
    mu_err = float(np.abs(mu_f - mu_s).max() / np.abs(mu_s).max())
    sigma_err = float(np.abs(sigma_f - sigma_s).max()
                      / np.abs(sigma_s).max())
    print(f"run_fused {n} images at batch {batch_size} (netpqc, seeded "
          f"Inception; cuDNN's deterministic algorithms): {fused_s:.3f} s = "
          f"{n / fused_s:.2f} images/s, against the staged chain "
          f"{staged_s:.3f} s = {n / staged_s:.2f} images/s "
          f"({staged_s / fused_s:.2f}x); PNGs differing {differ_png}; labels "
          f"{labels}; mu {mu_err:.3e}, sigma {sigma_err:.3e} of their "
          f"largest (limit 1e-6); K2 launches fused {fused_launches['k2']}, "
          f"staged {staged_launches['k2']}; with the default algorithms "
          f"{default_s:.3f} s = {n / default_s:.2f} images/s, and two such "
          f"passes differ in {sum(v > 0 for v in loose_lsb)} images, by at "
          f"most {max(loose_lsb)} LSB")
    if differ_png or labels["sure_differ"] or not mu_err <= 1e-6 or \
            not sigma_err <= 1e-6:
        raise AssertionError(f"fused vs staged: PNGs {differ_png}, labels "
                             f"{labels}, mu {mu_err}, sigma {sigma_err}")
    if fused_launches["k2"] <= 0:
        raise AssertionError("the fused pass launched no K2")
    return {"load_s": load_s, "seg_s": seg_s, "correct": correct,
            "staged_s": staged_s, "fused_s": fused_s,
            "fused_default_s": default_s,
            "fused_default_lsb": max(loose_lsb),
            "fused_default_images_off": sum(v > 0 for v in loose_lsb),
            "fused_images_per_s": n / fused_s,
            "staged_images_per_s": n / staged_s, "labels": labels,
            "mu_err": mu_err, "sigma_err": sigma_err,
            "fused_launches": fused_launches,
            "staged_launches": staged_launches, "staged_dir": staged}


@contextlib.contextmanager
def environment(**values):
    """os.environ with `values` set, and the working directory `cwd` if
    given, within."""
    cwd = values.pop("cwd", None)
    old = {k: os.environ.get(k) for k in values}
    here = os.getcwd()
    os.environ.update(values)
    if cwd:
        os.chdir(cwd)
    try:
        yield
    finally:
        os.chdir(here)
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def check_experiments(workdir: str, weights: str, n: int = PIPELINE_N
                      ) -> dict:
    """Phase 31: ``experiments.run_pipeline`` with its default runner (each
    stage a child process of this interpreter) over the church chain of
    ``STAGES`` (``PIPELINE_STAGES``) with `n` images and a results directory
    (``sized_stages``), the checkpoint and seeded segmenters in `weights`;
    every stage must be done; then once more, which runs nothing.  The
    ratio the correct stage prints is recomputed from its files."""
    from rewriting_torch.metrics import experiments, seg_correct_mod
    from rewriting_torch.metrics.load_seg import load_seg_info_from_exp_name

    root = os.path.join(workdir, "experiments")
    results = os.path.join(root, "results")
    os.makedirs(root)
    stages = sized_stages([s for s in experiments.STAGES
                           if s[0] in PIPELINE_STAGES], n, results)
    names = {cmd: name for name, cmd, _ in stages}
    walls = {}

    def runner(cmd):
        """The default runner, timed."""
        t1 = time.time()
        try:
            return experiments.run_command(cmd)
        finally:
            walls[names[cmd]] = time.time() - t1

    sys.stdout.flush()
    t1 = time.time()
    with environment(REWRITING_TPU_WEIGHTS=weights,
                     REWRITING_TPU_MASKS=MASKS,
                     PYTHONPATH=os.pathsep.join(
                         [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]), cwd=root):
        status = experiments.run_pipeline(os.path.join(root, "state"),
                                          stages=stages, runner=runner)
        again = experiments.run_pipeline(os.path.join(root, "state"),
                                          stages=stages, runner=runner)
    wall = time.time() - t1
    _, srcc, tgtc, src, tgt = load_seg_info_from_exp_name("dome2spire")
    total, count = seg_correct_mod.compute_dl(
        os.path.join(results, "seg", "church_clean"),
        os.path.join(results, "seg", "dome2spire"), range(n), tgt, tgtc,
        src, srcc)
    print(f"experiments.run_pipeline, church chain at {n} images: "
          f"{wall:.3f} s; stages {status}; each stage's wall "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; dome2spire ratio {total}/{count}; a second run ran "
          f"{again}")
    if set(status) != set(PIPELINE_STAGES) or \
            any(v != "done" for v in status.values()) or again:
        raise AssertionError(f"run_pipeline {status}, then {again}")
    return {"wall_s": wall, "status": status, "stage_s": walls,
            "ratio": [total, count]}


def check_patch_fid_and_samples(model, params, edited_weight, clean_dir: str,
                                staged_dir: str, counters,
                                crops=PATCH_CROPS, n: int = PATCH_N,
                                batch_size: int = 16, device: str = "cuda"
                                ) -> dict:
    """Phase 32: ``patch_fid_sweep`` of a clean layer-8 rewriter against
    one holding `edited_weight` (phase 5's edit), crops `crops`, n images,
    the seeded Inception; ``samples.gt_stats`` and
    ``get_cropped_gt_samples`` with `clean_dir`'s PNGs as the real images
    (gt_stats within 1e-5 of the largest entry of
    ``compute_feature_stats`` of the same images); ``get_fake_samples``
    quantized equal to ``sample_clean``'s PNGs in `staged_dir` (batch
    `batch_size`, K1's gate off and cuDNN's deterministic algorithms in
    both)."""
    import numpy as np
    import torch

    from rewriting_torch.metrics import fid, patch_fid, samples
    from rewriting_torch.metrics.sample import quantize_uint8
    from rewriting_torch.native import read_image_rgb
    from rewriting_torch.ops import precision
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    fe = fid.FeatureExtractor(batch_size=batch_size, device=device)
    zds = z_dataset_for_model(model, n)
    clean = SeqStyleGanRewriter(model, params, zds, 8, device=device)
    edited = SeqStyleGanRewriter(model, params, zds, 8, device=device)
    edited.set_target_weight(edited_weight)
    base = counters()
    parts = {}
    t1 = time.time()
    with timed_methods(parts, device, (patch_fid, "sample_patches"),
                       (fid, "calculate_frechet_distance")):
        fids = patch_fid.patch_fid_sweep(clean, edited, list(crops), n=n,
                                         feature_fn=fe)
    sweep_s = time.time() - t1
    now = counters()
    sweep_launches = {k: now[k] - base[k] for k in now}
    if not all(np.isfinite(v) and v > 0 for v in fids.values()):
        raise AssertionError(f"patch FIDs {fids}")

    t1 = time.time()
    mu, sigma = samples.gt_stats(clean_dir, model.size, 64,
                                 batch_size=batch_size, feature_fn=fe)
    gt_s = time.time() - t1
    mu_d, sigma_d = fid.compute_feature_stats(
        fid._image_dir_batches(clean_dir, batch_size), fe)
    gt_err = max(float(np.abs(mu - mu_d).max() / np.abs(mu_d).max()),
                 float(np.abs(sigma - sigma_d).max()
                       / np.abs(sigma_d).max()))
    crops_gt = samples.get_cropped_gt_samples(clean_dir, model.size, 16,
                                              crop_sizes=crops)
    if [c.shape for c in crops_gt] != [(16, s, s, 3) for s in crops] or \
            not all(np.abs(c).max() <= 1.0 for c in crops_gt):
        raise AssertionError(f"gt crops {[c.shape for c in crops_gt]}")
    t1 = time.time()
    with precision.deterministic():     # as phase 30's staged PNGs were
        fake = samples.get_fake_samples(model, params, n,
                                        batch_size=batch_size)
    fake_s = time.time() - t1
    fake_u8 = quantize_uint8(torch.from_numpy(fake)).numpy()
    differ = [i for i in range(n) if not np.array_equal(
        fake_u8[i], read_image_rgb(os.path.join(staged_dir, f"{i}.png")))]
    print(f"patch_fid_sweep layer 8, crops {list(crops)}, {n} images: FIDs "
          f"{fids} in {sweep_s:.3f} s (the patches "
          f"{parts['sample_patches']:.3f} s, the Fréchet distances "
          f"{parts['calculate_frechet_distance']:.3f} s), launches "
          f"{sweep_launches}; gt_stats of 64 PNGs {gt_s:.3f} s, "
          f"{gt_err:.3e} of the largest from compute_feature_stats (limit "
          f"1e-5); get_fake_samples {n} in {fake_s:.3f} s, differing from "
          f"sample_clean's PNGs: {differ}")
    if gt_err > 1e-5 or differ:
        raise AssertionError(f"gt_stats {gt_err}, fake samples {differ}")
    if sweep_launches["k2"] <= 0:
        raise AssertionError("the patch FID sweep launched no K2")
    return {"fids": {str(k): v for k, v in fids.items()},
            "sweep_s": sweep_s, "parts_s": parts,
            "sweep_launches": sweep_launches, "gt_stats_s": gt_s,
            "gt_err": gt_err, "fake_s": fake_s}


def run_slice10(model, params, edited_weight, clean_dir: str,
                edited_dir: str, workdir: str, weights: str, counts,
                which=("29", "30", "31", "32"), device: str = "cuda"):
    """Phases 29-32 inside ``weights_env(weights)`` (the seeded slice-9
    weights with ``stylegan2_church.pt`` beside them): each phase's
    numbers printed as a JSON line and its seconds; returns ({phase name:
    numbers}, {phase name: its launches by `counts()`}).  Phase 32 needs
    phase 30's staged PNGs, so it runs 30 too."""
    from rewriting_torch.models.zoo import load_seq_stylegan
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    results, launches = {}, {}

    def since(base):
        now = counts()
        return {k: now[k] - base[k] for k in now}

    def run(label, name, fn):
        t0 = time.time()
        base = counts()
        results[name] = fn()
        launches[name] = since(base)
        print(json.dumps({name: results[name]}))
        phase(label, t0)

    def server_and_ui():
        t1 = time.time()
        smodel, sparams = load_seq_stylegan("church", truncation=0.5,
                                            device=device)
        gw = SeqStyleGanRewriter(smodel, sparams,
                                 z_dataset_for_model(smodel, 1000), 8,
                                 device=device)
        sync(device)
        print(f"the server's rewriter: checkpoint and layer-8 statistics "
              f"over 1000 z in {time.time() - t1:.3f} s")
        out = check_server(gw, workdir, counts)
        out["cli"] = check_serve_command_line(gw, workdir, weights)
        out["ui"] = check_ui(gw, counts)
        return out

    with weights_env(weights):
        if "29" in which:
            run("29 server and UI", "server", server_and_ui)
        if "30" in which or "32" in which:
            run("30 staged and fused metrics", "pipelines",
                lambda: check_metric_pipelines(model, params, clean_dir,
                                               edited_dir, workdir, counts,
                                               device=device))
        if "31" in which:
            run("31 experiment DAG", "experiments",
                lambda: check_experiments(workdir, weights))
        if "32" in which:
            run("32 patch FID and samples", "patch_fid",
                lambda: check_patch_fid_and_samples(
                    model, params, edited_weight, clean_dir,
                    results["pipelines"]["staged_dir"], counts,
                    device=device))
    return results, launches


def sized_stages(stages, n: int, results: str):
    """The experiment DAG's stages with `n` images and a results
    directory: ``--num`` for the two metrics that count images so,
    ``--n`` for the rest."""
    out = []
    for name, cmd, deps in stages:
        count = "--num" if any(m in cmd for m in ("seg_correct_mod",
                                                  "distances")) else "--n"
        out.append((name, f"{cmd} {count} {n} --results {results}", deps))
    return out


def run_edit_loop(model, params, niter: int, layernum: int = 8,
                  nrender: int = 8) -> dict:
    """The paper's edit loop through the port's entry points: statistics
    at `layernum`, the dome2tree request (rank 1, `niter` Adam steps,
    timed by the solve itself), `nrender` edited renders, revert, renders
    again.  Checks the loss fell, every step reached the callback, the
    weight change lies in span(D) and every output is finite.  Returns
    (the numbers and, under "edited_weight", the edited weight; the
    reverted rewriter)."""
    import torch

    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.rewrite.solve import projected_conv
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    with open(MASK) as f:
        request = json.load(f)
    t1 = time.time()
    rw = SeqStyleGanRewriter(model, params, z_dataset_for_model(model, 1000),
                             layernum=layernum, key_method="zca",
                             device=model.device)
    sync()
    stats_s = time.time() - t1
    w0 = rw.target_weight().clone()
    t1 = time.time()
    seen = []
    losses, solve_ms = rw.apply_edit(
        request, rank=1, niter=niter, piter=10, lr=0.05, return_timing=True,
        update_callback=lambda i, l: seen.append(i))
    sync()
    solve_s = time.time() - t1
    zs = rw.zds.zs[:nrender]
    t1 = time.time()
    edited = rw.sample_image_from_latent(zs)
    sync()
    render_s = time.time() - t1
    w1 = rw.target_weight().clone()
    rw.revert()
    reverted = rw.sample_image_from_latent(zs)
    sync()

    direction = rw.multi_key_from_selection(request["key"], rank=1)
    delta = w1 - w0
    outside = float((delta - projected_conv(delta, direction)).norm())
    span_rel = outside / float(delta.norm())
    change = float((edited - reverted).abs().mean())
    print(f"layer {layernum} statistics (probe + 1000-z second moment + "
          f"ZCA): {stats_s:.3f} s")
    print(f"layer {layernum} edit (keys, goal, {len(losses)}-step solve): "
          f"{solve_s:.3f} s, of it the solve {solve_ms / 1e3:.3f} s; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    print(f"render {nrender} samples: {render_s:.3f} s; mean |edited - "
          f"reverted| = {change:.6f}")
    print(f"weight change outside span(D): {span_rel:.3e} of its norm "
          f"(limit {SPAN_TOL})")
    if not losses[-1] < losses[0]:
        raise AssertionError("the solve did not lower the loss")
    if seen != list(range(niter)):
        raise AssertionError(f"update_callback saw {len(seen)} steps")
    if not span_rel <= SPAN_TOL:
        raise AssertionError(f"weight change leaves span(D): {span_rel}")
    for name, t in (("losses", torch.as_tensor(losses)), ("weight", w1),
                    ("edited", edited), ("reverted", reverted)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} not finite")
    size = model.size
    if tuple(edited.shape) != (nrender, size, size, 3) or not change > 0:
        raise AssertionError(f"edited renders {tuple(edited.shape)} did not "
                             f"change (mean change {change})")
    return {"layer": layernum, "stats_s": stats_s, "solve_s": solve_s,
            "solve_ms": solve_ms, "steps": niter, "render_s": render_s,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "span_rel": span_rel, "edited_weight": w1}, rw


def check_sampling(model, params, outdir: str, n: int, batch_size: int,
                   imgnum: int = 3, counts=None) -> dict:
    """``sample_clean`` of n images into outdir; image `imgnum`, decoded by
    the port's own PNG decoder, must be within 1 LSB of a direct render of
    its z.  Returns the wall time, images/s and, read right after
    ``sample_clean``, what `counts()` returns (the launch counts)."""
    import numpy as np
    import torch

    from rewriting_torch.metrics.sample import per_image_z, sample_clean
    from rewriting_torch.utils.renormalize import decode_png, renormalize

    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.time()
    sample_clean(model, params, outdir, n=n, batch_size=batch_size)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t1
    launches = counts() if counts is not None else {}
    names = sorted(os.listdir(outdir))
    if len(names) != n + 1 or "+lightbox.html" not in names:
        raise AssertionError(f"sample_clean wrote {len(names)} files")
    with open(os.path.join(outdir, f"{imgnum}.png"), "rb") as f:
        img = decode_png(f.read())
    direct = renormalize(np.clip(model(params, per_image_z(
        model, [imgnum]))[0].cpu().numpy(), -1, 1), "zc", "byte")
    lsb = int(np.abs(img.astype(np.int16) - direct.astype(np.int16)).max())
    if img.shape != direct.shape or lsb > 1:
        raise AssertionError(f"image {imgnum}: {img.shape} vs direct "
                             f"{direct.shape}, {lsb} LSB apart")
    return {"wall_s": wall, "images_per_s": n / wall, "lsb": lsb,
            **launches}


# ---------------------------------------------------------------------------
# Phase 33: the multi-device paths, in child jobs on the card
# ---------------------------------------------------------------------------

# (ranks, backend, checks, the data-axis sizes of the dp x sp meshes) of
# phase 33's jobs: one rank on NCCL, then ranks sharing the card over gloo
# (NCCL refuses two ranks on one GPU)
MESH_JOBS = ((1, "nccl", ("sample", "moment", "edits", "tp", "gpipe"), ()),
             (2, "gloo", ("dp", "moment", "edits", "tp", "sp", "gpipe"),
              (1,)),
             (4, "gloo", ("dp", "moment", "tp", "sp", "gpipe"), (2, 1)))
MESH_BATCH = 16         # dp and GPipe; tp takes 2 of it, dp x sp 4
MOMENT_RTOL = 1e-5      # sharded key moment vs phase 5's, of its max
LATENT_RTOL = 1e-5      # GPipe style MLP vs the seq stages, of max |w|
MESH_JOB_TIMEOUT = 600


def noisy_params(params) -> dict:
    """`params` with noise strengths 0.1 .. 0.5 (seeded weights have 0),
    so that each image shows the noise rows it read."""
    import torch
    out = dict(params)
    for i, name in enumerate(sorted(n for n in params
                                    if n.endswith(".noise"))):
        out[name] = {"weight": torch.full_like(params[name]["weight"],
                                               0.1 * (1 + i % 5))}
    return out


def moment_cache(rw) -> dict:
    """`rw`'s key moment as its ``r2m.npz`` cache holds it (the state and
    the key arguments), for a rewriter built in another process on the
    same z to read the same moment."""
    import torch
    rows = len(rw.zds) * rw.k_shape[1] * rw.k_shape[2]
    return {"state": {"count": torch.tensor(float(rows)),
                      "mom": rw.c_matrix.detach().cpu()},
            "args": {"sample_size": len(rw.zds), "layer": rw.firstlayer}}


def _rel(got, want) -> float:
    got, want = got.float(), want.to(got.device).float()
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    return float((got - want).abs().max() / want.abs().max())


def mesh_job(spec: dict) -> dict:
    """One rank of a phase-33 job (every rank runs it): the checks named in
    ``spec["checks"]``, each with the launch counts set to 0 just before it
    and read just after, each held against its single-device result from
    the parent's earlier phases.  Raises on any check that fails; returns
    {check: its numbers}."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rewriting_torch.metrics.sample import sample_clean
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier
    from rewriting_torch.parallel import (comm, make_mesh, make_mesh_2d,
                                          pipelined_style_mapper,
                                          sharded_sampler,
                                          spatial_sharded_sampler,
                                          tensor_shard_params,
                                          tensor_sharded_sampler)
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.rewrite.multi import batch_apply_edits
    from rewriting_torch.utils.renormalize import decode_png
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    apply_parity_tier()
    device = comm.default_device()
    world = dist.get_world_size()
    model = SeqStyleGAN2(**spec["model"], device=device)
    params = model.init_params(seed=0)
    noisy = noisy_params(params)
    z = spec["z"]
    mesh = make_mesh()
    data = mesh.group("data")
    out = {}

    def counts():
        return {"k1": kup.launches, "k2": kblur.launches,
                "k2_backward": kblur.backward_launches,
                "k2_general": kblur.general_launches,
                "k3": kup2.launches + kup2.general_launches,
                "built": comm.built}

    def run(name, fn):
        kup.launches = kblur.launches = kblur.backward_launches = 0
        kblur.general_launches = kup2.launches = kup2.general_launches = 0
        comm.built = 0
        sync(device)
        t1 = time.time()
        numbers = fn()
        sync(device)
        out[name] = {"s": time.time() - t1, **numbers, **counts()}

    def sample():
        outdir = os.path.join(spec["workdir"], f"mesh_sample_{world}")
        kup.set_fused_upconv("on", min_res=0)    # as phase 9's kept PNGs
        try:
            sample_clean(model, params, outdir, n=64, batch_size=16,
                         mesh=mesh)
        finally:
            kup.set_fused_upconv("off", min_res=256)
        names = sorted(os.listdir(outdir))
        if names != sorted(os.listdir(spec["clean_dir"])):
            raise AssertionError(f"sample_clean(mesh) wrote {len(names)} "
                                 "files, not phase 9's")
        lsb = 0
        for name in names:
            if not name.endswith(".png"):
                continue
            with open(os.path.join(outdir, name), "rb") as f:
                a = decode_png(f.read()).astype(np.int16)
            with open(os.path.join(spec["clean_dir"], name), "rb") as f:
                b = decode_png(f.read()).astype(np.int16)
            lsb = max(lsb, int(np.abs(a - b).max()))
        if lsb > 1:
            raise AssertionError(f"sample_clean(mesh) PNGs {lsb} LSB from "
                                 "phase 9's")
        return {"images": 64, "lsb": lsb}

    def dp():
        imgs = comm.all_gather(sharded_sampler(model, mesh)(noisy, z), data)
        return {"rel": _rel(imgs, spec["ref_images"])}

    def moment():
        rw = SeqStyleGanRewriter(model, params,
                                 z_dataset_for_model(model, 1000), 8,
                                 mesh=mesh, device=device)
        return {"rel": _rel(rw.c_matrix, spec["c8"])}

    def edits():
        # phase 16's statistics, read from the cache the parent wrote: the
        # check is the edits split over the ranks (the moment check holds
        # the sharded statistics), and two rewriters built apart round
        # their statistics apart, which L1 and Adam amplify (6.8e-5 in the
        # final losses at one rank on an H100)
        t1 = time.time()
        rw = SeqStyleGanRewriter(model, params,
                                 z_dataset_for_model(model, 1000), 7,
                                 cachedir=spec["cache7"], mesh=mesh,
                                 device=device)
        sync(device)
        stats_s = time.time() - t1
        requests = []
        for name in BATCH_REQUESTS:
            with open(os.path.join(MASKS, "church", f"{name}.json")) as f:
                requests.append(json.load(f))
        weights, losses, solve_ms = batch_apply_edits(
            rw, requests, niter=spec["steps"], mesh=mesh,
            return_timing=True)
        gap = float(np.abs(np.asarray(losses)
                           - np.asarray(spec["losses16"])).max())
        if len(weights) != len(requests) or not gap <= BATCH_LOSS_TOL:
            raise AssertionError(f"{len(weights)} edits, final losses "
                                 f"{gap} from phase 16's")
        return {"stats_s": stats_s, "solve_ms": solve_ms, "loss_gap": gap,
                "final_losses": [float(v) for v in losses]}

    def tp(gate):
        mt = make_mesh(axis="model")
        local = tensor_shard_params(model, noisy, mt, axis="model")
        held = sum(local[n]["weight"].numel() for n in local
                   if n.endswith(".mconv.dconv"))
        full = sum(params[n]["weight"].numel() for n in params
                   if n.endswith(".mconv.dconv"))
        if gate:
            kup.set_fused_upconv("on", min_res=0)
        try:
            imgs = tensor_sharded_sampler(model, mt)(local, z[:2])
        finally:
            kup.set_fused_upconv("off", min_res=256)
        return {"rel": _rel(imgs, spec["ref_images"][:2]),
                "dconv_share": held / full}

    def sp(n_data):
        m2 = make_mesh_2d(n_data, world // n_data)
        block = spatial_sharded_sampler(model, m2)(noisy, z[:4])
        imgs = comm.all_gather(comm.all_gather(block, m2.group("spatial"),
                                               dim=1), m2.group("data"))
        return {"rel": _rel(imgs, spec["ref_images"][:4]),
                "block": list(block.shape)}

    def gpipe():
        w = pipelined_style_mapper(model, make_mesh(axis="stage"))(params, z)
        rel = _rel(w, spec["ref_w"])
        if not rel <= LATENT_RTOL:
            raise AssertionError(f"GPipe style MLP {rel} from the seq "
                                 "stages")
        return {"rel": rel}

    for check in spec["checks"]:
        if check == "sample":
            run("sample", sample)
        elif check == "dp":
            run("dp", dp)
        elif check == "moment":
            run("moment", moment)
        elif check == "edits":
            run("edits", edits)
        elif check == "tp":
            run("tp", lambda: tp(False))
            run("tp_k1", lambda: tp(True))
        elif check == "sp":
            for n_data in spec["sp_data"]:
                run(f"sp_{n_data}x{world // n_data}", lambda: sp(n_data))
        elif check == "gpipe":
            run("gpipe", gpipe)
    for name, numbers in out.items():
        tol = MOMENT_RTOL if name == "moment" else FORWARD_RTOL
        if "rel" in numbers and not numbers["rel"] <= tol:
            raise AssertionError(f"{name}: {numbers['rel']} of max from "
                                 f"the single-device result (limit {tol})")
    return out


def check_multi_device(model, params, clean_dir: str, c8, r2m7, losses16,
                       workdir: str, jobs=MESH_JOBS, steps: int = 2001
                       ) -> dict:
    """Phase 33: the multi-device paths in child jobs of `jobs` (ranks,
    backend, checks, dp x sp data sizes), each rank one process on the
    model's card (:func:`mesh_job`), against single-device results: phase
    9's PNGs (`clean_dir`), phase 5's key moment `c8`, phase 16's final
    losses `losses16` (the edits on phase 16's layer-7 statistics, written
    from `r2m7`, :func:`moment_cache`, as the rewriter's cache), and the
    renders and style latents of `params` at ``MESH_BATCH`` z computed
    here.  On the card every sharded path must
    launch K2 (K1 with its gate on), no path K3 or the general K2, and the
    NCCL job build no collective from an all-reduce.  Prints each rank's
    numbers (its times are ranks sharing one card, not a scaling figure);
    returns them by job."""
    import torch

    from rewriting_torch.parallel import comm
    from rewriting_torch.stats import tally
    from rewriting_torch.stats.running import RunningSecondMoment
    from rewriting_torch.utils.zdataset import standard_z_sample

    cache7 = os.path.join(workdir, "r2m_layer7")
    tally.save_cached_state(os.path.join(cache7, "r2m.npz"),
                            RunningSecondMoment(r2m7["state"]),
                            r2m7["args"])
    z = standard_z_sample(MESH_BATCH, model.z_dim, seed=2)
    with torch.no_grad():
        ref_images = model(noisy_params(params), z).cpu()
        ref_w = model.pipeline.subsequence(upto_layer="latents")(
            params, model.make_bag(z))["latent"].cpu()
    device = model.device
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device()
                              if device.index is None else device.index)
    spec = {"model": {"size": model.size, "style_dim": model.style_dim,
                      "n_mlp": model.n_mlp},
            "z": z, "ref_images": ref_images, "ref_w": ref_w,
            "c8": c8.detach().cpu(), "losses16": list(losses16),
            "clean_dir": clean_dir, "workdir": workdir, "steps": steps,
            "cache7": cache7}
    results = {}
    for ranks, backend, checks, sp_data in jobs:
        t1 = time.time()
        # NCCL takes one rank a GPU (rank r on cuda:r); gloo ranks share
        outs = comm.spawn(mesh_job, ranks,
                          device=None if backend == "nccl" and ranks > 1
                          else str(device),
                          backend=backend, timeout_s=MESH_JOB_TIMEOUT,
                          args=({**spec, "checks": checks,
                                 "sp_data": sp_data},))
        job = f"{ranks}_{backend}"
        results[job] = {"s": time.time() - t1, "ranks": outs}
        for rank, out in enumerate(outs):
            for name, n in out.items():
                print(f"phase 33, {ranks} rank(s) on {backend}, rank {rank},"
                      f" {name}: {n['s']:.3f} s; " + ", ".join(
                          f"{k} {v:.3e}" if isinstance(v, float) else
                          f"{k} {v}" for k, v in n.items() if k != "s"))
        print(f"phase 33, {ranks} rank(s) on {backend}: {results[job]['s']:.3f}"
              " s with the processes' start (ranks sharing one card)")
        if device.type != "cuda":
            continue
        for rank, out in enumerate(outs):
            for name, n in out.items():
                if n["k3"] or n["k2_general"]:
                    raise AssertionError(f"{job} rank {rank} {name} launched "
                                         "K3 or the general K2")
                if name in ("dp", "moment", "edits", "tp") or \
                        name.startswith("sp_"):
                    if n["k2"] <= 0:
                        raise AssertionError(f"{job} rank {rank} {name} never"
                                             " launched K2")
                if name in ("sample", "tp_k1") and n["k1"] <= 0:
                    raise AssertionError(f"{job} rank {rank} {name} never "
                                         "launched K1")
                if name == "edits" and n["k2_backward"] <= 0:
                    raise AssertionError(f"{job} rank {rank} edits never "
                                         "launched K2's backward")
                if backend == "nccl" and n["built"]:
                    raise AssertionError(f"{job} built {n['built']} "
                                         "collectives from all-reduces")
    return results


# phases 34-36: the 1024 models and the segmenters no caller sets
FACES_BATCH = 8
# (B, I, H, W, O) of K1's one-pass mode: phase 34's two launches under
# "default" from 256 px, the timed (16,256,128,128)->128, a small map and
# a ragged one
BF16_UPCONV_SHAPES = ((8, 256, 128, 128, 128), (8, 128, 256, 256, 64),
                      (16, 512, 8, 8, 512), (3, 72, 9, 30, 40),
                      (16, 256, 128, 128, 128))
BF16_FLOPS_PER_S = 989e12
BF16_UPCONV_RTOL = 1e-4    # K1 one-pass vs its plain version, of max |plain|
# PSNR floors against "highest" of the faces-1024 and celebhq-1024 renders
# (peak: the "highest" render's range), stated before the first chip run
PSNR_FLOORS = {"recommended": 30.0, "int8": 20.0, "k1_default": 30.0,
               "proggan_mixed": 30.0}
SUSPEND_MASK = os.path.join(MASKS, "faces", "effective-smile-3.json")
SUSPEND_LAYER = 6       # the 512-channel 16x16 conv of faces-1024
SUSPEND_NZ = 160        # the mask's images are numbered up to 136
SEG_ARCHS = (("resnet50dilated", "ppm_deepsup"), ("resnet101dilated", "c1"),
             ("resnet101", "ppm"), ("mobilenetv2dilated", "c1_deepsup"),
             ("resnext101", "ppm_deepsup"), ("resnet18dilated", "c1"))


def upconv_bf16_bound_ms(b, i, h, o, w=None):
    """K1's least time in its one-pass bf16 mode: 2 * MACs at the bf16
    dense peak, plus the blur and epilogue at the fp32 peak; or the
    bytes (fp32 in and out), whichever is larger."""
    nbytes, macs, outputs = _upconv_counts(b, i, h, o, w)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (2.0 * macs / BF16_FLOPS_PER_S
              + (2.0 * 8 + 5) * outputs / FP32_FLOPS_PER_S) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def psnr(out, ref) -> float:
    """PSNR of `out` against `ref` in dB, the peak the range of `ref`."""
    import math
    mse = float(((out - ref) ** 2).mean())
    peak = float(ref.max() - ref.min())
    return 10.0 * math.log10(peak * peak / max(mse, 1e-30))


def images_per_s(torch, fn, batch: int, runs: int = 3) -> float:
    """Images a second of `fn` (one batch), the median of `runs` timed
    calls after one warm-up, the host clock around work that ends in a
    synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t1 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t1)
    return batch / sorted(times)[len(times) // 2]


def check_upconv_bf16(torch, gen) -> dict:
    """K1's one-pass bf16 kernel (``csrc/upconv_blur_bf16.cu``) against its
    plain version (x and the taps rounded to bf16, the rest fp32) at
    ``BF16_UPCONV_SHAPES``, with and without the epilogue; two launches
    bit for bit; times of the kernel, its plain version, the 3xTF32 kernel
    and the library ``conv_transpose2d`` in bf16 (the 6x6 composite
    kernel) at each, beside the bound; the tiles and the build's ptxas
    line."""
    from rewriting_torch import _native_build as _build
    from rewriting_torch.ops import upconv_blur as kup

    ptxas = [line.strip() for line in
             _build.build_logs.get("upconv_blur_bf16", "").splitlines()
             if "registers" in line or "spill" in line or "wgmma" in line]
    for line in ptxas:
        print("K1 one-pass ptxas -v:", line)
    kf = tuple(float(v) for v in (0.25, 0.75, 0.75, 0.25))
    rows, max_err, max_rel = [], 0.0, 0.0
    for b, i, h, w, o in BF16_UPCONV_SHAPES:
        x = torch.randn((b, i, h, w), generator=gen, device="cuda")
        wf = torch.randn((o, i, 3, 3), generator=gen,
                         device="cuda") / (3.0 * i ** 0.5)
        epi = (torch.rand((b, o), generator=gen, device="cuda") + 0.5,
               torch.randn((1, 1, 2 * h, 2 * w), generator=gen,
                           device="cuda"),
               torch.randn((o,), generator=gen, device="cuda"))
        tile = kup._plan_bf16(b, i, h, w, o)
        for label, extra in (("no epilogue", ()), ("epilogue", epi)):
            got = kup.upconv_blur_cuda(x, wf, kf, *extra, tier="default")
            again = kup.upconv_blur_cuda(x, wf, kf, *extra, tier="default")
            want = kup.upconv_blur_reference(x, wf, kf, *extra,
                                             tier="default")
            exact = kup.upconv_blur_reference(x, wf, kf, *extra)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            rounding = rel_diff(want, exact)
            same = bool(torch.equal(got, again))
            max_err, max_rel = max(max_err, err), max(max_rel, rel)
            print(f"upconv_blur one-pass bf16 {(b, i, h, w)} -> {o} {label}:"
                  f" max abs diff {err:.3e}, {rel:.3e} of max |plain| "
                  f"(limit {BF16_UPCONV_RTOL}); two launches bit for bit: "
                  f"{same}; the plain bf16 version is {rounding:.3e} from "
                  f"fp32; tile {tuple(tile)}")
            if tuple(got.shape) != (b, o, 2 * h, 2 * w) or \
                    not rel <= BF16_UPCONV_RTOL:
                raise AssertionError(f"K1's bf16 kernel differs from its "
                                     f"plain version by {rel}")
            if not same:
                raise AssertionError("two launches of K1's bf16 kernel "
                                     "differ")
            del got, again, want, exact
        w6 = library_up_kernel(torch, wf, kf).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        ms = time_ms(torch, lambda: kup.upconv_blur_cuda(
            x, wf, kf, *epi, tier="default"))
        plain_ms = time_ms(torch, lambda: kup.upconv_blur_reference(
            x, wf, kf, *epi, tier="default"))
        tf32_ms = time_ms(torch, lambda: kup.upconv_blur_cuda(x, wf, kf,
                                                              *epi))
        library_ms = time_ms(torch, lambda: library_upconv(torch, xb, w6))
        bound, by = upconv_bf16_bound_ms(b, i, h, o, w)
        rows.append({"shape": [b, i, h, w, o], "ms": ms,
                     "plain_ms": plain_ms, "tf32_ms": tf32_ms,
                     "library_ms": library_ms, "bound_ms": bound,
                     "bound_by": by, "tile": list(tile)})
        print(f"upconv_blur one-pass bf16 time {(b, i, h, w)} -> {o}: "
              f"{ms:.4f} ms ({ms / bound:.2f}x its bound {bound:.4f} ms, "
              f"{by}), plain {plain_ms:.4f} ms, 3xTF32 kernel {tf32_ms:.4f} "
              f"ms, library conv_transpose2d 6x6 bf16 {library_ms:.4f} ms")
        del x, wf, epi, w6, xb
    return {"rows": rows, "max_abs_err": max_err, "max_rel_err": max_rel,
            "ptxas": ptxas}


def check_faces(model, params, counters, batch: int = FACES_BATCH) -> dict:
    """Phase 34, faces-1024 (`model`, `params` from the zoo): at `batch`,
    ``pipeline_fast`` with its s2d tail and ``fused=True`` against the seq
    pipeline; K1 on at every layer (3xTF32) against it too; the
    recommended schedule, an int8 schedule and a "default" schedule from
    256 px with K1 on (its one-pass mode) against "highest", PSNR beside
    its floor; images/s of each; the two forms of the 3-channel 512 ->
    1024 skip upsample.  `counters()` gives the kernels' launches; each
    run's launches are returned."""
    import torch

    from rewriting_torch.models.stylegan2 import (
        mixed_precision_schedule, recommended_precision_schedule)
    from rewriting_torch.ops import make_kernel
    from rewriting_torch.ops import precision
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops.upfirdn2d import (separable_taps, upsample2d,
                                               upfirdn2d_matmul)
    from rewriting_torch.utils.zdataset import standard_z_sample

    z = standard_z_sample(batch, model.z_dim, seed=1)
    noise = model.prepare_noise(batch)
    out = {"batch": batch, "launches": {}, "images_per_s": {},
           "psnr": {}}

    def run(name, fn):
        base = counters()
        y = fn()
        torch.cuda.synchronize()
        now = counters()
        out["launches"][name] = {k: now[k] - base[k] for k in now}
        return y

    seq = run("seq", lambda: model(params, z, noise, fast=False))
    if tuple(seq.shape) != (batch, 1024, 1024, 3) or \
            not bool(torch.isfinite(seq).all()):
        raise AssertionError(f"faces-1024 seq render {tuple(seq.shape)}")
    fast = run("fast", lambda: model(params, z, noise))
    fused = run("fused", lambda: model(params, z, noise, fused=True))
    kup.set_fused_upconv("on", min_res=0)
    try:
        k1 = run("fast_k1", lambda: model(params, z, noise))
    finally:
        kup.set_fused_upconv("off", min_res=256)
    errs = {"fast": rel_diff(fast, seq), "fused": rel_diff(fused, seq),
            "fast_k1": rel_diff(k1, seq)}
    out["rel_err"] = errs
    print(f"faces-1024 batch {batch}: max diff / max |seq| of pipeline_fast "
          f"(s2d tail) {errs['fast']:.3e}, fused=True {errs['fused']:.3e}, "
          f"pipeline_fast with K1 on {errs['fast_k1']:.3e} (limit "
          f"{FORWARD_RTOL})")
    if not max(errs.values()) <= FORWARD_RTOL:
        raise AssertionError(f"faces-1024 pipelines differ: {errs}")
    if out["launches"]["fast_k1"]["k1"] <= 0 or \
            out["launches"]["fused"]["k2"] <= 0:
        raise AssertionError(f"faces-1024 launches {out['launches']}")
    del fused, k1

    schedules = {
        "recommended": (recommended_precision_schedule(model), False),
        "int8": (mixed_precision_schedule(512, tier="int8"), False),
        "k1_default": (mixed_precision_schedule(256), True)}
    renders = {}
    for name, (schedule, k1_on) in schedules.items():
        precision.set_precision_schedule(schedule)
        if k1_on:
            kup.set_fused_upconv("on", min_res=0)
        try:
            renders[name] = run(name, lambda: model(params, z, noise))
            out["images_per_s"][name] = images_per_s(
                torch, lambda: model(params, z, noise), batch)
        finally:
            precision.set_precision_schedule(None)
            kup.set_fused_upconv("off", min_res=256)
        out["psnr"][name] = psnr(renders[name], fast)
    out["images_per_s"]["highest"] = images_per_s(
        torch, lambda: model(params, z, noise), batch)
    kup.set_fused_upconv("on", min_res=0)
    try:
        out["images_per_s"]["highest_k1"] = images_per_s(
            torch, lambda: model(params, z, noise), batch)
    finally:
        kup.set_fused_upconv("off", min_res=256)
    print(f"faces-1024 PSNR against 'highest' (dB): "
          + ", ".join(f"{k} {v:.2f} (floor {PSNR_FLOORS[k]})"
                      for k, v in out["psnr"].items()))
    print(f"faces-1024 images/s at batch {batch}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      out["images_per_s"].items()))
    low = {k: v for k, v in out["psnr"].items() if not v >= PSNR_FLOORS[k]}
    if low:
        raise AssertionError(f"faces-1024 schedules below their floors: "
                             f"{low}")
    if out["launches"]["k1_default"]["k1_bf16"] <= 0:
        raise AssertionError("the 'default' stages never launched K1's "
                             "one-pass mode")
    del renders, seq, fast

    # the RGB skip: 3 channels, 512 -> 1024
    rgb = torch.randn((batch, 3, 512, 512), device="cuda")
    kern = make_kernel([1, 3, 3, 1])
    taps = separable_taps([1, 3, 3, 1])
    a = upsample2d(rgb, kern)
    b = upfirdn2d_matmul(rgb, taps, taps, up=2, pad=(2, 1), gain=4.0)
    skip_err = rel_diff(b, a)
    out["skip_upsample"] = {
        "shape": list(rgb.shape), "max_rel_diff": skip_err,
        "upsample2d_ms": time_ms(torch, lambda: upsample2d(rgb, kern)),
        "upfirdn2d_matmul_ms": time_ms(torch, lambda: upfirdn2d_matmul(
            rgb, taps, taps, up=2, pad=(2, 1), gain=4.0))}
    print(f"RGB skip upsample {tuple(rgb.shape)} -> 1024: upsample2d "
          f"(depthwise conv) {out['skip_upsample']['upsample2d_ms']:.4f} "
          f"ms, upfirdn2d_matmul "
          f"{out['skip_upsample']['upfirdn2d_matmul_ms']:.4f} ms; "
          f"{skip_err:.3e} apart")
    if not skip_err <= FORWARD_RTOL:
        raise AssertionError(f"the skip upsample's two forms differ by "
                             f"{skip_err}")
    return out


def check_schedule_suspension(model, params, niter: int = 201) -> dict:
    """An edit's solve on faces-1024 with no schedule and with every stage
    scheduled "int8": the losses and the edited weight bit for bit equal
    (the statistics, goals and solve suspend the schedule)."""
    import numpy as np
    import torch

    from rewriting_torch.models.stylegan2 import mixed_precision_schedule
    from rewriting_torch.ops import precision
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.utils.zdataset import z_dataset_for_model

    with open(SUSPEND_MASK) as f:
        request = json.load(f)
    rw = SeqStyleGanRewriter(model, params,
                             z_dataset_for_model(model, SUSPEND_NZ),
                             layernum=SUSPEND_LAYER, device=model.device)
    runs = []
    for schedule in (None, mixed_precision_schedule(4, tier="int8",
                                                    keep_rgb=False)):
        precision.set_precision_schedule(schedule)
        try:
            rw.revert()
            losses = rw.apply_edit(request, rank=1, niter=niter)
            runs.append((np.asarray(losses), rw.target_weight().clone()))
        finally:
            precision.set_precision_schedule(None)
    rw.revert()
    same = bool(np.array_equal(runs[0][0], runs[1][0])
                and torch.equal(runs[0][1], runs[1][1]))
    print(f"faces-1024 layer {SUSPEND_LAYER} edit ({niter} steps) with and "
          f"without an int8 schedule on every stage: bit for bit equal "
          f"{same}; loss {runs[0][0][0]:.6f} -> {runs[0][0][-1]:.6f}")
    if not same:
        raise AssertionError("an installed schedule changed an edit")
    return {"layer": SUSPEND_LAYER, "steps": niter, "bit_for_bit": same,
            "loss_last": float(runs[0][0][-1])}


def check_proggan_celebhq(model, params, batch: int = FACES_BATCH) -> dict:
    """Phase 35, ProgGAN celebhq-1024: ``pipeline_fast`` (the s2d tail)
    against ``pipeline``; its recommended mixed schedule against
    "highest", PSNR beside its floor; images/s of each."""
    import torch

    from rewriting_torch.models.proggan import recommended_precision_schedule
    from rewriting_torch.ops import precision
    from rewriting_torch.utils.zdataset import standard_z_sample

    if not model._fast_overrides:
        raise AssertionError("celebhq-1024 has no s2d tail")
    z = standard_z_sample(batch, model.z_dim, seed=1)
    seq = model(params, z, fast=False)
    fast = model(params, z)
    err = rel_diff(fast, seq)
    precision.set_precision_schedule(recommended_precision_schedule(model))
    try:
        mixed = model(params, z)
        mixed_ips = images_per_s(torch, lambda: model(params, z), batch)
    finally:
        precision.set_precision_schedule(None)
    out = {"batch": batch, "rel_err": err,
           "psnr": {"proggan_mixed": psnr(mixed, fast)},
           "images_per_s": {
               "seq": images_per_s(torch, lambda: model(params, z,
                                                        fast=False), batch),
               "fast": images_per_s(torch, lambda: model(params, z), batch),
               "mixed": mixed_ips}}
    print(f"celebhq-1024 batch {batch}: pipeline_fast (s2d tail) vs "
          f"pipeline {err:.3e} of max (limit {FORWARD_RTOL}); mixed "
          f"schedule PSNR {out['psnr']['proggan_mixed']:.2f} dB (floor "
          f"{PSNR_FLOORS['proggan_mixed']}); images/s "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["images_per_s"].items()))
    if tuple(fast.shape) != (batch, 1024, 1024, 3) or \
            not err <= FORWARD_RTOL or \
            not out["psnr"]["proggan_mixed"] >= PSNR_FLOORS["proggan_mixed"]:
        raise AssertionError(f"celebhq-1024: {out}")
    return out


def check_semantic_archs(clean_dir: str, n: int = 2) -> dict:
    """Phase 36: each encoder and decoder of ``SemanticSegmenter`` on
    seeded weights, the card against the CPU over `n` clean PNGs: the
    decoder's scores before their softmax within SEG_TOL of their
    largest, the labels equal where the top-two margin exceeds SEG_TOL of
    it; ms a batch on the card."""
    import torch

    from rewriting_torch import native
    from rewriting_torch.segment.semantic import SemanticSegmenter

    x = torch.as_tensor(next(iter(native.read_batches(
        png_paths(clean_dir), n))))
    out = {}
    for arch, decoder in SEG_ARCHS:
        segs = [SemanticSegmenter(None, ["-", "a", "b", "c"], arch=arch,
                                  decoder=decoder, device=dev)
                for dev in ("cuda", "cpu")]

        def logits(seg, images):
            feats = seg.ENCODERS[seg.arch][0](
                seg.params["encoder"], seg.normalize(images),
                seg.dilate_scale)
            return seg.decoder.logits(seg.params["decoder"], feats,
                                      seg_size=tuple(images.shape[1:3]))
        with torch.no_grad():
            card, cpu = logits(segs[0], x.cuda()), logits(segs[1], x)
        err = rel_diff(card.cpu(), cpu)
        labels = segs[0].segment_batch(x.cuda()).cpu()
        sure = top2_margin(cpu) > SEG_TOL * float(cpu.abs().max())
        agree = bool((labels[:, 0] == segs[1].segment_batch(x)[:, 0])
                     [sure].all())
        ms = time_ms(torch, lambda: segs[0].segment_batch(x.cuda()), runs=5)
        out[f"{arch}+{decoder}"] = {"rel_err": err, "labels_agree": agree,
                                    "sure_share": float(sure.float().mean()),
                                    "ms_per_batch": ms}
        print(f"SemanticSegmenter {arch} + {decoder}, {n} images, card vs "
              f"CPU: scores {err:.3e} of max (limit {SEG_TOL}); labels "
              f"agree where sure ({float(sure.float().mean()):.3f} of "
              f"pixels): {agree}; {ms:.3f} ms a batch on the card")
        if not (err <= SEG_TOL and agree):
            raise AssertionError(f"{arch} + {decoder}: {out[arch + '+' + decoder]}")
        del segs
    return out


def run_slice12(weights: str, clean_dir: str, counters) -> tuple:
    """Phases 34-36 on the seeded 1024 checkpoints in `weights` (written by
    ``write_seeded_weights(..., which=("faces", "celebhq"))``) and the
    PNGs of `clean_dir`; returns (results, launches by phase)."""
    import torch

    from rewriting_torch.models import zoo

    results, launches = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(34)

    def since(base):
        now = counters()
        return {k: now[k] - base[k] for k in now}

    with weights_env(weights):
        t0 = time.time()
        base = counters()
        model, params = zoo.load_seq_stylegan("faces", device="cuda")
        faces = check_faces(model, params, counters)
        faces["upconv_bf16"] = check_upconv_bf16(torch, gen)
        faces["suspension"] = check_schedule_suspension(model, params)
        launches["faces"] = since(base)
        results["faces"] = faces
        print(json.dumps({"faces_1024": faces}))
        del model, params
        phase("34 faces-1024", t0)

        t0 = time.time()
        base = counters()
        pg, pgp = zoo.load_proggan("celebhq", device="cuda")
        results["celebhq"] = check_proggan_celebhq(pg, pgp)
        launches["celebhq"] = since(base)
        print(json.dumps({"celebhq_1024": results["celebhq"]}))
        del pg, pgp
        phase("35 ProgGAN celebhq-1024", t0)

    t0 = time.time()
    base = counters()
    results["semantic"] = check_semantic_archs(clean_dir)
    launches["semantic"] = since(base)
    print(json.dumps({"semantic_archs": results["semantic"]}))
    phase("36 segmenter encoders and decoders", t0)
    torch.cuda.empty_cache()
    return results, launches


def slice12_counts() -> dict:
    """The kernels' launch counters, K1's two modes and K2's two
    directions apart."""
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    return {"k1": kup.launches, "k1_bf16": kup.launches_bf16,
            "k2": kblur.launches, "k2_backward": kblur.backward_launches,
            "k2_general": kblur.general_launches,
            "k3": kup2.launches + kup2.general_launches}


def add_slice12(kernels: dict, results: dict, launches: dict) -> None:
    """Phases 34-36 into the kernels line: K1's one-pass row (its numbers
    at (16,256,128,128)->128, its launches on phase 34's "default" stages)
    and each kernel's ``slice12_launches``."""
    faces = results["faces"]
    bf16 = faces["upconv_bf16"]
    head = next(r for r in bf16["rows"]
                if r["shape"] == [16, 256, 128, 128, 128])
    kernels["upconv_blur_bf16"] = {
        "name": "upconv_blur_bf16", "route": "cuda",
        "source": "rewriting_torch/csrc/upconv_blur_bf16.cu",
        "replaces": "rewriting_tpu/ops/pallas_upconv.py:232 "
                    "(upconv_blur_pallas at DEFAULT precision)",
        "launches": faces["launches"]["k1_default"]["k1_bf16"],
        "max_abs_err": bf16["max_abs_err"],
        "max_rel_err": bf16["max_rel_err"], "at": head["shape"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "tf32_mode_ms": head["tf32_ms"],
        "rows": bf16["rows"], "ptxas": bf16["ptxas"],
        "slice12_launches": {k: v["k1_bf16"]
                             for k, v in faces["launches"].items()}}
    for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                      ("upsample2x", "k3")):
        kernels[name]["slice12_launches"] = {
            **{f"faces_{k}": v[key] for k, v in faces["launches"].items()},
            **{k: v[key] for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# Phase 37: the NBB copy-paste baseline at church-256
# ---------------------------------------------------------------------------

NBB_SIZE = 256          # church-256's images, VGG16's full widths
NBB_CPU_SIZE = 256      # (a)'s CPU comparison; 128 if the CPU takes > 60 s
NBB_PYRAMID_RTOL = 1e-4  # card vs CPU VGG16 taps, of each level's max
NBB_MARGIN = 1e-5       # find_mapping's candidates closer than this (of
                        # the level's largest score) may swap by rounding
NBB_K = 10              # pairs, and (a)'s k_per_level: the golden's run


def nbb_images(clean_dir: str, size: int = NBB_SIZE):
    """Two zc (size, size, 3) images from the first two PNGs of
    `clean_dir`, shrunk by block means when size is under theirs."""
    import numpy as np

    from rewriting_torch.utils.renormalize import decode_png, renormalize

    out = []
    for name in png_paths(clean_dir)[:2]:
        with open(name, "rb") as f:
            img = renormalize(decode_png(f.read()), "byte", "zc")
        s = img.shape[0] // size
        out.append(img.reshape(size, s, size, s, 3).mean((1, 3))
                   .astype(np.float32))
    return out


def nbb_level_table(stats: dict) -> list:
    """The printable part of ``sparse_correspondence``'s per-level stats."""
    return [{k: v for k, v in lv.items() if k != "mapping"}
            for lv in stats["levels"]]


def first_mapping_difference(card: dict, cpu: dict, device: str):
    """The first level and position where the card's and the CPU's
    ``find_mapping`` differ, with the CPU inputs' float64 top-two margin
    there over the level's largest score, or None if every level is
    equal."""
    import torch

    from rewriting_torch.baselines import nbb

    for lv_card, lv_cpu in zip(card["levels"], cpu["levels"]):
        m, mc = lv_cpu["mapping"], lv_card["mapping"]
        for key, src, dst, init in (("a2b", "A", "B", "map_ab"),
                                    ("b2a", "B", "A", "map_ba")):
            diff = (mc[key] != m[key]).any(-1)
            if not bool(diff.any()):
                continue
            top, margin = nbb.mapping_margin(
                m[src].to(device, torch.float64),
                m[dst].to(device, torch.float64), m["patch"],
                m[init].to(device), m["radius"])
            scale = float(top.abs().max())
            where = torch.nonzero(diff)
            share = (margin.cpu()[diff] / scale)
            return {"level": lv_cpu["level"], "mapping": key,
                    "positions": int(diff.sum()),
                    "first": [int(v) for v in where[0]],
                    "largest_margin": float(share.max()),
                    "near_tie": bool((share <= NBB_MARGIN).all())}
    return None


def check_nbb(clean_dir: str, device="cuda", size: int = NBB_SIZE,
              cpu_size: int = NBB_CPU_SIZE) -> dict:
    """Phase 37, the NBB copy-paste baseline (``baselines/nbb.py``) on two
    of phase 9's church-256 PNGs at VGG16's full widths.

    (a) ``neural_best_buddies`` with k_per_level=10 (the golden's
    configuration) on `device` and on the CPU at `cpu_size`: the pyramids
    within NBB_PYRAMID_RTOL of each level's max; every level's mappings
    equal, or, at the first level that differs, only where the top-two
    margin is within NBB_MARGIN of the level's largest score; the final
    pairs equal unless such a near-tie came first.  At `size` on `device`
    alone too when `cpu_size` is smaller.
    (b) ``nbb_paste`` with its defaults (k_per_level=None) on `device`,
    copying the dome2tree request's object region: the blend finite and
    equal to image b outside the warped mask, per-level parent and buddy
    counts and the seconds of each stage."""
    import numpy as np
    import torch

    from rewriting_torch.baselines import nbb
    from rewriting_torch.utils.renormalize import mask_from_url

    out = {"size": size, "cpu_size": cpu_size}
    a, b = nbb_images(clean_dir, size)

    # (a) the card against the CPU, on the same images
    ca, cb = nbb_images(clean_dir, cpu_size)
    imgs = np.stack([ca, cb])
    t0 = time.time()
    card_pyr = nbb.default_feature_pyramid(imgs, device=device)
    cpu_pyr = nbb.default_feature_pyramid(imgs, device="cpu")
    pyr_err = [rel_diff(g.cpu(), w) for g, w in zip(card_pyr, cpu_pyr)]
    widths = [int(p.shape[-1]) for p in card_pyr]
    print(f"NBB pyramids at {cpu_size} px, {device} vs CPU: "
          + ", ".join(f"{tuple(p.shape[1:])} {e:.2e}"
                      for p, e in zip(card_pyr, pyr_err))
          + f" of max (limit {NBB_PYRAMID_RTOL}); {time.time() - t0:.3f} s")
    if widths != [64, 128, 256, 512, 512] or \
            not max(pyr_err) <= NBB_PYRAMID_RTOL:
        raise AssertionError(f"NBB pyramids: widths {widths}, {pyr_err}")
    del card_pyr, cpu_pyr
    runs = []
    for dev in (device, "cpu"):
        stats = {}
        t0 = time.time()
        pairs = nbb.neural_best_buddies(ca[None], cb[None], k=NBB_K,
                                        k_per_level=NBB_K, device=dev,
                                        stats=stats)
        runs.append((pairs, stats, time.time() - t0))
        print(f"NBB (a) at {cpu_size} px on {dev}: {len(pairs)} pairs in "
              f"{runs[-1][2]:.3f} s; " + "; ".join(
                  f"level {lv['level']}: buddies {lv['buddies']}, kept "
                  f"{lv['kept']}, find_mapping {lv['find_mapping_s']:.3f} s"
                  for lv in stats["levels"]))
    (card_pairs, card_stats, card_s), (cpu_pairs, cpu_stats, cpu_s) = runs
    first = first_mapping_difference(card_stats, cpu_stats, device)
    same = card_pairs == cpu_pairs
    print(f"NBB (a) {device} vs CPU: pairs equal {same}; first mapping "
          f"difference {first}")
    if first is not None and not first["near_tie"]:
        raise AssertionError(f"NBB mappings differ beyond a near-tie: "
                             f"{first}")
    if first is None and not same:
        raise AssertionError(f"NBB pairs differ with equal mappings: "
                             f"{card_pairs} vs {cpu_pairs}")
    if not 0 < len(card_pairs) <= NBB_K:
        raise AssertionError(f"NBB (a) gave {len(card_pairs)} pairs")
    out["a"] = {"pairs": card_pairs, "pairs_equal": same,
                "first_difference": first, "pyramid_rel_err": pyr_err,
                "card_s": card_s, "cpu_s": cpu_s,
                "card_levels": nbb_level_table(card_stats),
                "cpu_levels": nbb_level_table(cpu_stats)}
    del runs, card_stats, cpu_stats
    if cpu_size != size:
        stats = {}
        t0 = time.time()
        pairs = nbb.neural_best_buddies(a[None], b[None], k=NBB_K,
                                        k_per_level=NBB_K, device=device,
                                        stats=stats)
        out["a"]["full_size"] = {"pairs": pairs, "s": time.time() - t0,
                                 "levels": nbb_level_table(stats)}
        print(f"NBB (a) at {size} px on {device} alone: {len(pairs)} pairs "
              f"in {out['a']['full_size']['s']:.3f} s")

    # (b) the copy-paste baseline with its defaults
    with open(MASK) as f:
        mask = mask_from_url(json.load(f)["object"][1], (size, size)) > 0.5
    stats = {}
    if device != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pasted, pairs = nbb.nbb_paste(a, b, mask, device=device, stats=stats)
    wall = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if device != "cpu"
            else None)
    levels = nbb_level_table(stats)
    src = [p[0] for p in pairs]
    dst = [p[1] for p in pairs]
    warped_mask = nbb.mls_warp(mask.astype(np.float32)[..., None], src,
                               dst)[..., 0] > 0.5
    outside = bool(np.array_equal(pasted[~warped_mask],
                                  b.astype(np.float64)[~warped_mask]))
    finite = bool(np.isfinite(pasted).all())
    sums = {key: sum(lv[key] for lv in levels)
            for key in ("find_mapping_s", "refine_s", "reconstruct_s",
                        "kmeans_s")}
    out["b"] = {"pairs": pairs, "wall_s": wall, "mask_pixels":
                int(mask.sum()), "warped_mask_pixels":
                int(warped_mask.sum()), "outside_unchanged": outside,
                "finite": finite, "correspondences": stats["pairs"],
                "peak_gib": peak,
                "pyramid_s": stats["pyramid_s"],
                "top_k_s": stats["top_k_s"], "mls_s": stats["mls_s"],
                "poisson_s": stats["poisson_s"], **sums, "levels": levels}
    print(f"NBB (b) nbb_paste at {size} px on {device}: {len(pairs)} pairs "
          f"of {stats['pairs']} correspondences in {wall:.3f} s: pyramids "
          f"{stats['pyramid_s']:.3f} s, find_mapping "
          f"{sums['find_mapping_s']:.3f}, refinement {sums['refine_s']:.3f},"
          f" reconstructions {sums['reconstruct_s']:.3f}, k-means "
          f"{stats['top_k_s']:.3f}, MLS {stats['mls_s']:.3f}, Poisson "
          f"{stats['poisson_s']:.3f}; mask {int(mask.sum())} -> "
          f"{int(warped_mask.sum())} pixels; peak device memory {peak} GiB")
    for lv in levels:
        print(f"  level {lv['level']} {tuple(lv['shape'])}: parents "
              f"{lv['parents']}, buddies {lv['buddies']}, children "
              f"{lv['children']}, kept {lv['kept']}; find_mapping "
              f"{lv['find_mapping_s']:.3f} s, refinement "
              f"{lv['refine_s']:.3f} s")
    if not (finite and outside and pasted.shape == (size, size, 3)
            and 0 < len(pairs) <= NBB_K and warped_mask.any()):
        raise AssertionError(f"nbb_paste: {out['b']}")
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 38: the sharded samplers at faces-1024
# ---------------------------------------------------------------------------

SHARDED_BATCH = 8           # the global batch of every sharded run
SHARDED_LAYOUTS = ((1, 4), (2, 2))      # (data, spatial) of the bands
SHARDED_DEFAULT_FROM = 256  # phase 34's "default" schedule with K1 on
SHARDED_INT8_FROM = 512     # phase 34's int8 schedule
# the bands with K1's gate on at every layer (3xTF32) against one device's
# pipeline_fast under the same gate, of max |one device|
SHARDED_RTOL = FORWARD_RTOL
# under the "default" schedule, 1e-2 of max: "default" rounds each output
# to bf16 (a flip is 2^-8 of it), and every layout sums some convolution
# in another order than one device: the bands run the s2d tail's seq
# stages at 1024 px where one device runs the tail's s2d convs (1 x 4
# reads 3.5e-3), and the 2 x 2 ranks' batch of 4 takes other cuDNN
# algorithms too (3.4e-3-3.7e-3)
SHARDED_DEFAULT_RTOL = 1e-2
# int8 on dp, tp and the bands against one device's int8 forward: the int8
# values that differ are counted (expected 0), each scale held within
# SHARDED_SCALE_RTOL of one device's (a rank that took its own share's max
# reads 1e-2 and more off; a rounding tie that flipped may move the next
# layer's max by a step), and the PSNR above the CPU tests' floor where a
# tie flips (tests/test_torch_parallel_int8.py)
SHARDED_SCALE_RTOL = 1e-3
SHARDED_INT8_PSNR = 40.0
# where the first int8 stage's values differ from one device's, how near
# one device's |x| / scale lies to a quantum's half: a rounding tie that
# the ranks' fp32 sums, taken in another order by cuDNN, tip the other
# way (a few ulps of x are about 1e-5 of a quantum)
SHARDED_TIE = 1e-3


def band_slab_shapes(model, batch: int, n_spatial: int, min_res: int = 0):
    """(B, I, H, W, O) of K1's launches on the bands of `n_spatial` ranks,
    one a layer of `model` whose up-conv passes K1's gate at `min_res`
    and is banded (``parallel/mesh.py``): the input rows of a band and one
    more on each side, at full width."""
    from rewriting_torch.models.stylegan2 import stage_resolution
    shapes = []
    for name, spec in model._param_specs.items():
        if spec[0] != "dconv" or not spec[4] or name in model._s2d_names:
            continue
        in_c, out_c, res = spec[1], spec[2], stage_resolution(name)
        if min(in_c, out_c) < 64 or in_c % 8 or out_c % 8 or res < min_res:
            continue
        if res % n_spatial or res // n_spatial < 1:
            continue
        a, b = 0, res // n_spatial
        rows = (b + 1) // 2 - (a - 2) // 2 + 1
        shapes.append((batch, in_c, rows, res // 2, out_c))
    return shapes


def check_band_kernels(torch, gen, model, default_from: int,
                       device="cuda") -> dict:
    """Phase 38 (a): K1 (3xTF32) and its one-pass bf16 mode against their
    plain versions, with the epilogue, at the slab shapes the bands of
    ``SHARDED_LAYOUTS`` give them (the one-pass mode at the layers the
    "default" schedule from `default_from` takes), each timed on the card
    at the 512-px layer's slab beside its plain version.  On the CPU the
    wrapper takes the plain version."""
    from rewriting_torch.ops import upconv_blur as kup
    kf = (0.25, 0.75, 0.75, 0.25)
    rows, worst = [], {"highest": 0.0, "default": 0.0}
    for n_data, n_sp in SHARDED_LAYOUTS:
        batch = SHARDED_BATCH // n_data
        for tier, min_res in (("highest", 0), ("default", default_from)):
            for b, i, h, w, o in band_slab_shapes(model, batch, n_sp,
                                                  min_res):
                x = torch.randn((b, i, h, w), generator=gen, device=device)
                wf = torch.randn((o, i, 3, 3), generator=gen,
                                 device=device) / (3.0 * i ** 0.5)
                epi = (torch.rand((b, o), generator=gen,
                                  device=device) + 0.5,
                       torch.randn((b, 1, 2 * h, 2 * w), generator=gen,
                                   device=device),
                       torch.randn((o,), generator=gen, device=device))
                got = kup.upconv_blur(x, wf, kf, *epi, tier=tier)
                want = kup.upconv_blur_reference(x, wf, kf, *epi, tier=tier)
                rel = rel_diff(got, want)
                worst[tier] = max(worst[tier], rel)
                row = {"layout": f"{n_data}x{n_sp}", "tier": tier,
                       "shape": [b, i, h, w, o], "rel_err": rel}
                if (n_data, n_sp) == SHARDED_LAYOUTS[0] and w == 256 and \
                        torch.device(device).type == "cuda":
                    row["ms"] = time_ms(torch, lambda: kup.upconv_blur_cuda(
                        x, wf, kf, *epi, tier=tier))
                    row["plain_ms"] = time_ms(
                        torch, lambda: kup.upconv_blur_reference(
                            x, wf, kf, *epi, tier=tier))
                rows.append(row)
                limit = UPCONV_RTOL if tier == "highest" else \
                    BF16_UPCONV_RTOL
                print(f"phase 38 K1 {tier} on a {row['layout']} band's slab "
                      f"{(b, i, h, w)} -> {o}: {rel:.3e} of max from its "
                      f"plain version (limit {limit})"
                      + (f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                         " ms" if "ms" in row else ""))
                if tuple(got.shape) != (b, o, 2 * h, 2 * w) or \
                        not rel <= limit:
                    raise AssertionError(f"K1 {tier} at {row['shape']}: "
                                         f"{rel}")
                del x, wf, epi, got, want
    return {"rows": rows, "max_rel_err": worst}


def _placed(t, stage, shape, where, model):
    """The positions of the whole map `t` (one device's) that a rank's
    share of `shape` holds at `stage`: its rows of the batch, a tp row
    layer's channel slice, a band's rows and halo (zeros past the image's
    edges).  `where`: ((index, size) of the data, model and spatial
    axes)."""
    import torch.nn.functional as F

    from rewriting_torch.models.stylegan2 import stage_resolution
    (di, dn), (mi, mn), (si, sn) = where
    rows = t.shape[0] // dn
    t = t[di * rows:(di + 1) * rows]
    if shape[1] < t.shape[1]:
        t = t[:, mi * shape[1]:(mi + 1) * shape[1]]
    res = stage_resolution(stage)
    if sn > 1 and res % sn == 0 and res // sn >= 1:
        a, b = si * res // sn, (si + 1) * res // sn
        lo, hi = (((a - 2) // 2, (b + 1) // 2 + 1)
                  if model._param_specs[stage][4] else (a - 1, b + 1))
        t = F.pad(t, (0, 0, 2, 2))[:, :, lo + 2:hi + 2]
    return t


def sharded_job(spec: dict) -> dict:
    """One rank of phase 38's job (every rank runs it): faces-1024 from the
    zoo with nonzero noise strengths, at ``SHARDED_BATCH``.  Each sharded
    run has the launch counts set to 0 just before it and read just after,
    and is held against this rank's own one-device forward of the same
    global batch: the bands of ``SHARDED_LAYOUTS`` with K1's gate on at
    every layer, then under the "default" schedule too; then under the
    int8 schedule dp, tp and the 1 x 4 bands, with every quantization
    recorded and its int8 values counted against one device's.  Raises on
    a failed check; returns {run: its numbers}."""
    import torch
    import torch.distributed as dist

    from rewriting_torch.models import zoo
    from rewriting_torch.models.stylegan2 import (SeqStyleGAN2,
                                                  mixed_precision_schedule)
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import precision, quant
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier
    from rewriting_torch.parallel import (comm, make_mesh, make_mesh_2d,
                                          sharded_sampler,
                                          spatial_sharded_sampler,
                                          tensor_shard_params,
                                          tensor_sharded_sampler)
    from rewriting_torch.utils.zdataset import standard_z_sample

    apply_parity_tier()
    device = comm.default_device()
    rank, world = dist.get_rank(), dist.get_world_size()
    if spec.get("model"):
        model = SeqStyleGAN2(**spec["model"], device=device)
        params = model.init_params(seed=0)
    else:
        with weights_env(spec["weights"]):
            model, params = zoo.load_seq_stylegan("faces", device=device)
    params = noisy_params(params)
    z = standard_z_sample(SHARDED_BATCH, model.z_dim, seed=38)
    noise = model.prepare_noise(SHARDED_BATCH)
    out = {}

    def counts():
        return {"k1": kup.launches, "k1_bf16": kup.launches_bf16,
                "k2": kblur.launches, "k2_general": kblur.general_launches,
                "k3": kup2.launches + kup2.general_launches,
                "built": comm.built}

    def timed(fn):
        kup.launches = kup.launches_bf16 = kblur.launches = 0
        kblur.general_launches = kup2.launches = kup2.general_launches = 0
        comm.built = 0
        sync(device)
        t1 = time.time()
        y = fn()
        sync(device)
        return y, time.time() - t1, counts()

    def banded(mesh):
        def run():
            return spatial_sharded_sampler(model, mesh)(params, z, noise)

        def whole(block):
            rows = comm.all_gather(block, mesh.group("spatial"), dim=1)
            return comm.all_gather(rows, mesh.group("data"))
        return run, whole

    meshes = {f"{d}x{s}": make_mesh_2d(d, s) for d, s in SHARDED_LAYOUTS}
    kup.set_fused_upconv("on", min_res=0)
    try:
        for name, schedule in (("k1", None),
                               ("k1_default", spec["default_from"])):
            precision.set_precision_schedule(
                None if schedule is None
                else mixed_precision_schedule(schedule))
            try:
                with torch.no_grad():
                    single = model(params, z, noise)
                for layout, mesh in meshes.items():
                    run, whole = banded(mesh)
                    run()                           # warm
                    block, secs, n = timed(run)
                    images = whole(block)
                    out[f"sp_{name}_{layout}"] = {
                        "s": secs, "images_per_s": SHARDED_BATCH / secs,
                        "block": list(block.shape),
                        "rel": _rel(images, single),
                        "psnr": psnr(images.float(), single.float()), **n}
                    del block, images
            finally:
                precision.set_precision_schedule(None)
            del single
    finally:
        kup.set_fused_upconv("off", min_res=256)

    # int8: dp, tp and the 1 x 4 bands, each quantization recorded
    records = []
    plain = quant.quantize_activation

    def recorded(x):
        x_i8, scale = plain(x)
        records.append((precision._CURRENT_STAGE.get(), x_i8, scale, x))
        return x_i8, scale

    def taken(fn):
        records.clear()
        y, secs, n = timed(fn)
        got = list(records)
        records.clear()
        return y, secs, n, got

    data = make_mesh()
    mt = make_mesh(axis="model")
    local = tensor_shard_params(model, params, mt, axis="model")
    cases = (
        ("dp", ((rank, world), (0, 1), (0, 1)),
         lambda: sharded_sampler(model, data)(params, z, noise),
         lambda y: comm.all_gather(y, data.group("data"))),
        ("tp", ((0, 1), (rank, world), (0, 1)),
         lambda: tensor_sharded_sampler(model, mt)(local, z, noise),
         lambda y: y),
        ("sp_1x4", ((0, 1), (0, 1), (rank, world)),
         banded(meshes["1x4"])[0], banded(meshes["1x4"])[1]))
    quant.quantize_activation = recorded
    precision.set_precision_schedule(mixed_precision_schedule(
        spec["int8_from"], tier="int8"))
    try:
        with torch.no_grad():
            single, _, _, ref = taken(lambda: model(params, z, noise))
        for name, where, run, whole in cases:
            run()                                   # warm
            y, secs, n, got = taken(run)
            images = whole(y)
            if [r[0] for r in got] != [r[0] for r in ref]:
                raise AssertionError(f"int8 {name} quantized at "
                                     f"{[r[0] for r in got]}, one device at "
                                     f"{[r[0] for r in ref]}")
            differ, margin = [], []
            for (stage, q1, s1, x1), (_, q, _, _) in zip(ref, got):
                apart = _placed(q1, stage, q.shape, where, model) != q
                x1 = _placed(x1, stage, q.shape, where, model)
                # how near one device's value lies to a rounding tie
                half = ((x1.abs() / s1) % 1.0 - 0.5).abs()[apart]
                differ.append(int(apart.sum()))
                margin.append(float(half.max()) if half.numel() else 0.0)
            scale_rel = max(abs(float(r[2]) - float(g[2])) / float(r[2])
                            for r, g in zip(ref, got))
            out[f"int8_{name}"] = {
                "s": secs, "images_per_s": SHARDED_BATCH / secs,
                "stages": [r[0] for r in ref], "int8_differ": differ,
                "tie_margin": margin,
                "int8_values": [int(g[1].numel()) for g in got],
                "scale_rel": scale_rel, "rel": _rel(images, single),
                "psnr": psnr(images.float(), single.float()), **n}
            del y, images, got
    finally:
        precision.set_precision_schedule(None)
        quant.quantize_activation = plain
    return out


def check_sharded_faces(weights: str, device="cuda", model=None,
                        default_from: int = SHARDED_DEFAULT_FROM,
                        int8_from: int = SHARDED_INT8_FROM,
                        timeout_s: float = MESH_JOB_TIMEOUT) -> dict:
    """Phase 38: the sharded samplers at faces-1024 full width (the seeded
    ``stylegan2_faces.pt`` in `weights`, through the zoo), batch
    ``SHARDED_BATCH``: (a) K1 and its one-pass mode against their plain
    versions at the bands' slab shapes; then a job of 4 ranks sharing this
    card over gloo (:func:`sharded_job`): (b) the 1 x 4 and 2 x 2 bands
    with K1's gate on at every layer against one device's
    ``pipeline_fast`` within ``SHARDED_RTOL`` of max, and under the
    "default" schedule within ``SHARDED_DEFAULT_RTOL``; (c) int8 on dp, tp
    and the 1 x 4 bands against one device's int8 forward, the int8 values
    that differ counted and PSNR above ``SHARDED_INT8_PSNR``; (d) each
    rank's K1, K1 one-pass and K2 launches, more than 0 where the gate
    passes (K2 where it is off).  Prints each rank's numbers, whose times
    are ranks sharing one card and not a scaling figure.  Runs on the card
    unless given ``device="cpu"`` (with `model`, the keyword arguments of a
    smaller ``SeqStyleGAN2`` with seeded weights, and the schedules' least
    resolutions), where the kernels are their plain versions."""
    import torch

    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    from rewriting_torch.parallel import comm
    from rewriting_torch.utils.device import resolve_device

    device = resolve_device(device)
    t1 = time.time()
    gen = torch.Generator(device=device).manual_seed(38)
    shape = model or {"size": 1024, "style_dim": 512, "n_mlp": 8,
                      "channel_multiplier": 2}
    kernels = check_band_kernels(torch, gen, SeqStyleGAN2(**shape,
                                                          device=device),
                                 default_from, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        device = torch.device("cuda", torch.cuda.current_device())
    outs = comm.spawn(sharded_job, 4, device=str(device), backend="gloo",
                      timeout_s=timeout_s, args=({
                          "weights": weights, "model": model,
                          "default_from": default_from,
                          "int8_from": int8_from},))
    for rank, out in enumerate(outs):
        for name, n in out.items():
            print(f"phase 38, rank {rank}, {name}: {n['s']:.3f} s; "
                  + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                              else f"{k} {v}" for k, v in n.items()
                              if k not in ("s", "stages")))
    for rank, out in enumerate(outs):
        for name, n in out.items():
            if name.startswith("sp_k1"):
                limit = (SHARDED_DEFAULT_RTOL if "default" in name
                         else SHARDED_RTOL)
                ok = n["rel"] <= limit
                launched = n["k1"] > 0 and ("default" not in name
                                            or n["k1_bf16"] > 0)
            else:
                ok = (n["psnr"] >= SHARDED_INT8_PSNR
                      and n["scale_rel"] <= SHARDED_SCALE_RTOL)
                launched = n["k2"] > 0
            # the launch counts are the card's (the CPU runs the plain
            # versions); no path may launch K3 or the general K2
            if device.type == "cuda" and not (
                    launched and not n["k3"] and not n["k2_general"]):
                ok = False
            if not ok:
                raise AssertionError(f"phase 38 rank {rank} {name}: {n}")
    # the first int8 stage where any rank's values differ from one
    # device's: every such value a tie (a tie that flips on one rank moves
    # every rank's next stage)
    for name in (n for n in outs[0] if n.startswith("int8")):
        stages = outs[0][name]["stages"]
        first = next((i for i in range(len(stages))
                      if any(o[name]["int8_differ"][i] for o in outs)), None)
        if first is None:
            print(f"phase 38 {name}: no int8 value differs from one device's")
            continue
        worst = max(o[name]["tie_margin"][first] for o in outs)
        print(f"phase 38 {name}: first differing int8 values at "
              f"{stages[first]}, "
              f"{sum(o[name]['int8_differ'][first] for o in outs)} of them, "
              f"each within {worst:.3e} of a quantum's half (limit "
              f"{SHARDED_TIE})")
        if not worst <= SHARDED_TIE:
            raise AssertionError(f"phase 38 {name}: int8 values differ "
                                 f"{worst} from a tie at {stages[first]}")
    return {"s": time.time() - t1, "kernels": kernels, "ranks": outs}


def add_slice15(kernels: dict, sharded: dict) -> None:
    """Phase 38 into the kernels line: each kernel's launches on each run
    of the job, rank by rank, and K1's errors at the bands' slabs."""
    runs = sharded["ranks"][0]
    for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                      ("upconv_blur_bf16", "k1_bf16"),
                      ("upsample2x", "k3")):
        kernels[name]["slice15_launches"] = {
            run: [out[run][key] for out in sharded["ranks"]] for run in runs}
    worst = sharded["kernels"]["max_rel_err"]
    kernels["upconv_blur"]["slice15_slab_max_rel_err"] = worst["highest"]
    kernels["upconv_blur_bf16"]["slice15_slab_max_rel_err"] = \
        worst["default"]


# ---------------------------------------------------------------------------
# Phase 39: JPEG reading (csrc/jpegdec.cpp) for FID and the real samples,
# and every other image file through PIL
# ---------------------------------------------------------------------------

JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")
JPEG_TIMED = "baseline_420_q75_256"   # (b): 256x256, 4:2:0, quality 75
JPEG_REFUSED = ("truncated.jpg",)      # (f): corrupt, never handed to PIL
JPEG_BY_PIL = ("cmyk.jpg",)            # (f): a kind jpegdec does not read
IMAGES_DIR = os.path.join(ROOT, "tests", "data", "images")   # (g)
JPEG_STATS_RTOL = 1e-6   # (c): of the largest mean / covariance value


def jpeg_fixtures():
    """(name, jpg, png) of each fixture with a PNG twin (PIL's decode of
    the JPEG, written by ``scripts/make_jpeg_fixtures.py``), by name."""
    names = sorted(f[:-4] for f in os.listdir(JPEG_DIR) if f.endswith(".jpg")
                   and os.path.exists(os.path.join(JPEG_DIR, f[:-4] + ".png")))
    return [(n, os.path.join(JPEG_DIR, n + ".jpg"),
             os.path.join(JPEG_DIR, n + ".png")) for n in names]


def check_jpeg(workdir: str, counters, feature_fn=None, n_decode: int = 256,
               n_fid: int = 64, batch_size: int = 16, device: str = "cuda",
               build_s: float = None) -> dict:
    """Phase 39: the port's JPEG reading.  (a) every fixture of
    ``tests/data/jpeg`` through ``native.read_image_rgb`` and
    ``read_image`` against its PNG twin read back by the port's PNG
    decoder, 0 LSB apart; (b) ``read_batches`` images/s over `n_decode`
    paths of the 256x256 4:2:0 fixture on read_batches' default pool and
    on one thread, then of its twin, at `batch_size`, and the median time
    of one decode of the JPEG's bytes (jpegdec's first build timed on its
    own); (c) FID's statistics
    (``compute_feature_stats`` of ``_image_dir_batches``, as
    ``compute_fid`` takes a directory) through `feature_fn` (else the
    ``FeatureExtractor`` that ``$REWRITING_TPU_WEIGHTS`` gives) of `n_fid`
    copies of the 256x256 fixtures as JPEG, then of their twins, within
    JPEG_STATS_RTOL; (d) ``samples.get_gt_samples`` of the two directories
    equal; (e) no kernel launched over the phase (`counters()` before
    and after (g)); (f) the truncated fixture raises ``ValueError`` naming
    its file, and the CMYK one reads as PIL reads it on this host; (g)
    every file of ``tests/data/images`` through ``read_image_rgb``,
    ``read_image`` and ``read_batches`` equal to ``numpy.asarray`` of
    PIL's image (its ``convert("RGB")``, its own mode) on this host, PIL's
    version printed.  `build_s`: the seconds of jpegdec's build where it
    ran before the phase (``main`` builds it in phase 2, beside the
    kernels)."""
    import shutil

    import numpy as np

    from rewriting_torch import native
    from rewriting_torch.metrics import fid, samples
    from rewriting_torch.utils.device import resolve_device

    resolve_device(device)
    base = counters()
    t1 = time.time()
    native._jpeg_library()
    load_s = time.time() - t1
    if build_s is None:
        build_s = load_s
        print(f"phase 39 jpegdec built and loaded in {build_s:.3f} s")
    else:
        print(f"phase 39 jpegdec built in {build_s:.3f} s (phase 2, beside "
              f"the kernels' nvcc), loaded in {load_s:.3f} s")

    # (a) every fixture against its twin
    fixtures = []
    for name, jpg, png in jpeg_fixtures():
        row = {"name": name}
        for how, read in (("rgb", native.read_image_rgb),
                          ("own_mode", native.read_image)):
            got, want = read(jpg), read(png)
            apart = (int(np.count_nonzero(got != want))
                     if got.shape == want.shape else -1)
            row[how] = {"shape": list(got.shape), "values_apart": apart}
        fixtures.append(row)
        print(f"phase 39 (a) {name}: {row['rgb']['shape']} RGB, "
              f"{row['own_mode']['shape']} in its mode; values apart from "
              f"PIL's decode {row['rgb']['values_apart']}, "
              f"{row['own_mode']['values_apart']}")
    wrong = [r["name"] for r in fixtures
             if r["rgb"]["values_apart"] or r["own_mode"]["values_apart"]]
    if wrong or not fixtures:
        raise AssertionError(f"phase 39: JPEG fixtures differ from their "
                             f"PNG twins: {wrong or 'no fixture'}")

    # (b) decode images/s: read_batches on its default pool, then the JPEG
    # on one thread, and one decode of the bytes in memory
    timed = os.path.join(JPEG_DIR, JPEG_TIMED)
    pool = min(8, os.cpu_count() or 1)   # read_batches' default
    rates = {}
    for key, kind, workers in (("jpg", "jpg", pool), ("jpg_1", "jpg", 1),
                               ("png", "png", pool)):
        paths = [f"{timed}.{kind}"] * n_decode
        t1 = time.time()
        n = sum(len(b) for b in native.read_batches(paths, batch_size,
                                                    workers=workers))
        rates[key] = n / (time.time() - t1)
    with open(f"{timed}.jpg", "rb") as f:
        data = f.read()
    times = []
    for _ in range(64):
        t1 = time.perf_counter()
        native.decode_jpeg(data)
        times.append(time.perf_counter() - t1)
    decode_ms = float(np.median(times) * 1e3)
    print(f"phase 39 (b) read_batches of {n_decode} x {JPEG_TIMED} at batch "
          f"{batch_size}: JPEG {rates['jpg']:.2f} images/s on {pool} "
          f"threads, {rates['jpg_1']:.2f} on 1 "
          f"({rates['jpg'] / rates['jpg_1']:.2f}x); its PNG twin "
          f"{rates['png']:.2f} images/s on {pool} "
          f"({rates['jpg'] / rates['png']:.2f}x); one decode in memory "
          f"{decode_ms:.3f} ms (median of 64; {os.cpu_count()} cores)")

    # (c) FID statistics of JPEG and PNG directories of the same pixels
    square = [(j, p) for (name, j, p), r in zip(jpeg_fixtures(), fixtures)
              if r["rgb"]["shape"] == [256, 256, 3]]
    dirs = {kind: os.path.join(workdir, f"phase39_{kind}")
            for kind in ("jpg", "png")}
    for kind, d in dirs.items():
        os.makedirs(d, exist_ok=True)
        for i in range(n_fid):
            src = square[i % len(square)][0 if kind == "jpg" else 1]
            shutil.copyfile(src, os.path.join(d, f"{i}.{kind}"))
    t1 = time.time()
    fe = feature_fn or fid.FeatureExtractor(batch_size=batch_size,
                                            device=device)
    load_s = time.time() - t1
    stats, stats_s = {}, {}
    for kind, d in dirs.items():
        t1 = time.time()
        stats[kind] = fid.compute_feature_stats(
            fid._image_dir_batches(d, batch_size, as_uint8=True), fe)
        stats_s[kind] = time.time() - t1
    (mu_j, sig_j), (mu_p, sig_p) = stats["jpg"], stats["png"]
    mu_rel = float(np.abs(mu_j - mu_p).max() / np.abs(mu_p).max())
    sig_rel = float(np.abs(sig_j - sig_p).max() / np.abs(sig_p).max())
    print(f"phase 39 (c) FID statistics of {n_fid} images ({len(square)} "
          f"fixtures, copied): JPEG directory {stats_s['jpg']:.3f} s, PNG "
          f"{stats_s['png']:.3f} s (Inception loaded in {load_s:.3f} s); "
          f"mean {mu_rel:.3e}, covariance {sig_rel:.3e} of their largest "
          f"apart (limit {JPEG_STATS_RTOL})")
    if not (mu_rel <= JPEG_STATS_RTOL and sig_rel <= JPEG_STATS_RTOL):
        raise AssertionError(f"phase 39: FID statistics of the JPEG and PNG "
                             f"directories {mu_rel}, {sig_rel} apart")

    # (d) the patch-FID real samples
    t1 = time.time()
    gt = {kind: samples.get_gt_samples(d, 256, n_fid)
          for kind, d in dirs.items()}
    gt_s = time.time() - t1
    gt_apart = int(np.count_nonzero(gt["jpg"] != gt["png"]))
    print(f"phase 39 (d) get_gt_samples of the two directories: "
          f"{gt['jpg'].shape}, {gt_apart} values apart ({gt_s:.3f} s)")
    if gt["jpg"].shape != (n_fid, 256, 256, 3) or gt_apart:
        raise AssertionError(f"phase 39: get_gt_samples {gt['jpg'].shape}, "
                             f"{gt_apart} values apart")

    # (f) what the port refuses, and a JPEG it hands to PIL
    refused = {}
    for name in JPEG_REFUSED:
        path = os.path.join(JPEG_DIR, name)
        try:
            native.read_image_rgb(path)
        except ValueError as e:
            if path not in str(e):
                raise AssertionError(f"phase 39: {e} does not name {path}")
            refused[name] = str(e)
        else:
            raise AssertionError(f"phase 39: {path} was read")
        print(f"phase 39 (f) {name}: ValueError: {refused[name]}")
    by_pil = {name: against_pil(os.path.join(JPEG_DIR, name))
              for name in JPEG_BY_PIL}
    for name, row in by_pil.items():
        print(f"phase 39 (f) {name}: {row}")

    # (g) every other kind of image file, against PIL on this host
    images = check_images(IMAGES_DIR, batch_size)

    # (e) the phase launches no kernel
    launches = {k: v - base[k] for k, v in counters().items()}
    print(f"phase 39 (e) launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 39 launched {launches}")
    wrong = [n for n, r in list(by_pil.items()) + list(
        images["files"].items()) if not r["equal"]]
    if wrong:
        raise AssertionError(f"phase 39: read apart from PIL: {wrong}")
    return {"build_s": build_s, "fixtures": fixtures,
            "decode_images_per_s": {"jpeg": rates["jpg"],
                                    "jpeg_one_thread": rates["jpg_1"],
                                    "png": rates["png"]},
            "decode_threads": pool, "decode_ms": decode_ms,
            "fid_stats_s": stats_s, "inception_load_s": load_s,
            "mean_rel": mu_rel, "covariance_rel": sig_rel,
            "gt_samples_s": gt_s, "gt_values_apart": gt_apart,
            "launches": launches, "refused": refused, "by_pil": by_pil,
            "images": images}


def against_pil(path: str) -> dict:
    """The port's ``read_image_rgb`` and ``read_image`` of `path` against
    ``numpy.asarray`` of PIL's ``convert("RGB")`` and of its image in its
    own mode, on this host: shapes, dtypes and values apart."""
    import numpy as np
    import PIL.Image

    from rewriting_torch import native

    with PIL.Image.open(path) as im:
        row = {"mode": im.mode}
        want = {"rgb": np.asarray(im.convert("RGB")),
                "own_mode": np.asarray(im)}
    for how, read in (("rgb", native.read_image_rgb),
                      ("own_mode", native.read_image)):
        got = read(path)
        same = got.shape == want[how].shape and got.dtype == want[how].dtype
        row[how] = {"shape": list(got.shape), "dtype": str(got.dtype),
                    "values_apart": int(np.count_nonzero(got != want[how]))
                    if same else -1}
    row["equal"] = not (row["rgb"]["values_apart"]
                        or row["own_mode"]["values_apart"])
    return row


def check_images(directory: str, batch_size: int) -> dict:
    """Phase 39 (g): each file of `directory` against PIL on this host
    (``against_pil``), then ``read_batches`` of them all against PIL's
    ``convert("RGB")`` of each, 0 values apart; prints PIL's version."""
    import numpy as np
    import PIL
    import PIL.features
    import PIL.Image

    from rewriting_torch import native

    print(f"phase 39 (g) PIL {PIL.__version__} (WebP "
          f"{PIL.features.check('webp')}, libjpeg-turbo "
          f"{PIL.features.check_feature('libjpeg_turbo')})")
    t1 = time.time()
    files = {}
    for name in sorted(os.listdir(directory)):
        files[name] = against_pil(os.path.join(directory, name))
        row = files[name]
        print(f"phase 39 (g) {name}: {row['mode']}, RGB "
              f"{row['rgb']['shape']} {row['rgb']['values_apart']} values "
              f"apart, own mode {row['own_mode']['shape']} "
              f"{row['own_mode']['dtype']} {row['own_mode']['values_apart']} "
              "apart")
    read = [os.path.join(directory, n) for n in files]
    got = np.concatenate(list(native.read_batches(read, batch_size)))
    want = []
    for p in read:
        with PIL.Image.open(p) as im:
            want.append(np.asarray(im.convert("RGB")))
    want = np.stack(want)
    apart = (int(np.count_nonzero(got != want)) if got.shape == want.shape
             else -1)
    seconds = time.time() - t1
    print(f"phase 39 (g) read_batches of {len(read)} files at batch "
          f"{batch_size}: {got.shape}, {apart} values apart "
          f"({seconds:.3f} s for the step)")
    if apart:
        raise AssertionError(f"phase 39 (g): read_batches {apart} apart")
    return {"pil": PIL.__version__, "files": files,
            "read_batches_values_apart": apart, "seconds": seconds}


def add_slice16(kernels: dict, jpeg: dict) -> None:
    """Phase 39 into the kernels line: each kernel's launches there."""
    for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                      ("upconv_blur_bf16", "k1_bf16"),
                      ("upsample2x", "k3")):
        kernels[name]["jpeg_launches"] = jpeg["launches"][key]


# ---------------------------------------------------------------------------
# Phase 40: the port's notebooks (notebooks/torch/), run with no Jupyter
# ---------------------------------------------------------------------------

NOTEBOOK_DIR = os.path.join(ROOT, "notebooks", "torch")
# the stats notebooks' n_images here (theirs 8-200): 32 until phase 41 came
NOTEBOOK_IMAGES = 24
CHURCH_REAL = "model.size == 256 and len(seglabels) == NETPQC_LABELS"
# each notebook: (what shows that it took its released-checkpoint branch,
# the results it ends with, which must be finite), expressions in its
# namespace; NETPQC_LABELS is the seeded netpqc's label count
NOTEBOOKS = {
    "rewriting-interface": (
        "real_weights is True and model.size == 256 and n_z == 1000 "
        "and layernum == 8 and len(interface.canvases) == 9",
        ("gw.target_weight()", "gw.c_matrix")),
    "reflection-rule-change": (
        "layer == 'layer6' and n_z == 100 and "
        "imgs.shape == (8, 256, 256, 3)", ("imgs", "acts", "edited")),
    "stats/segmentation-stats": (
        CHURCH_REAL, ("counts", "[r['iou'] for r in records['units']]")),
    "stats/segmentation-stats-dome2tree": (
        CHURCH_REAL, ("before_counts", "after_counts", "moved")),
    "stats/segmentation-stats-comparison": (CHURCH_REAL, ("counts",)),
    "stats/dome-area-profile": (CHURCH_REAL, ("fb", "fa")),
    "stats/folder-segmentation": (CHURCH_REAL, ("counts",)),
    "stats/folder-segmentation-resumable": (CHURCH_REAL, ("counts",)),
    "stats/folder-segmentation-sharded": (CHURCH_REAL, ("counts",)),
    # the fallbacks alone bind `net`, a random BiSeNet
    "stats/face-label-stats": (
        "model.size == 1024 and 'net' not in globals()", ("fracs",)),
    "stats/attribute-comparison": (
        "'net' not in globals()", ("info", "baseline")),
    "stats/ffhq-label-stats": (
        "model.size == 1024 and os.path.isfile(ckpt)", ("freq", "probs")),
}


def run_notebook(path: str, overrides=None, ns=None) -> dict:
    """Run the code cells of the notebook at `path` in order in one
    namespace, as its kernel would, with no Jupyter; after code cell i,
    the source ``overrides[i]`` if there is one (cell 0 of a port notebook
    is its parameters cell, cell 1 its model cell).  Returns the
    namespace."""
    with open(path) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    ns = {"__name__": "__main__"} if ns is None else ns
    for i, cell in enumerate(cells):
        exec(compile("".join(cell["source"]), f"{path} [code cell {i}]",
                     "exec"), ns)
        if overrides and i in overrides:
            exec(compile(overrides[i], f"[override after code cell {i}]",
                         "exec"), ns)
    return ns


@contextlib.contextmanager
def notebook_sandbox(**env):
    """`env` in os.environ, and a fresh working directory and $TMPDIR (the
    notebooks write relative paths and ``tempfile.mkdtemp``s) within; the
    environment and the working directory restored after, both removed."""
    saved, here = dict(os.environ), os.getcwd()
    with tempfile.TemporaryDirectory(prefix="notebook_") as work:
        tmp = os.path.join(work, "tmp")
        os.makedirs(tmp)
        os.environ.update(env, TMPDIR=tmp)
        tempfile.tempdir = None             # read $TMPDIR again
        os.chdir(work)
        try:
            yield work
        finally:
            os.chdir(here)
            os.environ.clear()
            os.environ.update(saved)
            tempfile.tempdir = None


def finite_values(value) -> bool:
    """Whether every number in `value` is finite: tensors, arrays, numbers,
    data frames, and dicts, lists and tuples of them (strings aside)."""
    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        return bool(torch.isfinite(value.detach().double()).all())
    if isinstance(value, dict):
        return all(finite_values(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(finite_values(v) for v in value)
    arr = np.asarray(value)
    return arr.dtype.kind not in "fc" or bool(np.isfinite(arr).all())


def write_notebook_weights(root: str) -> dict:
    """The one checkpoint of phase 40 that no earlier phase writes: ProgGAN
    kitchen-256 (reflection's), seeded, as the published file holds it.
    Returns {file: MiB}."""
    import torch

    from rewriting_torch.models import ProgressiveGenerator
    from rewriting_torch.models.zoo import PROGGAN_ZOO

    pg = ProgressiveGenerator(resolution=256, device="cpu")
    path = os.path.join(root, PROGGAN_ZOO["kitchen"])
    torch.save(proggan_checkpoint(pg, pg.init_params(seed=5)), path)
    return {PROGGAN_ZOO["kitchen"]: os.path.getsize(path) / 2 ** 20}


def check_notebooks(weights: str, device: str = "cuda",
                    names=tuple(NOTEBOOKS)) -> dict:
    """Phase 40: each of the port's notebooks (`names` of ``NOTEBOOKS``)
    run by ``run_notebook`` on `device`, in a sandbox whose
    ``$REWRITING_TPU_WEIGHTS`` is `weights` (every checkpoint under its
    released name) and whose ``$REWRITING_TPU_MASKS`` holds the published
    edits.  The stats notebooks are cut to ``NOTEBOOK_IMAGES`` images
    (their ``n_images``), at full width; the interface and reflection run
    uncut.
    Each must take its released-checkpoint branch and end with finite
    results; the interface must launch K2; reflection's renders on the
    card must lie within ``FORWARD_RTOL`` of max of the same cells on the
    CPU.  Returns each notebook's seconds, launches and checks."""
    import gc

    import numpy as np
    import torch

    from rewriting_torch.segment import load_segmenter

    netpqc = None
    if any(CHURCH_REAL in NOTEBOOKS[name][0] for name in names):
        with weights_env(weights):
            netpqc = len(load_segmenter("netpqc", device=device)[1])
    env = {"REWRITING_TPU_WEIGHTS": weights, "REWRITING_TPU_MASKS": MASKS}
    out, renders = {}, {}
    for name in names:
        real, results = NOTEBOOKS[name]
        overrides = {0: f"device = {device!r}"}
        if name.startswith("stats/"):
            overrides[1] = f"n_images = min(n_images, {NOTEBOOK_IMAGES})"
        if name.endswith("-sharded"):    # not the host's job identity
            overrides[1] += "\nos.environ.update(RANK='0', WORLD_SIZE='1')"
        base, t1 = slice12_counts(), time.time()
        with notebook_sandbox(**env):
            ns = run_notebook(os.path.join(NOTEBOOK_DIR, f"{name}.ipynb"),
                              overrides)
            sync(device)
        seconds = time.time() - t1
        launches = {k: v - base[k] for k, v in slice12_counts().items()}
        took_real = bool(eval(real, ns, {"NETPQC_LABELS": netpqc}))
        finite = {expr: finite_values(eval(expr, ns)) for expr in results}
        size = ns.get("n_images", ns.get("n_z"))
        out[name] = {"seconds": seconds, "images": size,
                     "launches": launches, "real_branch": took_real,
                     "finite": finite}
        print(f"phase 40 notebook {name}: {seconds:.3f} s ({size} "
              f"{'images' if 'n_images' in ns else 'z'}); launches K1 "
              f"{launches['k1']}, K1 one-pass {launches['k1_bf16']}, K2 "
              f"{launches['k2']} forward and {launches['k2_backward']} "
              f"backward (general {launches['k2_general']}), K3 "
              f"{launches['k3']}; released-checkpoint branch {took_real}; "
              f"results finite {all(finite.values())} "
              f"({', '.join(finite)})", flush=True)
        if not took_real:
            raise AssertionError(f"phase 40: {name} did not take its "
                                 f"released-checkpoint branch ({real})")
        if not all(finite.values()):
            raise AssertionError(f"phase 40: {name} ended with results "
                                 f"that are not finite: {finite}")
        if launches["k2_general"]:
            raise AssertionError(f"phase 40: {name} launched the general "
                                 "blur kernel")
        if name == "reflection-rule-change":
            renders = {k: ns[k] for k in ("imgs", "edited", "unit")}
        ns.clear()
        gc.collect()
        torch.cuda.empty_cache()
    if "rewriting-interface" in out and \
            out["rewriting-interface"]["launches"]["k2"] <= 0:
        raise AssertionError("phase 40: the interface never launched K2")
    if renders:
        t1 = time.time()
        with notebook_sandbox(**env):
            cpu = run_notebook(os.path.join(
                NOTEBOOK_DIR, "reflection-rule-change.ipynb"),
                {0: "device = 'cpu'"})
        unit = renders.pop("unit")
        rel = {k: float(np.abs(v - cpu[k]).max() / np.abs(cpu[k]).max())
               for k, v in renders.items()}
        out["reflection-rule-change"]["cpu"] = {
            "seconds": time.time() - t1, "rel": rel,
            "units": [unit, cpu["unit"]]}
        print(f"phase 40 reflection on the card vs the CPU: max diff / max "
              f"|CPU| {rel} (limit {FORWARD_RTOL}); the unit ablated "
              f"{unit} / {cpu['unit']}; the CPU run {time.time() - t1:.3f} "
              "s", flush=True)
        if not max(rel.values()) <= FORWARD_RTOL:
            raise AssertionError(f"phase 40: reflection's renders on the "
                                 f"card differ from the CPU's by {rel}")
    return out


def add_slice18(kernels: dict, notebooks: dict) -> None:
    """Phase 40 into the kernels line: each kernel's launches in each
    notebook."""
    for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                      ("upconv_blur_bf16", "k1_bf16"),
                      ("upsample2x", "k3")):
        kernels[name]["notebook_launches"] = {
            nb: row["launches"][key] for nb, row in notebooks.items()}
    kernels["blur2d"]["notebook_backward_launches"] = {
        nb: row["launches"]["k2_backward"] for nb, row in notebooks.items()}


# ---------------------------------------------------------------------------
# Phase 41: the published files downloaded on a miss, from a loopback
# server laid out as the publication servers
# ---------------------------------------------------------------------------

# the fetch script's groups phase 41 serves whole (phase 25's files)
FETCH_GROUPS = ("upp", "face", "fid", "slimnet")
DOWNLOAD_NZ = 16        # z the downloaded church-256 samples on the card
DOWNLOAD_K2 = 6         # K2 launches of a church-256 forward, K1 off


def on_loopback(url: str, base: str) -> str:
    """`url` on the loopback server at `base`: its host becomes the first
    directory, so one server stands in for every publication server."""
    return base + url.split("://", 1)[1]


def closed_url() -> str:
    """A loopback URL nothing listens on: a connect there is refused at
    once."""
    return f"http://127.0.0.1:{free_port()}/"


@contextlib.contextmanager
def loopback_server(root: str):
    """An HTTP server on 127.0.0.1 serving the files under `root`, in a
    thread of this process; yields its base URL and stops on leaving."""
    import functools
    import http.server

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=root))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/"
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


@contextlib.contextmanager
def publication_urls(base: str, *modules):
    """Every URL constant of `modules` (an upper-case name whose value
    starts with http:// or https://; default the port's zoo and mask
    registry) moved onto the loopback server at `base` (``on_loopback``),
    and restored on leaving."""
    if not modules:
        from rewriting_torch.metrics import load_mask
        from rewriting_torch.models import zoo
        modules = (zoo, load_mask)
    saved = [(module, name, value) for module in modules
             for name, value in list(vars(module).items())
             if name.isupper() and isinstance(value, str)
             and value.startswith(("http://", "https://"))]
    try:
        for module, name, value in saved:
            setattr(module, name, on_loopback(value, base))
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def fetch_script():
    """``scripts/torch_fetch_weights.py`` as a module."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import torch_fetch_weights
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return torch_fetch_weights


def check_downloads(checkpoint: str, proggan_path: str, weights: str,
                    device="cuda", size=None, nz: int = DOWNLOAD_NZ) -> dict:
    """Phase 41: the zoo, the mask registry and
    ``scripts/torch_fetch_weights.py`` download what they miss from a
    loopback server (``loopback_server``) laid out as the publication
    servers' paths, holding phase 12's ``stylegan2_church.pt``
    (`checkpoint`), phase 15's ProgGAN church (`proggan_path`) saved under
    its released name in the legacy (pre-1.6) serialization, the repo's
    ``dome2tree.json``, and the files of `weights` (phase 25's seeded
    Inception, SlimNet, face parser and unified parsing) that the fetch
    script's ``FETCH_GROUPS`` name.  With empty weights and masks
    directories and the port's URL constants on the server: each download
    is the served file byte for byte and the params are the files' bit for
    bit; the downloaded church model (`size`, default its 256) samples `nz`
    z on `device` with K2 launched ``DOWNLOAD_K2`` times on the card (the
    counts set to 0 just before), K1 and K3 not at all; a file the server
    lacks raises ``FileNotFoundError`` naming its URL and leaves no
    ``.tmp``; the fetch script fetches its groups, then nothing on a
    second run.  Returns the phase's numbers; raises on any failure."""
    import io

    import torch

    from rewriting_torch.core import leaves
    from rewriting_torch.metrics import load_mask
    from rewriting_torch.models import zoo
    from rewriting_torch.ops import blur2d as kblur
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.utils.device import resolve_device
    from rewriting_torch.utils.zdataset import standard_z_sample

    device = resolve_device(device)
    script = fetch_script()
    out = {}

    def same_params(got, want, what):
        got, want = dict(leaves(got)), dict(leaves(want))
        if got.keys() != want.keys() or not all(
                torch.equal(got[k], want[k]) for k in got):
            raise AssertionError(f"phase 41: {what}'s params differ from "
                                 "the served file's")
        return len(got)

    def same_bytes(path, src, what):
        if file_bytes(path) != file_bytes(src):
            raise AssertionError(f"phase 41: {what} is not the served file "
                                 "byte for byte")
        return os.path.getsize(path)

    with tempfile.TemporaryDirectory(prefix="published_") as tmp:
        served = os.path.join(tmp, "served")

        def place(url, src=None):
            """The served path of `url`, a link to `src` if given."""
            path = os.path.join(served, url.split("://", 1)[1])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if src is not None:
                os.symlink(os.path.abspath(src), path)
            return path

        t1 = time.time()
        sg_src = place(zoo.STYLEGAN2_URL + "stylegan2_church.pt", checkpoint)
        pg_src = place(zoo.PROGGAN_URL + zoo.PROGGAN_ZOO["church"])
        torch.save(zoo.load_state(proggan_path), pg_src,
                   _use_new_zipfile_serialization=False)
        mask_src = place(load_mask.MASK_URLS + "dome2tree.json", MASK)
        with weights_env(weights):
            held = script.plan(FETCH_GROUPS)
        for url, src in held:
            place(url, src)
        out["serve_setup_s"] = time.time() - t1

        wd, md = os.path.join(tmp, "weights"), os.path.join(tmp, "masks")
        with loopback_server(served) as base, publication_urls(base), \
                environment(REWRITING_TPU_WEIGHTS=wd,
                            REWRITING_TPU_MASKS=md):
            t1 = time.time()
            model, params = zoo.load_seq_stylegan(
                "church", truncation=0.5, size=size, device=device)
            out["stylegan2_s"] = time.time() - t1
            out["stylegan2_bytes"] = same_bytes(
                os.path.join(wd, "stylegan2_church.pt"), sg_src,
                "the downloaded stylegan2_church.pt")
            out["stylegan2_tensors"] = same_params(
                params, zoo.load_seq_stylegan(
                    "church", path=checkpoint, truncation=0.5, size=size,
                    device=device)[1], "the downloaded church")
            t1 = time.time()
            pg_model, pg_params = zoo.load_proggan("church", device=device)
            out["proggan_s"] = time.time() - t1
            out["proggan_bytes"] = same_bytes(
                os.path.join(wd, zoo.PROGGAN_ZOO["church"]), pg_src,
                "the downloaded ProgGAN church")
            out["proggan_tensors"] = same_params(pg_params, zoo.load_proggan(
                "church", path=proggan_path, device=device)[1],
                "the downloaded ProgGAN church")
            mask_path = load_mask.load_mask_info("dome2tree")[0]
            out["mask_bytes"] = same_bytes(mask_path, mask_src,
                                           "the downloaded dome2tree.json")

            z = standard_z_sample(nz, model.z_dim, seed=5)
            kup.set_fused_upconv("off", min_res=256)    # the default gate
            kup.launches = kup.launches_bf16 = kup2.launches = 0
            kup2.general_launches = 0
            kblur.launches = kblur.backward_launches = 0
            kblur.general_launches = 0
            sync(device)
            t1 = time.time()
            with torch.no_grad():
                imgs = model(params, z)
            sync(device)
            out["sample_s"] = time.time() - t1
            out["launches"] = launches = slice12_counts()
            res = model.size
            if tuple(imgs.shape) != (nz, res, res, 3) or \
                    not bool(torch.isfinite(imgs).all()):
                raise AssertionError(f"phase 41: the downloaded model's "
                                     f"{tuple(imgs.shape)} samples")
            want_k2 = DOWNLOAD_K2 if device.type == "cuda" else 0
            if launches != {**dict.fromkeys(launches, 0), "k2": want_k2}:
                raise AssertionError(f"phase 41: sampling launched "
                                     f"{launches}, want K2 {want_k2} alone")

            missing = {}
            for what, call, url in (
                    ("stylegan2_bedroom.pt", lambda: zoo.load_seq_stylegan(
                        "bedroom", size=size, device=device),
                     zoo.STYLEGAN2_URL + "stylegan2_bedroom.pt"),
                    ("smile.json", lambda: load_mask.load_mask_info("smile"),
                     load_mask.MASK_URLS + "smile.json")):
                t1 = time.time()
                try:
                    call()
                except FileNotFoundError as e:
                    if url not in str(e):
                        raise AssertionError(f"phase 41: the error for "
                                             f"{what} does not name {url}: "
                                             f"{e}") from e
                else:
                    raise AssertionError(f"phase 41: {what} loaded, but the "
                                         "server lacks it")
                missing[what] = time.time() - t1
            out["missing_s"] = missing
            tmps = [name for d in (wd, md) for _, _, names in os.walk(d)
                    for name in names if name.endswith(".tmp")]
            if tmps:
                raise AssertionError(f"phase 41: downloads left {tmps}")

            runs = []
            fetched = os.path.join(tmp, "fetched")
            with publication_urls(base, script), environment(
                    REWRITING_TPU_WEIGHTS=fetched,
                    REWRITING_TPU_MASKS=os.path.join(fetched, "masks")):
                for _ in range(2):
                    printed = io.StringIO()
                    t1 = time.time()
                    with contextlib.redirect_stdout(printed):
                        rc = script.main(["--only", *FETCH_GROUPS])
                    runs.append({"rc": rc, "s": time.time() - t1, **json.loads(
                        printed.getvalue().splitlines()[-1])})
                dests = [dest for _, dest in script.plan(FETCH_GROUPS)]
            n = len(held)
            if [(r["rc"], r["fetched"], r["have"], r["failed"])
                    for r in runs] != [(0, n, 0, 0), (0, 0, n, 0)]:
                raise AssertionError(f"phase 41: the fetch script's two runs "
                                     f"{runs}, want {n} fetched, then {n} "
                                     "present")
            out["fetch_bytes"] = sum(
                same_bytes(dest, src, f"the fetched {os.path.basename(dest)}")
                for dest, (_, src) in zip(dests, held))
            out["fetch_runs"] = runs
    mib = {k: out[f"{k}_bytes"] / 2 ** 20 for k in ("stylegan2", "proggan",
                                                  "fetch")}
    print(f"phase 41: stylegan2_church.pt ({mib['stylegan2']:.1f} MiB) "
          f"downloaded and loaded in {out['stylegan2_s']:.3f} s, "
          f"ProgGAN church (legacy serialization, "
          f"{mib['proggan']:.1f} MiB) in "
          f"{out['proggan_s']:.3f} s, both bit for bit; dome2tree.json byte "
          f"for byte; {nz} z sampled in {out['sample_s']:.3f} s, launches "
          f"{out['launches']}; missing files refused by URL in "
          f"{', '.join(f'{v:.3f}' for v in missing.values())} s; the fetch "
          f"script fetched {len(held)} files ({mib['fetch']:.1f} MiB) in "
          f"{runs[0]['s']:.3f} s, then none in {runs[1]['s']:.3f} s")
    return out


def add_slice19(kernels: dict, downloads: dict) -> None:
    """Phase 41 into the kernels line: each kernel's launches there."""
    for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                      ("upconv_blur_bf16", "k1_bf16"),
                      ("upsample2x", "k3")):
        kernels[name]["download_launches"] = downloads["launches"][key]


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rewriting_torch.metrics.load_mask import load_mask_info
    from rewriting_torch.metrics.sample_edited import sample_edited
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2, params_to
    from rewriting_torch import _native_build as _build
    from rewriting_torch.ops import blur2d as kblur, make_kernel
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier
    from rewriting_torch.ops.upfirdn2d import (apply_blur, blur2d, blur_taps,
                                               upsample2d)
    from rewriting_torch.utils.renormalize import decode_png
    from rewriting_torch.utils.zdataset import standard_z_sample

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    t_all = time.time()
    apply_parity_tier()  # the plain versions run cuDNN without TF32
    kernels = {}

    # 1. device ---------------------------------------------------------------
    t0 = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(f"card: {card}")
    phase("1 device", t0)

    # 2. build and load the kernels, one nvcc each, all at once ---------------
    t0 = time.time()
    names = ("blur2d", "upconv_blur", "upconv_blur_bf16", "upsample2x")
    # phase 39's JPEG decoder: its g++ build runs beside the nvcc builds
    jpegdec_s = []

    def build_jpegdec(start=t0):
        _build.build("jpegdec")
        jpegdec_s.append(time.time() - start)

    jpegdec = threading.Thread(target=build_jpegdec)
    jpegdec.start()
    _build.build_all(names)
    kblur.library(), kup.library(), kup.library_bf16(), kup2.library()
    print(f"{', '.join(names)} built and loaded in {time.time() - t0:.3f} s")
    jpegdec.join()
    if jpegdec_s:   # else phase 39 builds it, and raises if it fails
        print(f"jpegdec (g++) built in {jpegdec_s[0]:.3f} s beside them")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
    phase("2 build", t0)

    # 3. K2 vs plain version, both kernels -----------------------------------
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    blur_kern = make_kernel(list(BLUR_TAPS))
    blur_kflip = np.ascontiguousarray(np.flip(blur_kern * 4.0, (0, 1)))
    layer_taps = blur_taps(blur_kern, (1, 1), 2)
    rank2 = rank2_kflip(np)
    max_err = gen_err = 0.0
    rows = []
    cases = [(b, c, h, h, (1, 1), blur_kflip)
             for b in (1, 10) for c, h in MAIN_SHAPES]
    cases += [(n, c, h, w, pad, blur_kflip)
              for n, c, h, w, pad in EDGE_CASES]
    cases.append((1, 64, 12, 20, (1, 1), np.ascontiguousarray(
        np.flip(make_kernel([1, 2, 1]), (0, 1)))))
    cases += [(1, 64, 12, 20, (1, 1), rank2), (10, 512, 17, 17, (1, 1), rank2),
              (2, 128, 32, 32, (2, 1), rank2)]
    for n, c, h, w, pad, kflip in cases:
        x = torch.randn((n, c, h, w), generator=gen, device="cuda")
        taps = kblur.blur_taps(kflip, pad)
        got = kblur.blur2d_cuda(x, taps, pad)
        want = kblur.blur2d_reference(x, taps, pad)
        general = general_blur(torch, kblur, x, taps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        gerr = float((general - want).abs().max())
        path = "general" if taps.factors is None else "separable"
        max_err, gen_err = max(max_err, err), max(gen_err, gerr)
        print(f"blur2d {(n, c, h, w)} k{taps.k} pad {pad} -> "
              f"{tuple(got.shape)}: {path} kernel max abs diff {err:.3e}, "
              f"general kernel {gerr:.3e}")
        if not max(err, gerr) <= BLUR_TOL:
            raise AssertionError(f"blur2d kernels differ from their plain "
                                 f"version by {err}, {gerr} > {BLUR_TOL}")
    for b in (1, 10):
        for c, h in MAIN_SHAPES:
            x = torch.randn((b, c, h, h), generator=gen, device="cuda")
            taps = kblur.blur_taps(blur_kflip, (1, 1))
            k_ms = time_ms(torch, lambda: blur2d(x, blur_kern, (1, 1), 2))
            a_ms = time_ms(torch, lambda: apply_blur(x, layer_taps))
            g_ms = time_ms(torch, lambda: general_blur(torch, kblur, x,
                                                       taps))
            p_ms = time_ms(torch, lambda: kblur.blur2d_reference(
                x, taps, (1, 1)))
            wdw = torch.from_numpy(blur_kflip).cuda().expand(
                c, 1, 4, 4).contiguous()
            l_ms = time_ms(torch, lambda: F.conv2d(x, wdw, padding=1,
                                                   groups=c))
            y_shape = kblur.output_shape(x.shape, 4, (1, 1))
            bound, by = blur_bound_ms(x.shape, y_shape, 4)
            rows.append({"shape": [b, c, h, h], "ms": k_ms,
                         "layer_ms": a_ms, "general_ms": g_ms,
                         "plain_ms": p_ms, "library_ms": l_ms,
                         "bound_ms": bound, "bound_by": by})
            print(f"blur2d time {(b, c, h, h)}: ops.upfirdn2d.blur2d "
                  f"(separable) {k_ms:.4f} ms, with the layer's taps "
                  f"{a_ms:.4f} ms, general kernel {g_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, F.conv2d depthwise {l_ms:.4f} ms"
                  f"{'' if k_ms <= l_ms else ' (slower than F.conv2d)'}, "
                  f"bound {bound:.4f} ms ({by})")
            del x
    big = torch.empty(2 ** 28, device="cuda")
    copy_ms = time_ms(torch, lambda: big.clone(), runs=10)
    print(f"device-to-device copy of 1 GiB: {copy_ms:.4f} ms = "
          f"{2 * big.numel() * 4 / (copy_ms * 1e-3) / 1e12:.3f} TB/s "
          "read+write")
    del big
    print(json.dumps({"blur2d_rows": rows}))
    head = rows[-1]  # the largest main-path shape, batch 10
    kernels["blur2d"] = {
        "name": "blur2d", "route": "cuda",
        "source": "rewriting_torch/csrc/blur2d.cu",
        "replaces": "rewriting_tpu/ops/pallas_upfirdn.py:85 "
                    "(blur2d_pallas; blur2d_pallas_bs :230)",
        "launches": None, "max_abs_err": max_err, "max_abs_diff": max_err,
        "general_max_abs_err": gen_err, "at": head["shape"],
        "ms": head["ms"], "kernel_ms": head["ms"],
        "general_ms": head["general_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "copy_tb_per_s":
            2 * 2 ** 28 * 4 / (copy_ms * 1e-3) / 1e12}
    phase("3 K2 vs plain version", t0)

    # 4. church-256 forward on the card vs the CPU --------------------------------
    t0 = time.time()
    model = SeqStyleGAN2(256, style_dim=512, n_mlp=8, channel_multiplier=2,
                         device="cuda")
    params = model.init_params(seed=0)
    z = standard_z_sample(1, 512, seed=1)
    img = model(params, z)
    torch.cuda.synchronize()
    cpu_model = SeqStyleGAN2(256, style_dim=512, n_mlp=8,
                             channel_multiplier=2, device="cpu")
    img_cpu = cpu_model(params_to(params, "cpu"), z)
    if tuple(img.shape) != (1, 256, 256, 3):
        raise AssertionError(f"forward shape {tuple(img.shape)}, want NHWC")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("forward on the card is not finite")
    rel = float((img.cpu() - img_cpu).abs().max() / img_cpu.abs().max())
    print(f"church-256 forward (NHWC), card vs CPU: max diff / max |CPU| = "
          f"{rel:.3e} (limit {FORWARD_RTOL})")
    if not rel <= FORWARD_RTOL:
        raise AssertionError(f"card forward differs from the CPU by {rel}")
    phase("4 forward card vs CPU", t0)

    # 5. the edit loop (main path of slice 1) ----------------------------------
    t0 = time.time()
    kblur.launches = kblur.general_launches = 0
    kup2.launches = kup2.general_launches = 0
    loop, rw8 = run_edit_loop(model, params, niter=2001)
    c8 = rw8.c_matrix                       # phase 33's yardstick
    w8_edit = loop.pop("edited_weight")     # phase 32's edited rewriter
    k3_on_models = [kup2.launches, kup2.general_launches]
    kernels["blur2d"]["launches"] = kblur.launches
    kernels["blur2d"]["general_launches"] = kblur.general_launches
    print(json.dumps({"edit_loop": loop}))
    print(f"blur2d launches on the edit loop: {kblur.launches}, of the "
          f"general kernel {kblur.general_launches}")
    if kblur.launches <= 0:
        raise AssertionError("the edit loop never launched the blur kernel")
    if kblur.general_launches != 0:
        raise AssertionError("the edit loop launched the general blur "
                             "kernel")
    phase("5 edit loop", t0)

    # 6. K1 vs plain version -------------------------------------------------------
    t0 = time.time()
    for line in _build.build_logs.get("upconv_blur", "").splitlines():
        if "registers" in line or "spill" in line:
            print("K1 ptxas -v:", line.strip())
    kf_std = tuple(float(v) for v in np.asarray(BLUR_TAPS) / 8.0 * 2.0)
    kf_asym = (0.1, 0.5, 0.9, 0.5)
    max_err = max_rel = 0.0
    up_rows = []
    for b in (1, 16):
        for i, h, o in UPCONV_SHAPES:
            x = torch.randn((b, i, h, h), generator=gen, device="cuda")
            wf = torch.randn((o, i, 3, 3), generator=gen,
                             device="cuda") / (3.0 * i ** 0.5)
            demod = torch.rand((b, o), generator=gen, device="cuda") + 0.5
            # one noise map for the batch (broadcast), as the sampling
            # path passes it, and one per batch index
            noise = torch.randn((1, 1, 2 * h, 2 * h), generator=gen,
                                device="cuda")
            noise_b = torch.randn((b, 1, 2 * h, 2 * h), generator=gen,
                                  device="cuda")
            bias = torch.randn((o,), generator=gen, device="cuda")
            epi = (demod, noise, bias)
            variants = [("no epilogue", kf_std, ()),
                        ("epilogue, broadcast noise", kf_std, epi),
                        ("epilogue, per-batch noise", kf_std,
                         (demod, noise_b, bias)),
                        ("asymmetric kf, epilogue", kf_asym, epi)]
            for label, kf, extra in variants:
                got = kup.upconv_blur_cuda(x, wf, kf, *extra)
                want = kup.upconv_blur_reference(x, wf, kf, *extra)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                max_err, max_rel = max(max_err, err), max(max_rel, rel)
                print(f"upconv_blur {(b, i, h, h)} -> {tuple(got.shape)} "
                      f"{label}: max abs diff {err:.3e}, {rel:.3e} of max "
                      f"|plain|")
                if tuple(got.shape) != (b, o, 2 * h, 2 * h) or \
                        not rel <= UPCONV_RTOL:
                    raise AssertionError(f"upconv_blur differs from its "
                                         f"plain version by {rel}")
            if b == 1:
                continue
            # timings at batch 16, with the epilogue as the sampling path
            # runs it; the yardsticks are held to the plain version first
            ref = kup.upconv_blur_reference(x, wf, kf_std)
            comp = composite_up_kernel(torch, wf, kf_std)
            w6 = library_up_kernel(torch, wf, kf_std)
            for name, yard in (("composite", composite_upconv(torch, x,
                                                              comp)),
                               ("library", library_upconv(torch, x, w6))):
                yrel = float((yard - ref).abs().max() / ref.abs().max())
                if not yrel <= UPCONV_RTOL:
                    raise AssertionError(f"{name} yardstick differs by "
                                         f"{yrel}")
            del yard, ref
            w_t = torch.flip(wf, (2, 3)).transpose(0, 1).contiguous()

            def seq_stages():
                y = F.conv_transpose2d(x, w_t, stride=2)
                y = blur2d(y, make_kernel(list(BLUR_TAPS)), (1, 1), 2)
                return kup._epilogue(y, *epi)

            k_ms = time_ms(torch, lambda: kup.upconv_blur_cuda(
                x, wf, kf_std, *epi))
            p_ms = time_ms(torch, lambda: kup.upconv_blur_reference(
                x, wf, kf_std, *epi))
            s_ms = time_ms(torch, seq_stages)
            c_ms = time_ms(torch, lambda: kup._epilogue(
                composite_upconv(torch, x, comp), *epi))
            l_ms = time_ms(torch, lambda: kup._epilogue(
                library_upconv(torch, x, w6), *epi))
            bound, by = upconv_bound_ms(b, i, h, o)
            bound32, _ = upconv_bound_fp32_ms(b, i, h, o)
            row = {"shape": [b, i, h, h, o], "tile": list(kup._plan(
                       b, i, h, h, o)), "ms": k_ms, "plain_ms": p_ms,
                   "seq_ms": s_ms, "composite_ms": c_ms, "library_ms": l_ms,
                   "bound_ms": bound, "bound_by": by,
                   "bound_fp32_ms": bound32}
            up_rows.append(row)
            print(f"upconv_blur time {(b, i, h, h)} -> {o}: kernel "
                  f"{k_ms:.4f} ms ({k_ms / bound:.2f}x its 3xTF32 bound "
                  f"{bound:.4f} ms, {by}; fp32 bound {bound32:.4f} ms), "
                  f"plain {p_ms:.4f} ms, seq stages (cuDNN convT + K2 + "
                  f"epilogue) {s_ms:.4f} ms, composite conv {c_ms:.4f} ms, "
                  f"library conv_transpose2d 6x6 {l_ms:.4f} ms; tile "
                  f"{row['tile']}")
            del x, wf, comp, w6, noise_b
    print(json.dumps({"upconv_rows": up_rows}))
    head = up_rows[-1]
    kernels["upconv_blur"] = {
        "name": "upconv_blur", "route": "cuda",
        "source": "rewriting_torch/csrc/upconv_blur.cu",
        "replaces": "rewriting_tpu/ops/pallas_upconv.py:232 "
                    "(upconv_blur_pallas :166)",
        "launches": None, "max_abs_err": max_err, "max_rel_err": max_rel,
        "at": head["shape"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_fp32_ms": head["bound_fp32_ms"],
        "library_ms": head["library_ms"], "seq_ms": head["seq_ms"],
        "composite_ms": head["composite_ms"]}
    phase("6 K1 vs plain version", t0)

    # 7. K2's backward vs autograd of the plain version, both kernels ---------
    t0 = time.time()
    max_err = gen_err = 0.0
    back_rows = []
    for b in (1, 10):
        for c, h in MAIN_SHAPES:
            x = torch.randn((b, c, h, h), generator=gen, device="cuda",
                            requires_grad=True)
            y = blur2d(x, blur_kern, (1, 1), 2)
            gy = torch.randn(y.shape, generator=gen, device="cuda")
            y.backward(gy)
            x2 = x.detach().requires_grad_(True)
            kblur.blur2d_reference(x2, blur_kflip, (1, 1)).backward(gy)
            adj = kblur.blur_taps(blur_kflip, (1, 1)).adjoint
            general = general_blur(torch, kblur, gy, adj)
            torch.cuda.synchronize()
            err = float((x.grad - x2.grad).abs().max())
            gerr = float((general - x2.grad).abs().max())
            max_err, gen_err = max(max_err, err), max(gen_err, gerr)
            print(f"blur2d backward {(b, c, h, h)}: separable kernel max abs "
                  f"diff {err:.3e}, general kernel {gerr:.3e}")
            if not max(err, gerr) <= BLUR_TOL:
                raise AssertionError(f"blur2d backward differs from autograd "
                                     f"of the plain version by {err}, {gerr}")
            x = x.detach()
            del x2, y
            bk_ms = time_ms(torch, lambda: kblur.blur2d_backward_cuda(
                gy, blur_kflip, (1, 1)))
            bg_ms = time_ms(torch, lambda: general_blur(torch, kblur, gy,
                                                        adj))
            bp_ms = time_ms(torch, lambda: kblur.blur2d_backward_reference(
                gy, blur_kflip, (1, 1)))
            wrot = torch.from_numpy(np.array(adj.kflip)).cuda().expand(
                c, 1, 4, 4).contiguous()
            bl_ms = time_ms(torch, lambda: F.conv2d(gy, wrot,
                                                    padding=adj.pad[0],
                                                    groups=c))
            bb, bby = blur_bound_ms(gy.shape, x.shape, 4)
            back_rows.append({"shape": list(gy.shape), "ms": bk_ms,
                              "general_ms": bg_ms, "plain_ms": bp_ms,
                              "library_ms": bl_ms, "bound_ms": bb,
                              "bound_by": bby})
            print(f"blur2d backward time {tuple(gy.shape)} -> "
                  f"{tuple(x.shape)}: separable {bk_ms:.4f} ms, general "
                  f"kernel {bg_ms:.4f} ms, plain {bp_ms:.4f} ms, F.conv2d "
                  f"depthwise {bl_ms:.4f} ms, bound {bb:.4f} ms ({bby})")
            del x, gy, wrot
    # the rank-2 blur's backward: the general kernel through the wrapper
    x = torch.randn((2, 128, 33, 33), generator=gen, device="cuda")
    gy = torch.randn((2, 128, 32, 32), generator=gen, device="cuda")
    got = kblur.blur2d_backward_cuda(gy, rank2, (1, 1))
    want = kblur.blur2d_backward_reference(gy, rank2, (1, 1))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    gen_err = max(gen_err, err)
    print(f"blur2d backward, rank-2 taps, {tuple(gy.shape)} -> "
          f"{tuple(got.shape)}: general kernel max abs diff {err:.3e}")
    if tuple(got.shape) != tuple(x.shape) or not err <= BLUR_TOL:
        raise AssertionError(f"rank-2 blur2d backward differs by {err}")
    del x, gy, got, want
    print(json.dumps({"blur2d_backward_rows": back_rows}))
    head = back_rows[-1]
    kernels["blur2d"].update({
        "backward_launches": None, "backward_max_abs_err": max_err,
        "general_max_abs_err": max(gen_err,
                                   kernels["blur2d"]["general_max_abs_err"]),
        "backward_at": head["shape"], "backward_ms": head["ms"],
        "backward_general_ms": head["general_ms"],
        "backward_plain_ms": head["plain_ms"],
        "backward_library_ms": head["library_ms"],
        "backward_bound_ms": head["bound_ms"],
        "backward_bound_by": head["bound_by"]})
    phase("7 K2 backward vs autograd", t0)

    # 8. K3 vs plain version, both kernels, then the upsample2d path --------
    t0 = time.time()
    kernels["upsample2x"] = check_upsample2x(torch, np, gen)
    phase("8 K3 vs plain version, upsample2d path", t0)

    keep = tempfile.TemporaryDirectory(prefix="chip_smoke_keep_")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    try:
        # 9. sampling: pipeline_fast (K1) vs seq, then sample_clean in the
        # three gate modes ---------------------------------------------------
        t0 = time.time()
        kup2.launches = kup2.general_launches = 0
        z16 = standard_z_sample(16, 512, seed=2)
        kup.set_fused_upconv("on", min_res=0)
        kup.launches = 0
        fast = model(params, z16)
        fast_launches = kup.launches
        seq = model(params, z16, fast=False)
        torch.cuda.synchronize()
        rel = float((fast - seq).abs().max() / seq.abs().max())
        print(f"church-256 batch 16, pipeline_fast (K1 on at every layer, "
              f"{fast_launches} launches) vs seq: max diff / max |seq| = "
              f"{rel:.3e} (limit {FORWARD_RTOL})")
        if fast_launches != 6 or not rel <= FORWARD_RTOL:
            raise AssertionError(f"pipeline_fast vs seq: {rel}, "
                                 f"{fast_launches} K1 launches")
        del fast, seq
        # (label, gate mode, min_res, K1 launches per batch of 16)
        modes = (("off", "off", 256, 0), ("on", "on", 256, 1),
                 ("on-all", "on", 0, 6))
        spans = {}
        for label, mode, min_res, _ in modes + modes[::-1]:
            kup.set_fused_upconv(mode, min_res=min_res)
            ms = time_ms(torch, lambda: model(params, z16), runs=10)
            spans.setdefault(label, []).append(ms)
            print(f"church-256 forward at batch 16, K1 {label}: {ms:.3f} ms "
                  f"stream span (CUDA events) = {16e3 / ms:.2f} images/s")
        for label, mode, min_res, _ in modes:   # warm each path at batch 16
            kup.set_fused_upconv(mode, min_res=min_res)
            check_sampling(model, params, os.path.join(tmp.name,
                                                       f"warm_{label}"),
                           16, 16)
        sampling = {}
        for run, (label, mode, min_res, per_batch) in enumerate(
                modes + modes[::-1]):
            kup.set_fused_upconv(mode, min_res=min_res)
            kup.launches = kblur.launches = kblur.general_launches = 0
            out = os.path.join(tmp.name, f"clean_{label}_{run}")
            res = check_sampling(
                model, params, out, 64, 16, counts=lambda: {
                    "k1_launches": kup.launches,
                    "k2_launches": kblur.launches,
                    "k2_general_launches": kblur.general_launches})
            sampling.setdefault(label, []).append(res)
            print(f"sample_clean 64 images at batch 16, K1 {label}: "
                  f"{res['wall_s']:.3f} s = {res['images_per_s']:.2f} "
                  f"images/s; K1 launches {res['k1_launches']}, K2 launches "
                  f"{res['k2_launches']} (general kernel "
                  f"{res['k2_general_launches']}); image 3 within "
                  f"{res['lsb']} LSB of a direct render")
            if res["k2_general_launches"] != 0:
                raise AssertionError(f"sampling, K1 {label}, launched the "
                                     "general blur kernel")
            if res["k1_launches"] != 4 * per_batch:
                raise AssertionError(f"K1 {label} launched "
                                     f"{res['k1_launches']} times on 4 "
                                     f"batches, want {4 * per_batch}")
        kup.set_fused_upconv("off", min_res=256)
        kernels["upconv_blur"]["launches"] = \
            sampling["on-all"][0]["k1_launches"]
        kernels["blur2d"]["sampling_launches"] = {
            label: runs[0]["k2_launches"] for label, runs in sampling.items()}
        print(json.dumps({"sampling": sampling, "stream_span_ms": spans}))
        phase("9 sampling path", t0)

        # 10. sample_edited: dome2tree at layer 8, then 32 samples -------------
        t0 = time.time()
        old = os.environ.get("REWRITING_TPU_MASKS")
        os.environ["REWRITING_TPU_MASKS"] = MASKS
        try:
            mask_path, dataset, layernum = load_mask_info("dome2tree")
        finally:
            if old is None:
                del os.environ["REWRITING_TPU_MASKS"]
            else:
                os.environ["REWRITING_TPU_MASKS"] = old
        with open(mask_path) as f:
            request = json.load(f)
        edited_dir = os.path.join(tmp.name, "edited")
        t1 = time.time()
        kup.set_fused_upconv("on", min_res=0)
        kblur.launches = kblur.general_launches = 0
        try:
            sample_edited(model, params, request, layernum, edited_dir,
                          n=32, batch_size=16)
        finally:
            kup.set_fused_upconv("off", min_res=256)
        print(f"blur2d launches on sample_edited: {kblur.launches}, of the "
              f"general kernel {kblur.general_launches}")
        if kblur.general_launches != 0:
            raise AssertionError("sample_edited launched the general blur "
                                 "kernel")
        torch.cuda.synchronize()
        clean_dir = os.path.join(tmp.name, "clean_on-all_2")
        changed = []
        for i in range(32):
            with open(os.path.join(edited_dir, f"{i}.png"), "rb") as f:
                a = decode_png(f.read()).astype(np.int16)
            with open(os.path.join(clean_dir, f"{i}.png"), "rb") as f:
                b = decode_png(f.read()).astype(np.int16)
            changed.append(float(np.abs(a - b).mean()))
        print(f"sample_edited {dataset} layer {layernum}: 32 images in "
              f"{time.time() - t1:.3f} s; mean |edited - clean| per image "
              f"{min(changed):.3f} .. {max(changed):.3f} (of 255)")
        if not max(changed) > 0:
            raise AssertionError("the edited samples equal the clean ones")
        # phase 24's damage metric compares these clean and edited PNGs
        for name, src in (("clean", clean_dir), ("edited", edited_dir)):
            shutil.copytree(src, os.path.join(keep.name, name))
        phase("10 sample_edited", t0)
    finally:
        tmp.cleanup()

    # 11. an edit at the upsampling layer 7: K2's backward ----------------------
    t0 = time.time()
    kblur.launches = kblur.backward_launches = kblur.general_launches = 0
    loop7, rw7 = run_edit_loop(model, params, niter=201, layernum=7,
                               nrender=4)
    loop7.pop("edited_weight")
    kernels["blur2d"]["backward_launches"] = kblur.backward_launches
    kernels["blur2d"]["general_launches"] += kblur.general_launches
    print(json.dumps({"edit_layer7": loop7}))
    print(f"blur2d launches on the layer-7 edit: {kblur.launches} forward, "
          f"{kblur.backward_launches} backward, of the general kernel "
          f"{kblur.general_launches}")
    if kblur.backward_launches <= 0:
        raise AssertionError("the layer-7 solve never launched K2's "
                             "backward")
    if kblur.general_launches != 0:
        raise AssertionError("the layer-7 edit launched the general blur "
                             "kernel")
    # K3 has no model path: nothing of phases 5 and 9-11 launches it
    k3_on_models[0] += kup2.launches
    k3_on_models[1] += kup2.general_launches
    kernels["upsample2x"]["model_path_launches"] = k3_on_models
    print(f"upsample2x launches on the edit loop, sampling, sample_edited "
          f"and the layer-7 edit: {k3_on_models[0]}, of the general kernel "
          f"{k3_on_models[1]}")
    if k3_on_models[1] != 0:
        raise AssertionError("a model path launched K3's general kernel")
    phase("11 edit at layer 7", t0)

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_work_")
    try:
        # 12. a checkpoint file, then the samplers' command lines on it ------
        t0 = time.time()
        kup2.launches = kup2.general_launches = 0
        cli = check_checkpoint_and_command_lines(model, params, work.name)
        for run in (cli["sample_cli"], cli["sample_edited_cli"]):
            k3_on_models[0] += run["k3"]
        kernels["blur2d"]["command_line_launches"] = {
            "sample": cli["sample_cli"]["k2"],
            "sample_edited": cli["sample_edited_cli"]["k2"],
            "sample_edited_backward": cli["sample_edited_cli"]["k2_backward"]}
        print(json.dumps({"command_lines": cli}))
        phase("12 checkpoint and command lines", t0)

        # 13. the server's solves at layer 7, on phase 11's rewriter ---------
        t0 = time.time()
        solves = check_server_solves(rw7, kblur, loop7)
        kernels["blur2d"]["server_solve_launches"] = {
            name: [solves[name]["k2"], solves[name]["k2_backward"]]
            for name in ("linear_insert", "fast_linear_insert")}
        print(json.dumps({"server_solves": solves}))
        phase("13 server solves at layer 7", t0)

        # 14. erase, keys and renders at layer 8 ------------------------------
        t0 = time.time()
        erase = check_erase_keys_renders(model, params, kblur)
        kernels["blur2d"]["erase_render_launches"] = erase["k2"]
        k3_on_models[0] += kup2.launches
        k3_on_models[1] += kup2.general_launches
        print(json.dumps({"erase_keys_renders": erase}))
        print(f"upsample2x launches on phases 12-14: {kup2.launches} in this "
              f"process, of the general kernel {kup2.general_launches}")
        if kup2.general_launches != 0:
            raise AssertionError("phases 12-14 launched K3's general kernel")
        phase("14 erase, keys and renders", t0)

        # 15. ProgGAN church-256: checkpoint, forward, edit (no kernel) -------
        t0 = time.time()

        def counts():
            return {"k1": kup.launches, "k2": kblur.launches,
                    "k2_backward": kblur.backward_launches,
                    "k2_general": kblur.general_launches,
                    "k3": kup2.launches, "k3_general": kup2.general_launches}
        kup.launches = kup2.launches = kup2.general_launches = 0
        kblur.launches = kblur.backward_launches = 0
        kblur.general_launches = 0
        from rewriting_torch.models.proggan import ProgressiveGenerator
        pg = check_proggan(ProgressiveGenerator(resolution=256,
                                                device="cuda"),
                           work.name, counts)
        for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                          ("upsample2x", "k3")):
            kernels[name]["proggan_launches"] = pg["launches"][key]
        print(json.dumps({"proggan": pg}))
        phase("15 ProgGAN church-256 checkpoint and edit", t0)

        # 16. four edits as one batch at layer 7, previews, paramio ----------
        t0 = time.time()
        batch = check_batched_edits(rw7, kblur, work.name,
                                    steps=BATCH_STEPS)
        r2m7 = moment_cache(rw7)                # phase 33's edits read it
        kernels["blur2d"]["batch_solve_launches"] = batch["k2_loop"]
        kernels["blur2d"]["preview_launches"] = {
            "batched": batch["preview_k2"][0],
            "one_edit_at_a_time": batch["preview_k2"][1]}
        print(json.dumps({"batched_edits": batch}))
        phase("16 batched edits at layer 7", t0)

        # 17. the instrumented forward -------------------------------------
        t0 = time.time()
        instrumented = check_instrumented(model, params, rw8, kblur)
        kernels["blur2d"]["instrumented_forward_launches"] = \
            instrumented["k2_per_forward"]
        print(json.dumps({"instrumented": instrumented}))
        phase("17 instrumented forward", t0)

        # 18. the watermark erase, in this process and as a command line ----
        t0 = time.time()
        mark = check_watermark(model, with_latent_avg(model, params),
                               work.name, kblur)
        mark["cli"] = check_watermark_command_line(work.name)
        kernels["blur2d"]["watermark_launches"] = {
            "erase": mark["k2"], "command_line": mark["cli"]["k2"],
            "command_line_backward": mark["cli"]["k2_backward"]}
        k3_on_models[0] += kup2.launches + mark["cli"]["k3"]
        if kup2.general_launches != 0:
            raise AssertionError("phases 15-18 launched K3's general kernel")
        print(json.dumps({"watermark": mark}))
        phase("18 watermark erase", t0)

        # 19-24: slice 8's paths; K1 and K3 must stay at 0 throughout.
        # Each phase's launches are the change in the counts across it.
        def since(base):
            now = counts()
            return {k: now[k] - base[k] for k in now}
        slice8 = {}

        # 19. the solves repeat bit for bit (cuDNN's deterministic
        # algorithms), on phase 11's rewriter, then phase 5's --------------
        t0 = time.time()
        base = counts()
        repeat = {"layer7": check_determinism(rw7, fast_steps=BATCH_STEPS),
                  "layer8": check_determinism(rw8, fast_steps=201)}
        del rw7
        slice8["determinism"] = since(base)
        print(json.dumps({"determinism": repeat}))
        phase("19 solves repeat bit for bit", t0)

        # 20. the quantile sketch on the card against the CPU ----------------
        t0 = time.time()
        base = counts()
        sketch = check_quantile_sketch()
        slice8["quantile_sketch"] = since(base)
        print(json.dumps({"quantile_sketch": sketch}))
        phase("20 quantile sketch", t0)

        # 21. the watermark erase by GANdissect's units ----------------------
        t0 = time.time()
        base = counts()
        gd = check_gandissect_erase(model, with_latent_avg(model, params),
                                    work.name, kblur)
        slice8["gandissect_erase"] = since(base)
        print(json.dumps({"gandissect_erase": gd}))
        phase("21 gandissect erase", t0)

        # 22. Search: ranking_for_key and the outlined renders ---------------
        t0 = time.time()
        base = counts()
        search = check_search(rw8, kblur)
        slice8["search"] = since(base)
        print(json.dumps({"search": search}))
        phase("22 search", t0)

        # 23. dissection of ProgGAN church-256 layer4 (no kernel) -----------
        t0 = time.time()
        base = counts()
        dis = check_dissect(pg["path"], work.name, lambda: since(base),
                            sample_size=DISSECT_SIZE)
        slice8["dissect"] = dis["launches"]
        print(json.dumps({"dissect": dis}))
        phase("23 dissect", t0)

        # 24. the overfit baseline and the damage metric --------------------
        t0 = time.time()
        base = counts()
        overfit = check_overfit(rw8, kblur)
        del rw8
        overfit["damage"] = check_damage_metric(
            os.path.join(keep.name, "clean"),
            os.path.join(keep.name, "edited"), work.name)
        slice8["overfit"] = since(base)
        print(json.dumps({"overfit": overfit}))
        phase("24 overfit baseline and damage metric", t0)

        # 25-28: slice 9's paths, on seeded weights written under the
        # released file names and read through $REWRITING_TPU_WEIGHTS
        t0 = time.time()
        weights9 = os.path.join(work.name, "weights9")
        files = write_seeded_weights(weights9, upp_labeldata())
        print(f"seeded slice-9 weights written in {time.time() - t0:.3f} s: "
              + ", ".join(f"{k} {v:.1f} MiB" for k, v in files.items()))
        clean_dir = os.path.join(keep.name, "clean")
        slice9 = {}

        def with_cli(base, *runs):
            """The launches since `base` plus those of command lines."""
            now = since(base)
            return {k: v + sum(r.get(k, 0) for r in runs)
                    for k, v in now.items()}
        with weights_env(weights9):
            base = counts()
            fidres = check_fid(model, params, clean_dir,
                               os.path.join(keep.name, "edited"), work.name,
                               weights9, counts)
            slice9["fid"] = with_cli(base, fidres["cli"],
                                     fidres["compare_cli"])
            print(json.dumps({"fid": fidres}))
            phase("25 FID", t0)

            t0 = time.time()
            base = counts()
            segres = check_segmenters(clean_dir)
            slice9["segmenters"] = since(base)
            print(json.dumps({"segmenters": segres}))
            phase("26 segmenters", t0)

            t0 = time.time()
            base = counts()
            smiles = check_smiles(clean_dir)
            slice9["smiles"] = since(base)
            print(json.dumps({"smiles": smiles}))
            phase("27 smile count", t0)

            t0 = time.time()
            base = counts()
            quick = check_quickdissect(pg["path"], work.name, weights9)
            slice9["quickdissect"] = with_cli(base, quick["launches"])
            print(json.dumps({"quickdissect": quick}))
            phase("28 quickdissect from files", t0)
        # only FID's model statistics sample a generator (K2)
        stray = {name: {k: v for k, v in n.items()
                        if v and not (name == "fid" and k == "k2")}
                 for name, n in slice9.items()}
        print(f"launches on phases 25-28 (command lines included): {slice9}")
        if any(stray.values()):
            raise AssertionError(f"phases 25-28 launched {stray}")
        kernels["blur2d"]["slice9_launches"] = {
            name: n["k2"] for name, n in slice9.items()}
        kernels["upconv_blur"]["slice9_launches"] = {
            name: n["k1"] for name, n in slice9.items()}
        kernels["upsample2x"]["slice9_launches"] = {
            name: n["k3"] + n["k3_general"] for name, n in slice9.items()}

        k13 = {name: {key: n[key] for key in ("k1", "k3", "k3_general")}
               for name, n in slice8.items()}
        print(f"K1 and K3 launches on phases 19-24: {k13}")
        if any(v for n in k13.values() for v in n.values()):
            raise AssertionError(f"phases 19-24 launched K1 or K3: {k13}")
        kernels["blur2d"]["slice8_launches"] = {
            "gandissect_erase": gd["k2"], "search": search["k2_rank"],
            "search_render": search["k2_render"],
            "dissect_proggan": slice8["dissect"]["k2"],
            "overfit_per_step": overfit["plain"]["k2_per_step"]}
        kernels["upconv_blur"]["slice8_launches"] = {
            name: n["k1"] for name, n in k13.items()}
        kernels["upsample2x"]["slice8_launches"] = {
            name: n["k3"] + n["k3_general"] for name, n in k13.items()}

        # 29-32: slice 10's paths, on phase 12's checkpoint beside the
        # seeded slice-9 weights; K1's gate off (the default)
        os.symlink(os.path.join(work.name, "weights", "stylegan2_church.pt"),
                   os.path.join(weights9, "stylegan2_church.pt"))
        results, slice10 = run_slice10(
            model, params, w8_edit, clean_dir,
            os.path.join(keep.name, "edited"), work.name, weights9, counts)
        server, pipes, patches = (results["server"], results["pipelines"],
                                  results["patch_fid"])
        print(f"launches on phases 29-32 (in this process): {slice10}")
        stray = {name: {k: v for k, v in n.items() if v and k not in
                        ("k2", "k2_backward")}
                 for name, n in slice10.items()}
        if any(stray.values()):
            raise AssertionError(f"phases 29-32 launched {stray}")
        kernels["blur2d"]["slice10_launches"] = {
            "preview": server["preview_launches"]["k2"],
            "served_edit": [server["edit_launches"]["k2"],
                            server["edit_launches"]["k2_backward"]],
            "ui_canvases": server["ui"]["canvas_launches"]["k2"],
            "fused_pass": pipes["fused_launches"]["k2"],
            "patch_fid": patches["sweep_launches"]["k2"],
            **{name: n["k2"] for name, n in slice10.items()}}
        for name, key in (("upconv_blur", "k1"), ("upsample2x", "k3")):
            kernels[name]["slice10_launches"] = {
                phase_name: n[key] for phase_name, n in slice10.items()}

        # 33. the multi-device paths: a 1-rank NCCL job, then 2 and 4 ranks
        # sharing the card over gloo, each a child job --------------------
        t0 = time.time()
        multi = check_multi_device(model, params, clean_dir, c8, r2m7,
                                   batch["final_losses"], work.name,
                                   steps=BATCH_STEPS)
        for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                          ("upsample2x", "k3")):
            kernels[name]["slice11_launches"] = {
                job: {check: [n[key] for n in
                              (out[check] for out in res["ranks"])]
                      for check in res["ranks"][0]}
                for job, res in multi.items()}
        kernels["blur2d"]["slice11_backward_launches"] = {
            job: [out["edits"]["k2_backward"] for out in res["ranks"]]
            for job, res in multi.items() if "edits" in res["ranks"][0]}
        print(json.dumps({"multi_device": multi}))
        phase("33 multi-device paths", t0)

        # 34-36: slice 12's paths, the 1024 models on seeded weights
        # written under the released names, and the segmenters no caller
        # sets, over phase 9's PNGs
        t0 = time.time()
        files = write_seeded_weights(weights9, {}, which=("faces",
                                                          "celebhq"))
        print(f"seeded 1024 checkpoints written in {time.time() - t0:.3f} "
              "s: " + ", ".join(f"{k} {v:.1f} MiB" for k, v in
                                files.items()))
        slice12, launches12 = run_slice12(weights9, clean_dir,
                                          slice12_counts)
        print(f"launches on phases 34-36: {launches12}")
        add_slice12(kernels, slice12, launches12)

        # 37. the NBB copy-paste baseline at church-256, on two of phase
        # 9's PNGs; no kernel on this path -------------------------------
        t0 = time.time()
        base = {**counts(), **slice12_counts()}
        nbbres = check_nbb(clean_dir)
        launches37 = {k: v - base[k]
                      for k, v in {**counts(), **slice12_counts()}.items()}
        print(f"launches on phase 37: {launches37}")
        if any(launches37.values()):
            raise AssertionError(f"phase 37 launched {launches37}")
        for name, key in (("blur2d", "k2"), ("upconv_blur", "k1"),
                          ("upconv_blur_bf16", "k1_bf16"),
                          ("upsample2x", "k3")):
            kernels[name]["nbb_launches"] = launches37[key]
        print(json.dumps({"nbb": nbbres}))
        phase("37 NBB copy-paste baseline at church-256", t0)

        # 38. the sharded samplers at faces-1024: K1 on the bands, int8 on
        # dp, tp and the bands, 4 ranks sharing the card ------------------
        t0 = time.time()
        sharded = check_sharded_faces(weights9)
        add_slice15(kernels, sharded)
        print(json.dumps({"sharded_faces": sharded}))
        phase("38 sharded paths at faces-1024", t0)

        # 39. JPEG reading: the fixtures against PIL's pixels, decode
        # images/s, FID statistics and real samples of JPEG directories
        # against PNG ones; no kernel on this path ------------------------
        t0 = time.time()
        with weights_env(weights9):
            jpeg = check_jpeg(work.name, slice12_counts,
                              build_s=jpegdec_s[0] if jpegdec_s else None)
        add_slice16(kernels, jpeg)
        print(json.dumps({"jpeg": jpeg}))
        phase("39 JPEG reading", t0)

        # 40. the port's twelve notebooks, on the checkpoints of phases 12,
        # 25 and 34 and a ProgGAN kitchen file; K2 on the interface's path
        t0 = time.time()
        files = write_notebook_weights(weights9)
        print("seeded ProgGAN kitchen checkpoint written: " + ", ".join(
            f"{k} {v:.1f} MiB" for k, v in files.items()))
        notebooks = check_notebooks(weights9)
        add_slice18(kernels, notebooks)
        print(json.dumps({"notebooks": notebooks}))
        phase("40 notebooks", t0)

        # 41. the published files downloaded on a miss from a loopback
        # server: phases 12's, 15's and 25's files; K2 on the downloaded
        # church-256's samples
        t0 = time.time()
        downloads = check_downloads(
            os.path.join(work.name, "weights", "stylegan2_church.pt"),
            pg["path"], weights9)
        add_slice19(kernels, downloads)
        print(json.dumps({"downloads": downloads}))
        phase("41 downloads on a miss", t0)
    finally:
        work.cleanup()
        keep.cleanup()

    # the kernels line, then the result ---------------------------------------------
    print(json.dumps({"kernels": [kernels[k] for k in
                                  ("blur2d", "upconv_blur",
                                   "upconv_blur_bf16", "upsample2x")]}))
    print(f"card: {card}")
    phase("all", t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
