#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``rewriting_torch/csrc`` with nvcc
(one process per source, all at once), holds each kernel against its
plain PyTorch version on the card at the shapes its path gives it, compares
a full-width church-256 forward on the card with the same forward on the
CPU, and drives the port's paths end to end, each with the launch counts
set to 0 just before it and read just after:

- the edit loop of the paper: the 1000-z key statistics at layer 8, the
  ``dome2tree`` edit request (rank 1, 2001 Adam steps), edited renders,
  revert (the FIR blur K2);
- the 2x upsample op ``upsample2d`` on wide maps (K3);
- church-256 sampling through ``sample_clean`` and ``pipeline_fast`` in
  the three modes of K1's gate (off, the default; on, which takes the
  256-pixel layer; on with ``min_res=0``, all six up-conv layers), and the
  port's PNG files decoded against a direct render;
- ``sample_edited``: the dome2tree edit, then 32 samples of the edited
  model;
- an edit at the upsampling layer 7, whose solve runs K2's backward.

Weights are random, drawn from a seed.  Every phase prints one line with
its elapsed seconds; any failure raises and exits non-zero.  The
second-to-last line is a JSON object with each kernel's launches on its
path, its error against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.

Without CUDA, or without the ``rewriting_torch`` package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# (N, C, H, W, taps) of K3: the wide maps upsample2d sends it, and edges
UP2_SHAPES = ((16, 512, 32, 32), (16, 256, 64, 64), (16, 128, 128, 128))
UP2_EDGES = ((2, 64, 33, 17, (1, 3, 3, 1)), (1, 64, 5, 7, (1, 2, 1)),
             (1, 72, 9, 9, (1, 1)), (1, 64, 16, 16, (1, 2, 3, 1)))


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.time() - t0:.3f} s", flush=True)


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


def _upconv_counts(b, i, h, o):
    """K1 with its epilogue: (bytes, MACs of the conv, outputs).  x, the
    weights, demod, noise and bias are read once, the output written once;
    the conv does 9 MACs per (input pixel, I, O)."""
    outputs = b * o * 4 * h * h
    nbytes = 4.0 * (b * i * h * h + 9 * i * o + b * o + 4 * h * h + o
                    + outputs)
    return nbytes, 9.0 * i * o * h * h * b, outputs


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


def run_edit_loop(model, params, niter: int, layernum: int = 8,
                  nrender: int = 8) -> dict:
    """The paper's edit loop through the port's entry points: statistics
    at `layernum`, the dome2tree request (rank 1, `niter` Adam steps),
    `nrender` edited renders, revert, renders again.  Checks the loss fell,
    the weight change lies in span(D) and every output is finite."""
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
    losses = rw.apply_edit(request, rank=1, niter=niter, piter=10, lr=0.05)
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
          f"{solve_s:.3f} s; loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    print(f"render {nrender} samples: {render_s:.3f} s; mean |edited - "
          f"reverted| = {change:.6f}")
    print(f"weight change outside span(D): {span_rel:.3e} of its norm "
          f"(limit {SPAN_TOL})")
    if not losses[-1] < losses[0]:
        raise AssertionError("the solve did not lower the loss")
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
            "render_s": render_s, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]), "span_rel": span_rel}


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


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rewriting_torch.metrics.load_mask import load_mask_info
    from rewriting_torch.metrics.sample_edited import sample_edited
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2, params_to
    from rewriting_torch.ops import _build, blur2d as kblur, make_kernel
    from rewriting_torch.ops import upconv_blur as kup
    from rewriting_torch.ops import upsample2x as kup2
    from rewriting_torch.ops.precision import apply_parity_tier
    from rewriting_torch.ops.upfirdn2d import blur2d, upsample2d
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
    names = ("blur2d", "upconv_blur", "upsample2x")
    _build.build_all(names)
    kblur.library(), kup.library(), kup2.library()
    print(f"{', '.join(names)} built and loaded in {time.time() - t0:.3f} s")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
    phase("2 build", t0)

    # 3. K2 vs plain version -----------------------------------------------------
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    blur_kflip = np.ascontiguousarray(
        np.flip(make_kernel(list(BLUR_TAPS)) * 4.0, (0, 1)))
    max_err = 0.0
    rows = []
    cases = [(b, c, h, h, (1, 1), blur_kflip)
             for b in (1, 10) for c, h in MAIN_SHAPES]
    cases += [(n, c, h, w, pad, blur_kflip)
              for n, c, h, w, pad in EDGE_CASES]
    cases.append((1, 64, 12, 20, (1, 1), np.ascontiguousarray(
        np.flip(make_kernel([1, 2, 1]), (0, 1)))))
    for n, c, h, w, pad, kflip in cases:
        x = torch.randn((n, c, h, w), generator=gen, device="cuda")
        got = kblur.blur2d_cuda(x, kflip, pad)
        want = kblur.blur2d_reference(x, kflip, pad)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        print(f"blur2d {(n, c, h, w)} k{kflip.shape[0]} pad {pad} -> "
              f"{tuple(got.shape)}: max abs diff {err:.3e}")
        if not err <= BLUR_TOL:
            raise AssertionError(f"blur2d kernel differs from its plain "
                                 f"version by {err} > {BLUR_TOL}")
    for b in (1, 10):
        for c, h in MAIN_SHAPES:
            x = torch.randn((b, c, h, h), generator=gen, device="cuda")
            k_ms = time_ms(torch, lambda: kblur.blur2d_cuda(
                x, blur_kflip, (1, 1)))
            p_ms = time_ms(torch, lambda: kblur.blur2d_reference(
                x, blur_kflip, (1, 1)))
            wdw = torch.from_numpy(blur_kflip).cuda().expand(
                c, 1, 4, 4).contiguous()
            l_ms = time_ms(torch, lambda: F.conv2d(x, wdw, padding=1,
                                                   groups=c))
            y_shape = kblur.output_shape(x.shape, 4, (1, 1))
            bound, by = blur_bound_ms(x.shape, y_shape, 4)
            rows.append({"shape": [b, c, h, h], "ms": k_ms, "plain_ms": p_ms,
                         "library_ms": l_ms, "bound_ms": bound,
                         "bound_by": by})
            print(f"blur2d time {(b, c, h, h)}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, F.conv2d depthwise {l_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by})")
            del x
    big = torch.empty(2 ** 28, device="cuda")
    copy_ms = time_ms(torch, lambda: big.clone(), runs=10)
    print(f"device-to-device copy of 1 GiB: {copy_ms:.4f} ms = "
          f"{2 * big.numel() * 4 / (copy_ms * 1e-3) / 1e12:.3f} TB/s "
          "read+write")
    del big
    head = rows[-1]  # the largest main-path shape, batch 10
    kernels["blur2d"] = {
        "name": "blur2d", "route": "cuda",
        "source": "rewriting_torch/csrc/blur2d.cu",
        "replaces": "rewriting_tpu/ops/pallas_upfirdn.py:85 "
                    "(blur2d_pallas; blur2d_pallas_bs :230)",
        "launches": None, "max_abs_err": max_err, "max_abs_diff": max_err,
        "at": head["shape"], "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]}
    phase("3 kernel vs plain version", t0)

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
    kblur.launches = 0
    loop = run_edit_loop(model, params, niter=2001)
    kernels["blur2d"]["launches"] = kblur.launches
    print(json.dumps({"edit_loop": loop}))
    print(f"blur2d launches on the edit loop: {kblur.launches}")
    if kblur.launches <= 0:
        raise AssertionError("the edit loop never launched the blur kernel")
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

    # 7. K2's backward vs autograd of the plain version -----------------------------
    t0 = time.time()
    max_err = 0.0
    for b in (1, 10):
        for c, h in MAIN_SHAPES:
            x = torch.randn((b, c, h, h), generator=gen, device="cuda",
                            requires_grad=True)
            y = blur2d(x, make_kernel(list(BLUR_TAPS)), (1, 1), 2)
            gy = torch.randn(y.shape, generator=gen, device="cuda")
            y.backward(gy)
            x2 = x.detach().requires_grad_(True)
            kblur.blur2d_reference(x2, blur_kflip, (1, 1)).backward(gy)
            torch.cuda.synchronize()
            err = float((x.grad - x2.grad).abs().max())
            max_err = max(max_err, err)
            print(f"blur2d backward {(b, c, h, h)}: max abs diff {err:.3e}")
            if not err <= BLUR_TOL:
                raise AssertionError(f"blur2d backward differs from autograd "
                                     f"of the plain version by {err}")
    taps, apad = kblur.adjoint(blur_kflip, (1, 1))
    wrot = torch.from_numpy(taps).cuda().expand(c, 1, 4, 4).contiguous()
    bk_ms = time_ms(torch, lambda: kblur.blur2d_backward_cuda(
        gy, blur_kflip, (1, 1)))
    bp_ms = time_ms(torch, lambda: kblur.blur2d_backward_reference(
        gy, blur_kflip, (1, 1)))
    bl_ms = time_ms(torch, lambda: F.conv2d(gy, wrot, padding=apad[0],
                                            groups=c))
    bb, bby = blur_bound_ms(gy.shape, x.shape, 4)
    print(f"blur2d backward time {tuple(gy.shape)} -> {tuple(x.shape)}: "
          f"kernel {bk_ms:.4f} ms, plain {bp_ms:.4f} ms, F.conv2d depthwise "
          f"{bl_ms:.4f} ms, bound {bb:.4f} ms ({bby})")
    kernels["blur2d"].update({
        "backward_launches": None, "backward_max_abs_err": max_err,
        "backward_ms": bk_ms, "backward_plain_ms": bp_ms,
        "backward_library_ms": bl_ms, "backward_bound_ms": bb,
        "backward_bound_by": bby})
    del x, x2, y, gy
    phase("7 K2 backward vs autograd", t0)

    # 8. K3 vs plain version, then the upsample2d path -------------------------------
    t0 = time.time()
    max_err = 0.0
    up2_rows = []
    for n, c, h, w, taps in [s + ((1, 3, 3, 1),) for s in UP2_SHAPES] + \
            list(UP2_EDGES):
        kern = make_kernel(list(taps)) * 4.0
        k = kern.shape[0]
        p = k - 2
        pad = ((p + 1) // 2 + 1, p // 2)
        kflip = np.ascontiguousarray(np.flip(kern, (0, 1)))
        x = torch.randn((n, c, h, w), generator=gen, device="cuda")
        got = kup2.upsample2x_cuda(x, kflip, pad)
        want = kup2.upsample2x_reference(x, kflip, pad)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        print(f"upsample2x {(n, c, h, w)} k{k} pad {pad} -> "
              f"{tuple(got.shape)}: max abs diff {err:.3e}")
        if tuple(got.shape) != (n, c, 2 * h, 2 * w) or not err <= UP2_TOL:
            raise AssertionError(f"upsample2x differs from its plain "
                                 f"version by {err}")
        if (n, c, h, w) in UP2_SHAPES:
            lib = up2_library(torch, x, kern)
            lerr = float((lib - want).abs().max())
            if not lerr <= UP2_TOL:
                raise AssertionError(f"conv_transpose2d yardstick differs "
                                     f"by {lerr}")
            k_ms = time_ms(torch, lambda: kup2.upsample2x_cuda(x, kflip, pad))
            p_ms = time_ms(torch, lambda: kup2.upsample2x_reference(
                x, kflip, pad))
            l_ms = time_ms(torch, lambda: up2_library(torch, x, kern))
            bound, by = bound_ms(4.0 * 5 * x.numel(), 2.0 * 4 * 4 * x.numel())
            up2_rows.append({"shape": [n, c, h, w], "ms": k_ms,
                             "plain_ms": p_ms, "library_ms": l_ms,
                             "bound_ms": bound, "bound_by": by})
            print(f"upsample2x time {(n, c, h, w)}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, conv_transpose2d depthwise "
                  f"{l_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            del lib
        del x, got, want
    # the path: the public op upsample2d on the wide maps
    maps = [torch.randn(s, generator=gen, device="cuda") for s in UP2_SHAPES]
    kup2.launches = 0
    outs = [upsample2d(m, make_kernel(list(BLUR_TAPS))) for m in maps]
    up2_launches = kup2.launches
    torch.cuda.synchronize()
    print(f"upsample2x launches on ops.upsample2d over {len(maps)} wide "
          f"maps: {up2_launches}")
    if up2_launches != len(maps):
        raise AssertionError("upsample2d did not launch K3 on wide maps")
    del maps, outs
    head = up2_rows[-1]
    kernels["upsample2x"] = {
        "name": "upsample2x", "route": "cuda",
        "source": "rewriting_torch/csrc/upsample2x.cu",
        "replaces": "rewriting_tpu/ops/pallas_upfirdn.py:162 "
                    "(upsample2x_pallas :150)",
        "path": "rewriting_torch.ops.upfirdn2d.upsample2d on maps of >= 64 "
                "channels", "launches": up2_launches, "max_abs_err": max_err,
        "at": head["shape"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}
    phase("8 K3 vs plain version, upsample2d path", t0)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    try:
        # 9. sampling: pipeline_fast (K1) vs seq, then sample_clean in the
        # three gate modes ---------------------------------------------------
        t0 = time.time()
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
            kup.launches = kblur.launches = 0
            out = os.path.join(tmp.name, f"clean_{label}_{run}")
            res = check_sampling(
                model, params, out, 64, 16, counts=lambda: {
                    "k1_launches": kup.launches,
                    "k2_launches": kblur.launches})
            sampling.setdefault(label, []).append(res)
            print(f"sample_clean 64 images at batch 16, K1 {label}: "
                  f"{res['wall_s']:.3f} s = {res['images_per_s']:.2f} "
                  f"images/s; K1 launches {res['k1_launches']}, K2 launches "
                  f"{res['k2_launches']}; image 3 within {res['lsb']} LSB of "
                  "a direct render")
            if res["k1_launches"] != 4 * per_batch:
                raise AssertionError(f"K1 {label} launched "
                                     f"{res['k1_launches']} times on 4 "
                                     f"batches, want {4 * per_batch}")
        kup.set_fused_upconv("off", min_res=256)
        kernels["upconv_blur"]["launches"] = \
            sampling["on-all"][0]["k1_launches"]
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
        try:
            sample_edited(model, params, request, layernum, edited_dir,
                          n=32, batch_size=16)
        finally:
            kup.set_fused_upconv("off", min_res=256)
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
        phase("10 sample_edited", t0)
    finally:
        tmp.cleanup()

    # 11. an edit at the upsampling layer 7: K2's backward ----------------------
    t0 = time.time()
    kblur.backward_launches = 0
    loop7 = run_edit_loop(model, params, niter=201, layernum=7, nrender=4)
    kernels["blur2d"]["backward_launches"] = kblur.backward_launches
    print(json.dumps({"edit_layer7": loop7}))
    print(f"blur2d backward launches on the layer-7 edit: "
          f"{kblur.backward_launches}")
    if kblur.backward_launches <= 0:
        raise AssertionError("the layer-7 solve never launched K2's "
                             "backward")
    phase("11 edit at layer 7", t0)

    # 12. kernels line, 13. result -------------------------------------------------
    print(json.dumps({"kernels": [kernels[k] for k in
                                  ("blur2d", "upconv_blur", "upsample2x")]}))
    print(f"card: {card}")
    phase("all", t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
