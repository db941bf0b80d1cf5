#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``rewriting_torch/csrc`` with nvcc at first
use, holds each kernel against its plain PyTorch version on the card,
compares a full-width church-256 forward on the card with the same
forward on the CPU, and drives the edit loop of the paper end to end: the
1000-z key statistics, the ``dome2tree`` edit request (rank 1, 2001 Adam
steps) and edited renders, then revert.  Weights are random, drawn from a
seed.  Every phase prints one line with its elapsed seconds; any failure
raises and exits non-zero.  The second-to-last line is a JSON object with
each kernel's launches on the edit loop, its error against the plain
version and its times; the last line is
``{"ok": true, "device": {...}}``.

Without CUDA, or without the ``rewriting_torch`` package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MASK = os.path.join(ROOT, "notebooks", "masks", "stylegan", "church",
                    "dome2tree.json")

# H100 SXM data sheet: device memory rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

BLUR_TOL = 1e-5        # kernel vs plain version, absolute
FORWARD_RTOL = 1e-4    # card vs CPU forward, max diff over max |CPU|
SPAN_TOL = 1e-4        # weight change outside span(D), relative

# (C, H) of the blur inputs on the church-256 path: after the up-convs of
# layers 3, 5, 7, 9, 11 and 13, (2h+1)-square maps
MAIN_SHAPES = ((512, 9), (512, 17), (512, 33), (512, 65), (256, 129),
               (128, 257))
# (N, C, H, W, pad): pads (1,1) and (2,1), odd and prime sizes, narrow C
EDGE_CASES = ((2, 128, 32, 32, (2, 1)), (2, 64, 33, 33, (1, 1)),
              (1, 8, 16, 16, (2, 1)), (1, 8, 35, 35, (1, 1)),
              (1, 8, 18, 18, (1, 1)), (1, 64, 12, 20, (1, 1)))


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.time() - t0:.3f} s", flush=True)


def time_ms(torch, fn, runs: int = 25, warmup: int = 3) -> float:
    """Median over `runs` of one call's device time, by CUDA events."""
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


def blur_bound_ms(x_shape, y_shape, k: int):
    """Least time for the blur: each input read once, each output written
    once, at the memory rate; or its FMAs at the fp32 peak."""
    nx = y_numel = 1
    for d in x_shape:
        nx *= d
    for d in y_shape:
        y_numel *= d
    bytes_ms = 4.0 * (nx + y_numel) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * k * k * y_numel / FP32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def run_edit_loop(model, params, niter: int) -> dict:
    """The paper's edit loop through the port's entry points: statistics
    at layer 8, the dome2tree request (rank 1, `niter` Adam steps), 8
    edited renders, revert, 8 renders again.  Checks the loss fell, the
    weight change lies in span(D) and every output is finite."""
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
                             layernum=8, key_method="zca",
                             device=model.device)
    sync()
    stats_s = time.time() - t1
    w0 = rw.target_weight().clone()
    t1 = time.time()
    losses = rw.apply_edit(request, rank=1, niter=niter, piter=10, lr=0.05)
    sync()
    solve_s = time.time() - t1
    z8 = rw.zds.zs[:8]
    t1 = time.time()
    edited = rw.sample_image_from_latent(z8)
    sync()
    render_s = time.time() - t1
    w1 = rw.target_weight().clone()
    rw.revert()
    reverted = rw.sample_image_from_latent(z8)
    sync()

    direction = rw.multi_key_from_selection(request["key"], rank=1)
    delta = w1 - w0
    outside = float((delta - projected_conv(delta, direction)).norm())
    span_rel = outside / float(delta.norm())
    change = float((edited - reverted).abs().mean())
    print(f"statistics (probe + 1000-z second moment + ZCA): {stats_s:.3f} s")
    print(f"edit (keys, goal, {len(losses)}-step solve): {solve_s:.3f} s; "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    print(f"render 8 samples: {render_s:.3f} s; mean |edited - reverted| = "
          f"{change:.6f}")
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
    if tuple(edited.shape) != (8, size, size, 3) or not change > 0:
        raise AssertionError(f"edited renders {tuple(edited.shape)} did not "
                             f"change (mean change {change})")
    return {"stats_s": stats_s, "solve_s": solve_s, "render_s": render_s,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rewriting_torch.models.stylegan2 import SeqStyleGAN2, params_to
    from rewriting_torch.ops import _build, blur2d as kblur, make_kernel
    from rewriting_torch.utils.zdataset import standard_z_sample

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    t_all = time.time()

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

    # 2. build and load the kernel --------------------------------------------
    t0 = time.time()
    kblur.library()
    build_s = time.time() - t0
    print(f"blur2d built and loaded in {build_s:.3f} s")
    for line in _build.build_logs.get("blur2d", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    phase("2 build", t0)

    # 3. kernel vs plain version -------------------------------------------------
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    blur_kflip = np.ascontiguousarray(
        np.flip(make_kernel([1, 3, 3, 1]) * 4.0, (0, 1)))
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
    if tuple(img.shape) != (1, 3, 256, 256):
        raise AssertionError(f"forward shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("forward on the card is not finite")
    rel = float((img.cpu() - img_cpu).abs().max() / img_cpu.abs().max())
    print(f"church-256 forward, card vs CPU: max diff / max |CPU| = "
          f"{rel:.3e} (limit {FORWARD_RTOL})")
    if not rel <= FORWARD_RTOL:
        raise AssertionError(f"card forward differs from the CPU by {rel}")
    phase("4 forward card vs CPU", t0)

    # 5. the edit loop (main path) ---------------------------------------------
    t0 = time.time()
    kblur.launches = 0
    loop = run_edit_loop(model, params, niter=2001)
    launches = kblur.launches
    print(json.dumps({"edit_loop": loop}))
    print(f"blur2d launches on the edit loop: {launches}")
    if launches <= 0:
        raise AssertionError("the edit loop never launched the blur kernel")
    phase("5 edit loop", t0)

    # 6. kernels line, 7. result ---------------------------------------------------
    head = rows[-1]  # the largest main-path shape, batch 10
    print(json.dumps({"kernels": [{
        "name": "blur2d", "route": "cuda",
        "source": "rewriting_torch/csrc/blur2d.cu",
        "replaces": "rewriting_tpu/ops/pallas_upfirdn.py:85 "
                    "(blur2d_pallas; blur2d_pallas_bs :230)",
        "launches": launches, "max_abs_err": max_err,
        "max_abs_diff": max_err, "at": head["shape"], "ms": head["ms"],
        "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]}))
    print(f"card: {card}")
    phase("all", t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
