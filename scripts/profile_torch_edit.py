"""Where the PyTorch port's church-256 edit loop and sampler spend their
time, on one CUDA device.

Builds the church-256 model (random weights, seed 0).  The edit part
builds the layer-8 rewriter, the dome2tree goal and context direction,
then times the first ``apply_edit`` of the process (profiled, ranked by
host time), the same 2001-step solve again and the solve per step, and
profiles a window of steps and a batch-8 render with ``torch.profiler``.
The sample part profiles ``sample_clean`` writing 64 images at batch 16,
with the fused up-conv on at all six layers (``set_fused_upconv("on",
min_res=0)``) and off, each after a warm run.
Prints the card, one table per profiled part (top operators by device
time) and one JSON line per part with the wall time, the summed device
kernel time, the device busy share and the device time of K2's kernels
(``blur2d_ms``).

    python3 scripts/profile_torch_edit.py [--parts edit,sample]
        [--steps 200] [--window 20] [--images 64]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from rewriting_torch.metrics.sample import sample_clean  # noqa: E402
from rewriting_torch.models.stylegan2 import SeqStyleGAN2  # noqa: E402
from rewriting_torch.ops import upconv_blur  # noqa: E402
from rewriting_torch.rewrite import SeqStyleGanRewriter, solve  # noqa: E402
from rewriting_torch.utils.zdataset import z_dataset_for_model  # noqa: E402

MASK = os.path.join(ROOT, "notebooks", "masks", "stylegan", "church",
                    "dome2tree.json")


def device_ms(prof, name: str = "") -> float:
    """Summed time of the device's kernels and copies, in ms (of those
    whose name holds `name`, when given).  Operator rows (whose device
    time is their kernels') and user annotations such as
    ``Optimizer.step`` (which span kernels) are left out."""
    total = 0.0
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer.")
                and name in e.key):
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3


def report(name, prof, wall_s, extra=None, by_host=False):
    """Print the top operators (by device time, or by host time with
    `by_host`) and one JSON line for the profiled part."""
    averages = prof.key_averages()
    if by_host:
        key = "cpu_time_total"
    elif hasattr(averages[0], "self_device_time_total"):
        key = "self_device_time_total"
    else:
        key = "self_cuda_time_total"
    print(f"--- {name}: top operators by {key}")
    print(averages.table(sort_by=key, row_limit=15))
    dev = device_ms(prof)
    line = {"part": name, "wall_ms": wall_s * 1e3, "device_ms": dev,
            "device_busy": dev / (wall_s * 1e3),
            "blur2d_ms": device_ms(prof, "blur2d")}
    line.update(extra or {})
    print(json.dumps(line))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def profile_sample(model, params, images: int) -> None:
    """``sample_clean`` of `images` church-256 PNGs at batch 16 under the
    profiler, the fused up-conv on and off, each after a warm run."""
    with tempfile.TemporaryDirectory(prefix="profile_sample_") as tmp:
        for mode in ("on", "off"):
            upconv_blur.set_fused_upconv(mode, min_res=0)
            sample_clean(model, params, os.path.join(tmp, f"warm_{mode}"),
                         n=16, batch_size=16)
            out = os.path.join(tmp, f"clean_{mode}")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = timed(lambda: sample_clean(model, params, out,
                                                  n=images, batch_size=16))
            report(f"sample_clean {images}, fused up-conv {mode}", prof,
                   wall, {"images": images,
                          "images_per_s": images / wall})
        upconv_blur.set_fused_upconv("off", min_res=256)


def profile_edit(model, params, steps: int, window: int) -> None:
    """The layer-8 dome2tree edit: the first apply_edit, the solve warm
    and per step, a window of steps and a batch-8 render."""
    rw = SeqStyleGanRewriter(model, params, z_dataset_for_model(model, 1000),
                             layernum=8, key_method="zca")
    with open(MASK) as f:
        req = json.load(f)
    obj = rw.object_from_selection(*req["object"])
    goal_in, goal_out, _, _ = rw.paste_from_selection(*req["paste"], obj[0],
                                                      obj[2])
    direction = rw.multi_key_from_selection(req["key"], rank=1)
    print("goal_in fmap", tuple(goal_in["fmap"].shape), "goal_out fmap",
          tuple(goal_out["fmap"].shape))

    def run(steps):
        return solve.insert_solve(rw._window_fn, rw.target_weight(),
                                  (goal_in, rw.params), goal_out["fmap"],
                                  direction, niter=steps, piter=10, lr=0.05)

    # the first apply_edit in the process (as chip_smoke.py times it, here
    # under the profiler, ranked by host time), then the same 2001-step
    # solve warm, then a shorter one per step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edit_s = timed(lambda: rw.apply_edit(req, rank=1, niter=2001,
                                             piter=10, lr=0.05))
    report("first apply_edit", prof, edit_s, by_host=True)
    rw.revert()
    solve_s = timed(lambda: run(2001))
    per_step = timed(lambda: run(steps)) / steps
    print(json.dumps({"part": "solve", "apply_edit_first_profiled_s": edit_s,
                      "solve_2001_warm_s": solve_s, "steps": steps,
                      "ms_per_step": per_step * 1e3}))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(window)
        torch.cuda.synchronize()
        wall = time.time() - t0
    report("solve window", prof, wall, {"steps": window})

    z8 = rw.zds.zs[:8]
    rw.sample_image_from_latent(z8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        rw.sample_image_from_latent(z8)
        torch.cuda.synchronize()
        wall = time.time() - t0
    report("render 8", prof, wall)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="edit,sample",
                    help="comma-separated parts to profile: edit, sample")
    ap.add_argument("--steps", type=int, default=200,
                    help="solve steps of the per-step time")
    ap.add_argument("--window", type=int, default=20,
                    help="solve steps under the profiler")
    ap.add_argument("--images", type=int, default=64,
                    help="images of each profiled sample_clean")
    a = ap.parse_args()
    parts = set(a.parts.split(","))
    if not parts <= {"edit", "sample"}:
        ap.error(f"unknown parts {sorted(parts - {'edit', 'sample'})}")
    if not torch.cuda.is_available():
        print("profile_torch_edit: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print("card:", smi.stdout.strip())

    model = SeqStyleGAN2(256, style_dim=512, n_mlp=8, channel_multiplier=2)
    params = model.init_params(seed=0)
    if "sample" in parts:
        profile_sample(model, params, a.images)
    if "edit" in parts:
        profile_edit(model, params, a.steps, a.window)
    return 0


if __name__ == "__main__":
    sys.exit(main())
