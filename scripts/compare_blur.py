"""Time the FIR blur kernel (K2) and its backward against an earlier
version of its source, on one CUDA device, at the church-256 blur shapes.

    python3 scripts/compare_blur.py --old path/to/old/blur2d.cu
        [--runs 25] [--variants]

The old source is built with the same nvcc flags into a temporary
directory and called through its launcher ``blur2d_f32`` (the general
k x k kernel's signature).  At each shape of ``chip_smoke.MAIN_SHAPES`` at
batch 1 and 10, forward ((1, 1) pads) and backward (the adjoint: rotated
taps, (2, 2) pads, from the (2h-1)-square gradient), both kernels run on
the same inputs, are held against the plain version at
``chip_smoke.BLUR_TOL`` and are timed in turns: old, new, new, old.  Both
are called straight through their launchers, so that the host's share is
the same; beside them stand the new kernel through ``ops.upfirdn2d.blur2d``
(forward) or ``blur2d_backward_cuda`` (backward), the depthwise
``F.conv2d`` and the bytes bound.  Prints the card, ptxas's registers,
shared memory and spills, one line per shape, the host's time a call of
each step of the launch path at (1, 512, 9, 9) (``host_costs``), and a
JSON line with the rows.

``--variants`` also times variants of the separable kernel beside the
new one, each in turns: ``rows2x`` and ``rowshalf``, bands of twice and
half the planned rows; ``chunks1``, 4 columns a lane (more spans) where
the plan gives more; ``stages6``, a ring of 6 rows in flight in place of
4 (the source rebuilt).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from rewriting_torch import _native_build as _build  # noqa: E402
from rewriting_torch.ops import make_kernel  # noqa: E402
from rewriting_torch.ops import blur2d as kb  # noqa: E402
from rewriting_torch.ops.precision import apply_parity_tier  # noqa: E402
from rewriting_torch.ops.upfirdn2d import (apply_blur, blur2d,  # noqa: E402
                                           blur_taps)


def build(source: str, name: str, outdir: str) -> ctypes.CDLL:
    """Build one source into outdir, print ptxas's report, load it."""
    lib = os.path.join(outdir, f"lib{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    report(name, proc.stderr)
    return ctypes.CDLL(lib)


def report(name: str, log: str) -> None:
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "Function properties" in line):
            print(f"{name} ptxas -v:", line.strip())


def typed(lib: ctypes.CDLL):
    """(blur2d_f32, blur2d_sep_f32 or None) of a library, typed as
    ``kb.library()`` types them."""
    new = kb.library()
    gen = lib.blur2d_f32
    gen.argtypes, gen.restype = new.blur2d_f32.argtypes, ctypes.c_int
    sep = getattr(lib, "blur2d_sep_f32", None)
    if sep is not None:
        sep.argtypes, sep.restype = new.blur2d_sep_f32.argtypes, ctypes.c_int
    return gen, sep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, help="the earlier csrc/blur2d.cu")
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--variants", action="store_true",
                    help="also time the variants of the cut and of the ring")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_blur: no CUDA device", file=sys.stderr)
        return 1
    apply_parity_tier()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print("card:", smi.stdout.strip())
    kern = make_kernel(list(chip_smoke.BLUR_TAPS))
    fwd = kb.blur_taps(np.flip(kern * 4.0, (0, 1)), (1, 1))
    bwd = fwd.adjoint
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    with tempfile.TemporaryDirectory(prefix="compare_blur_") as tmp:
        old_gen, _ = typed(build(a.old, "blur2d_old", tmp))
        kb.library()
        if "blur2d" in _build.build_logs:
            report("new", _build.build_logs["blur2d"])
        else:  # built by an earlier process: build a copy for the report
            build(str(_build.SOURCE_DIR / "blur2d.cu"), "blur2d_new", tmp)
        variants = {}
        if a.variants:
            text = (_build.SOURCE_DIR / "blur2d.cu").read_text()
            old_line = "constexpr int kStages = 4;"
            if text.count(old_line) != 1:
                raise RuntimeError("the source no longer has kStages = 4")
            path = os.path.join(tmp, "blur2d_stages6.cu")
            with open(path, "w") as f:
                f.write(text.replace(old_line, "constexpr int kStages = 6;"))
            _, variants["stages6"] = typed(build(path, "blur2d_stages6",
                                                 tmp))
        for b in (1, 10):
            for c, h in chip_smoke.MAIN_SHAPES:
                for direction, taps, hin in (("forward", fwd, h),
                                             ("backward", bwd, h - 1)):
                    rows.append(compare(a, b, c, hin, direction, taps,
                                        old_gen, variants, gen, stream))
    print(json.dumps({"compare_blur": rows, "host_us": host_costs()}))
    return 0


def host_costs(calls: int = 20000) -> dict:
    """The host's time a call, in us, of each step of K2's launch path and
    of the depthwise F.conv2d at (1, 512, 9, 9), the smallest map of the
    path: the best of three runs of `calls` calls without a synchronise
    (the card keeps up with these small launches)."""
    x = torch.randn(1, 512, 9, 9, device="cuda")
    kern = make_kernel(list(chip_smoke.BLUR_TAPS))
    taps = blur_taps(kern, (1, 1), 2)
    shape, fn, args, _ = kb._record(taps, x.shape, taps.pad)
    y = x.new_empty(shape)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    wdw = torch.from_numpy(np.array(taps.kflip)).cuda().expand(
        512, 1, 4, 4).contiguous()
    steps = {
        "output allocation (x.new_empty)": lambda: x.new_empty(shape),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "launcher call (ctypes + launch)":
            lambda: fn(x.data_ptr(), y.data_ptr(), *args, stream),
        "_launch": lambda: kb._launch(x, taps, taps.pad),
        "apply_blur (the layer's taps)": lambda: apply_blur(x, taps),
        "ops.upfirdn2d.blur2d": lambda: blur2d(x, kern, (1, 1), 2),
        "F.conv2d depthwise": lambda: F.conv2d(x, wdw, padding=1,
                                               groups=512)}
    out = {}
    for name, f in steps.items():
        torch.cuda.synchronize()
        out[name] = min(timeit.repeat(f, number=calls, repeat=3)) / calls * 1e6
        torch.cuda.synchronize()
        print(f"host {name}: {out[name]:.2f} us a call", flush=True)
    return out


def compare(a, b, c, hin, direction, taps, old_gen, variants, gen,
            stream) -> dict:
    """One shape, one direction: errors and times of old, new, variants."""
    k, pad = taps.k, taps.pad
    x = torch.randn((b, c, hin, hin), generator=gen, device="cuda")
    n_planes = b * c
    ho = hin + pad[0] + pad[1] - k + 1
    y_old = torch.empty((b, c, ho, ho), device="cuda")
    y_new = torch.empty_like(y_old)
    lib = kb.library()

    def run_old():
        rc = old_gen(x.data_ptr(), y_old.data_ptr(), n_planes, hin, hin, ho,
                     ho, pad[0], k, taps.taps_ptr, stream)
        if rc != 0:
            raise RuntimeError(f"old kernel: CUDA error {rc}")

    def sep_runner(fn, y, plan):
        args = kb.sep_args(taps, n_planes, hin, hin, ho, ho, plan)
        ptr = ctypes.addressof(args)

        def run():
            rc = fn(x.data_ptr(), y.data_ptr(), ptr, stream)
            if rc != 0:
                raise RuntimeError(f"separable kernel: CUDA error {rc}")
        run.args = args
        return run

    plan = kb._sep_plan(n_planes, ho, ho)
    run_new = sep_runner(lib.blur2d_sep_f32, y_new, plan)
    want = kb.blur2d_reference(x, taps, pad)
    run_old()
    run_new()
    torch.cuda.synchronize()
    errs = [float((y - want).abs().max()) for y in (y_old, y_new)]
    if not max(errs) <= chip_smoke.BLUR_TOL:
        raise AssertionError(f"{direction} {(b, c, hin)}: errors {errs}")
    t = [chip_smoke.time_ms(torch, fn, runs=a.runs)
         for fn in (run_old, run_new, run_new, run_old)]
    if direction == "forward":
        kern = make_kernel(list(chip_smoke.BLUR_TAPS))
        wrapper = lambda: blur2d(x, kern, (1, 1), 2)  # noqa: E731
    else:
        wrapper = lambda: kb.blur2d_backward_cuda(  # noqa: E731
            x, taps.adjoint, taps.adjoint.pad)
    w_ms = chip_smoke.time_ms(torch, wrapper, runs=a.runs)
    wdw = torch.from_numpy(np.array(taps.kflip)).cuda().expand(
        c, 1, k, k).contiguous()
    l_ms = chip_smoke.time_ms(torch, lambda: F.conv2d(
        x, wdw, padding=pad[0], groups=c), runs=a.runs)
    bound, by = chip_smoke.blur_bound_ms(x.shape, y_new.shape, k)
    row_ = {"direction": direction, "shape": [b, c, hin, hin],
            "plan": list(plan[:3]), "old_ms": t[::3], "new_ms": t[1:3],
            "wrapper_ms": w_ms, "library_ms": l_ms, "bound_ms": bound,
            "bound_by": by, "old_err": errs[0], "new_err": errs[1]}
    print(f"K2 {direction} {(b, c, hin, hin)} -> {ho}: old {t[0]:.4f} / "
          f"{t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms (plan lanes, "
          f"chunks, rows {tuple(plan[:3])}), through the wrapper "
          f"{w_ms:.4f} ms, F.conv2d depthwise {l_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}); errors {errs[0]:.2e} / {errs[1]:.2e}",
          flush=True)
    cuts = {}
    if a.variants:
        cuts["rows2x"] = (lib.blur2d_sep_f32, plan._replace(
            rows=min(ho, 2 * plan.rows)))
        cuts["rowshalf"] = (lib.blur2d_sep_f32, plan._replace(
            rows=max(1, plan.rows // 2)))
        if plan.chunks > 1:
            cuts["chunks1"] = (lib.blur2d_sep_f32, plan._replace(chunks=1))
        for name, fn in variants.items():
            cuts[name] = (fn, plan)
    for name, (fn, cut) in cuts.items():
        y_var = torch.empty_like(y_new)
        run_var = sep_runner(fn, y_var, cut)
        lanes, chunks, rows_ = cut[:3]
        run_var()
        torch.cuda.synchronize()
        err = float((y_var - want).abs().max())
        tv = [chip_smoke.time_ms(torch, f, runs=a.runs)
              for f in (run_var, run_new, run_new, run_var)]
        row_[name] = {"ms": tv[::3], "new_ms": tv[1:3], "err": err,
                      "cut": [lanes, chunks, rows_]}
        print(f"  {name} (lanes, chunks, rows {(lanes, chunks, rows_)}): "
              f"{tv[0]:.4f} / {tv[3]:.4f} ms, new {tv[1]:.4f} / "
              f"{tv[2]:.4f} ms; error {err:.2e}", flush=True)
        if not err <= chip_smoke.BLUR_TOL:
            raise AssertionError(f"{name}: error {err}")
    return row_


if __name__ == "__main__":
    sys.exit(main())
