"""Time the 2x polyphase FIR upsample (K3): its separable kernel against
its general kernel, on one CUDA device, at the shapes of
``chip_smoke.UP2_SHAPES``.

    python3 scripts/compare_upsample.py [--runs 25] [--variants]

At each shape both kernels run on the same input with upsample2d's taps
(``[1, 3, 3, 1]``, gain 4, pad (2, 1)), are held against the plain
version at ``chip_smoke.UP2_TOL`` and are timed, each called straight
through its launcher (``upsample2x_sep_f32`` with the planned arguments,
``upsample2x_f32`` as the general kernel's callers call it), in turns:
general, separable, separable, general.  Beside them stand the separable
kernel through ``upsample2x_cuda`` (the wrapper), the depthwise
``conv_transpose2d`` (``chip_smoke.up2_library``), a write of the output's
bytes alone (``zero_``) and the bytes bound.  Prints the card's name and
power limit, ptxas's registers, shared memory and spills, one line per
shape, the host's time a call of each step of the launch path at
(1, 64, 16, 16) (``host_costs``), and a JSON line with the rows.

``--variants`` also times variants of the separable kernel beside it,
each in turns: ``rows4x``, ``rows2x`` and ``rowshalf``, bands of four
times, twice and half the planned rows; ``stwb``, the float4 stores as
plain (write-back) stores in place of the streaming ``__stcs``, and
``stages8``, a ring of 8 rows in place of 4 (the source rebuilt for
each).
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
from rewriting_torch.ops import upsample2x as kup2  # noqa: E402
from rewriting_torch.ops.precision import apply_parity_tier  # noqa: E402
from rewriting_torch.ops.upfirdn2d import upsample2d  # noqa: E402

TAPS = (1, 3, 3, 1)
PAD = (2, 1)
# the variants the source is rebuilt for: (name, line, its replacement)
REBUILT = {
    "stwb": ("  __stcs(reinterpret_cast<float4*>(p), v);",
             "  *reinterpret_cast<float4*>(p) = v;"),
    "stages8": ("constexpr int kStages = 4;", "constexpr int kStages = 8;")}


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
    """ptxas's registers, shared memory and spills of the separable
    kernel's instantiations with D = 3 (4 taps) and of the general
    kernel's 4-tap one."""
    keep = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = ("sep_kernelILi3E" in line
                    or "upsample2x_kernelILi4E" in line)
            if keep:
                print(f"{name} ptxas -v:", line.strip().split("'")[1])
        elif keep and ("registers" in line or "spill" in line):
            print(f"{name} ptxas -v:  ", line.strip())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--variants", action="store_true",
                    help="also time the variants of the cut and the stores")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_upsample: no CUDA device", file=sys.stderr)
        return 1
    apply_parity_tier()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print("card:", smi.stdout.strip())
    kern = make_kernel(list(TAPS)) * 4.0
    taps = kup2.up2_taps(np.flip(kern, (0, 1)), PAD)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory(prefix="compare_upsample_") as tmp:
        kup2.library()
        if "upsample2x" in _build.build_logs:
            report("upsample2x", _build.build_logs["upsample2x"])
        else:  # built by an earlier process: build a copy for the report
            build(str(_build.SOURCE_DIR / "upsample2x.cu"), "upsample2x_copy",
                  tmp)
        variants = {}
        if a.variants:
            text = (_build.SOURCE_DIR / "upsample2x.cu").read_text()
            for name, (old, new) in REBUILT.items():
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: the source no longer has "
                                       f"{old!r}")
                path = os.path.join(tmp, f"upsample2x_{name}.cu")
                with open(path, "w") as f:
                    f.write(text.replace(old, new))
                lib = build(path, f"upsample2x_{name}", tmp)
                fn = lib.upsample2x_sep_f32
                fn.argtypes, fn.restype = [ctypes.c_void_p] * 4, ctypes.c_int
                variants[name] = fn
        for n, c, h, w in chip_smoke.UP2_SHAPES:
            rows.append(compare(a, n, c, h, w, taps, kern, variants, gen))
    print(json.dumps({"compare_upsample": rows, "host_us": host_costs()}))
    return 0


def host_costs(calls: int = 20000) -> dict:
    """The host's time a call, in us, of each step of K3's launch path at
    (1, 64, 16, 16), the smallest map upsample2d sends it, and of the
    depthwise conv_transpose2d: the best of three runs of `calls` calls
    without a synchronise (the card keeps up with these small
    launches)."""
    x = torch.randn(1, 64, 16, 16, device="cuda")
    kern = make_kernel(list(TAPS))
    taps = kup2.up2_taps(np.flip(kern * 4.0, (0, 1)), PAD)
    shape, fn, args, _ = kup2._record(taps, x.shape)
    y = x.new_empty(shape)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    general = kup2.library().upsample2x_f32
    kflip = np.array(taps.kflip)
    wt = torch.from_numpy(kern * 4.0).cuda().expand(64, 1, 4, 4).contiguous()

    def old_wrapper_path():
        # what each call of the earlier wrapper (before the launch path
        # was shortened) did besides the launch: copy the taps, enter the
        # device context, build a Stream object
        t = np.ascontiguousarray(kflip, np.float32)
        with torch.cuda.device(x.device):
            s = torch.cuda.current_stream(x.device).cuda_stream
        return t, s
    steps = {
        "output allocation (x.new_empty)": lambda: x.new_empty(shape),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "separable launcher call (ctypes + launch)":
            lambda: fn(x.data_ptr(), y.data_ptr(), *args, stream),
        "general launcher call (ctypes + Taps struct + launch)":
            lambda: general(x.data_ptr(), y.data_ptr(), 64, 16, 16, PAD[0],
                            4, taps.taps_ptr, stream),
        "the earlier wrapper's per-call taps, device context and Stream":
            old_wrapper_path,
        "upsample2x_cuda": lambda: kup2.upsample2x_cuda(x, taps, PAD),
        "ops.upfirdn2d.upsample2d": lambda: upsample2d(x, kern),
        "conv_transpose2d depthwise": lambda: F.conv_transpose2d(
            x, wt, stride=2, padding=1, groups=64)}
    out = {}
    for name, f in steps.items():
        torch.cuda.synchronize()
        out[name] = min(timeit.repeat(f, number=calls, repeat=3)) / calls * 1e6
        torch.cuda.synchronize()
        print(f"host {name}: {out[name]:.2f} us a call", flush=True)
    return out


def compare(a, n, c, h, w, taps, kern, variants, gen) -> dict:
    """One shape: errors and times of both kernels, the wrapper, the
    library call, a write of the output's bytes and the variants."""
    x = torch.randn((n, c, h, w), generator=gen, device="cuda")
    planes = n * c
    stream = torch.cuda.current_stream().cuda_stream
    lib = kup2.library()
    y_gen = torch.empty((n, c, 2 * h, 2 * w), device="cuda")
    y_sep = torch.empty_like(y_gen)

    def run_general():
        rc = lib.upsample2x_f32(x.data_ptr(), y_gen.data_ptr(), planes, h, w,
                                PAD[0], taps.k, taps.taps_ptr, stream)
        if rc != 0:
            raise RuntimeError(f"general kernel: CUDA error {rc}")

    def sep_runner(fn, y, plan):
        args = kup2.sep_args(taps, planes, h, w, plan)
        ptr = ctypes.addressof(args)

        def run():
            rc = fn(x.data_ptr(), y.data_ptr(), ptr, stream)
            if rc != 0:
                raise RuntimeError(f"separable kernel: CUDA error {rc}")
        run.args = args
        return run

    plan = kup2.sep_plan(planes, h, w)
    run_sep = sep_runner(lib.upsample2x_sep_f32, y_sep, plan)
    want = kup2.upsample2x_reference(x, taps, PAD)
    run_general()
    run_sep()
    torch.cuda.synchronize()
    errs = [float((y - want).abs().max()) for y in (y_gen, y_sep)]
    if not max(errs) <= chip_smoke.UP2_TOL:
        raise AssertionError(f"{(n, c, h, w)}: errors {errs}")
    t = [chip_smoke.time_ms(torch, fn, runs=a.runs)
         for fn in (run_general, run_sep, run_sep, run_general)]
    w_ms = chip_smoke.time_ms(torch, lambda: kup2.upsample2x_cuda(
        x, taps, PAD), runs=a.runs)
    l_ms = chip_smoke.time_ms(torch, lambda: chip_smoke.up2_library(
        torch, x, kern), runs=a.runs)
    z_ms = chip_smoke.time_ms(torch, y_sep.zero_, runs=a.runs)
    bound, by = chip_smoke.up2_bound_ms(x.shape, taps.k)
    row = {"shape": [n, c, h, w], "plan": list(plan[:3]),
           "general_ms": t[::3], "sep_ms": t[1:3], "wrapper_ms": w_ms,
           "library_ms": l_ms, "write_ms": z_ms, "bound_ms": bound,
           "bound_by": by, "general_err": errs[0], "sep_err": errs[1]}
    print(f"K3 {(n, c, h, w)}: general {t[0]:.4f} / {t[3]:.4f} ms, "
          f"separable {t[1]:.4f} / {t[2]:.4f} ms (plan lanes, chunks, rows "
          f"{tuple(plan[:3])}), through upsample2x_cuda {w_ms:.4f} ms, "
          f"conv_transpose2d {l_ms:.4f} ms, zero_ of the output {z_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({by}); errors {errs[0]:.2e} / "
          f"{errs[1]:.2e}", flush=True)
    cuts = {}
    if a.variants:
        cuts["rows4x"] = (lib.upsample2x_sep_f32, plan._replace(
            rows=min(h, 4 * plan.rows)))
        cuts["rows2x"] = (lib.upsample2x_sep_f32, plan._replace(
            rows=min(h, 2 * plan.rows)))
        cuts["rowshalf"] = (lib.upsample2x_sep_f32, plan._replace(
            rows=max(1, plan.rows // 2)))
        for name, fn in variants.items():
            cuts[name] = (fn, plan)
    for name, (fn, cut) in cuts.items():
        y_var = torch.empty_like(y_sep)
        run_var = sep_runner(fn, y_var, cut)
        run_var()
        torch.cuda.synchronize()
        err = float((y_var - want).abs().max())
        tv = [chip_smoke.time_ms(torch, f, runs=a.runs)
              for f in (run_var, run_sep, run_sep, run_var)]
        row[name] = {"ms": tv[::3], "sep_ms": tv[1:3], "err": err,
                     "cut": list(cut[:3])}
        print(f"  {name} (lanes, chunks, rows {tuple(cut[:3])}): "
              f"{tv[0]:.4f} / {tv[3]:.4f} ms, separable {tv[1]:.4f} / "
              f"{tv[2]:.4f} ms; error {err:.2e}", flush=True)
        if not err <= chip_smoke.UP2_TOL:
            raise AssertionError(f"{name}: error {err}")
    return row


if __name__ == "__main__":
    sys.exit(main())
