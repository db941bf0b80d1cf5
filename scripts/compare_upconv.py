"""Time the fused up-conv + blur kernel (K1) against an earlier version of
its source, on one CUDA device, at the church-256 layer shapes; or, with
``--bf16``, its one-pass bf16 kernel against an earlier one-pass mode.

    python3 scripts/compare_upconv.py --old path/to/old/upconv_blur.cu
        [--batch 16] [--runs 25] [--ablations]
    python3 scripts/compare_upconv.py --bf16 --old path/to/upconv_blur.cu
        [--runs 25]

The old source is built with the same nvcc flags into a temporary
directory and called through its own launcher, whose signature is that of
the first version (the 16 blur taps, no tile arguments).  At each shape of
``chip_smoke.UPCONV_SHAPES`` both kernels run with the epilogue on the same
inputs, are held against the plain version (``UPCONV_RTOL``) and are timed
in turns: old, new, new, old.  Prints the card, one line per shape and a
JSON line with the rows.

``--ablations`` also builds two variants of the current source and reports
their error and time beside it: ``chained``, every product accumulated
straight into the accumulators (no per-tap sums in fp32), and ``cvt``, the
TF32 rounding by ``cvt.rna.tf32.f32`` in place of the two integer
operations.  They show why the source does what it does; an error above
``UPCONV_RTOL`` is reported, not raised.

``--bf16`` builds the old source as the one-pass mode's earlier home (the
``upconv_blur.cu`` whose launcher takes the tile and a mode, mode 1 the
bf16 ``mma.sync`` version, e.g. ``git show d5c43c3:rewriting_torch/csrc/
upconv_blur.cu``) and times it against ``csrc/upconv_blur_bf16.cu``
through ``upconv_blur_cuda(..., tier="default")`` at each shape of
``chip_smoke.BF16_UPCONV_SHAPES``, with the epilogue, in turns: old, new,
new, old.  Both are held to the plain bf16 version
(``BF16_UPCONV_RTOL``) first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rewriting_torch import _native_build as _build  # noqa: E402
from rewriting_torch.ops import upconv_blur as kup  # noqa: E402
from rewriting_torch.ops.precision import apply_parity_tier  # noqa: E402


def load_old(source: str, outdir: str):
    """Build the old source and return its launcher."""
    lib = os.path.join(outdir, "libupconv_blur_old.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print("old ptxas -v:", line.strip())
    fn = ctypes.CDLL(lib).upconv_blur_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load_old_bf16(source: str, outdir: str):
    """Build an earlier upconv_blur.cu with the one-pass mode and return
    its launcher (the tile's six ints and the mode before the stream)."""
    lib = os.path.join(outdir, "libupconv_blur_old_bf16.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print("old ptxas -v:", line.strip())
    fn = ctypes.CDLL(lib).upconv_blur_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_void_p]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def compare_bf16(old_source: str, runs: int) -> list:
    """The old one-pass mode against the new kernel at
    ``chip_smoke.BF16_UPCONV_SHAPES``; returns the rows."""
    kf = (0.25, 0.75, 0.75, 0.25)
    taps4 = kup.flipped_taps(kf)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory(prefix="compare_upconv_") as tmp:
        old = load_old_bf16(old_source, tmp)
        kup.library_bf16()
        for b, i, h, w, o in chip_smoke.BF16_UPCONV_SHAPES:
            x = torch.randn((b, i, h, w), generator=gen, device="cuda")
            wf = torch.randn((o, i, 3, 3), generator=gen,
                             device="cuda") / (3.0 * i ** 0.5)
            demod = torch.rand((b, o), generator=gen, device="cuda") + 0.5
            noise = torch.randn((1, 1, 2 * h, 2 * w), generator=gen,
                                device="cuda")
            bias = torch.randn((o,), generator=gen, device="cuda")
            # the earlier wrapper's packing and tile: (I, 3, 3, O), and
            # the 3xTF32 plan staging 16 channels or more
            tile = kup._plan(b, i, h, w, o)
            if tile.kc < 16:
                raise RuntimeError(f"{(b, i, h, w, o)}: the old mode needs "
                                   f"kc >= 16, the plan stages {tile.kc}")
            y_old = torch.empty((b, o, 2 * h, 2 * w), device="cuda")

            def run_old():
                wp = wf.permute(1, 2, 3, 0).contiguous()
                rc = old(x.data_ptr(), wp.data_ptr(), y_old.data_ptr(), b, i,
                         o, h, w, taps4.ctypes.data, demod.data_ptr(),
                         noise.data_ptr(), 0, bias.data_ptr(), *tile, 1,
                         torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"old kernel: CUDA error {rc}")

            def run_new():
                return kup.upconv_blur_cuda(x, wf, kf, demod, noise, bias,
                                            tier="default")

            want = kup.upconv_blur_reference(x, wf, kf, demod, noise, bias,
                                             tier="default")
            run_old()
            got = run_new()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            errs = [float((y - want).abs().max()) / scale
                    for y in (y_old, got)]
            if not max(errs) <= chip_smoke.BF16_UPCONV_RTOL:
                raise AssertionError(f"{(b, i, h, w, o)}: errors {errs}")
            times = [chip_smoke.time_ms(torch, fn, runs=runs)
                     for fn in (run_old, run_new, run_new, run_old)]
            bound, by = chip_smoke.upconv_bf16_bound_ms(b, i, h, o, w)
            rows.append({"shape": [b, i, h, w, o], "old_ms": times[::3],
                         "new_ms": times[1:3], "bound_ms": bound,
                         "bound_by": by, "old_rel_err": errs[0],
                         "new_rel_err": errs[1],
                         "tile": list(kup._plan_bf16(b, i, h, w, o))})
            print(f"K1 one-pass {(b, i, h, w)} -> {o}: old {times[0]:.4f} / "
                  f"{times[3]:.4f} ms, new {times[1]:.4f} / {times[2]:.4f} "
                  f"ms, bound {bound:.4f} ms ({by}); errors "
                  f"{errs[0]:.2e} / {errs[1]:.2e} of max |plain|",
                  flush=True)
            del x, wf, y_old, got, want
    return rows


def ablation_sources() -> dict:
    """The variants of csrc/upconv_blur.cu that ``--ablations`` builds."""
    src = (_build.SOURCE_DIR / "upconv_blur.cu").read_text()

    def sub(text, old, new, count=1):
        if text.count(old) != count:
            raise RuntimeError(f"ablation: the source no longer has {old!r}")
        return text.replace(old, new)

    chained = sub(src, """        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(d, al[mt], bh0, bh1);
        mma(d, ah[mt], bl0, bl1);
        mma(d, ah[mt], bh0, bh1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][P][q] += d[q];""",
                  """        mma(acc[mt][nt][P], al[mt], bh0, bh1);
        mma(acc[mt][nt][P], ah[mt], bl0, bl1);
        mma(acc[mt][nt][P], ah[mt], bh0, bh1);""")
    chained = sub(chained, "mma(d0[mt][nt],", "mma(acc[mt][nt][0],", 3)
    chained = sub(chained, "acc[mt][nt][0][q] += d0[mt][nt][q];",
                  "d0[mt][nt][q] = 0.0f;")
    cvt = sub(src, "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
              '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) '
              ': "f"(v));\n  return r;')
    return {"chained": chained, "cvt": cvt}


def load_variant(name: str, text: str, outdir: str):
    """Build a variant of the current source; its launcher has the current
    signature."""
    source = os.path.join(outdir, f"upconv_blur_{name}.cu")
    with open(source, "w") as f:
        f.write(text)
    lib = os.path.join(outdir, f"libupconv_blur_{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"{name} ptxas -v:", line.strip())
    fn = ctypes.CDLL(lib).upconv_blur_f32
    fn.argtypes = kup.library().argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="the earlier csrc/upconv_blur.cu")
    ap.add_argument("--bf16", action="store_true",
                    help="time the one-pass bf16 kernel against the old "
                         "source's mode 1")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--ablations", action="store_true",
                    help="also time the chained and cvt variants")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_upconv: no CUDA device", file=sys.stderr)
        return 1
    apply_parity_tier()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print("card:", smi.stdout.strip())
    if a.bf16:
        print(json.dumps({"compare_upconv_bf16": compare_bf16(a.old,
                                                              a.runs)}))
        return 0
    kf = (0.25, 0.75, 0.75, 0.25)
    taps16 = kup.blur_taps(kf)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = a.batch
    rows = []
    with tempfile.TemporaryDirectory(prefix="compare_upconv_") as tmp:
        old = load_old(a.old, tmp)
        kup.library()
        variants = ({n: load_variant(n, t, tmp)
                     for n, t in ablation_sources().items()}
                    if a.ablations else {})
        for i, h, o in chip_smoke.UPCONV_SHAPES:
            x = torch.randn((b, i, h, h), generator=gen, device="cuda")
            wf = torch.randn((o, i, 3, 3), generator=gen,
                             device="cuda") / (3.0 * i ** 0.5)
            demod = torch.rand((b, o), generator=gen, device="cuda") + 0.5
            noise = torch.randn((1, 1, 2 * h, 2 * h), generator=gen,
                                device="cuda")
            bias = torch.randn((o,), generator=gen, device="cuda")
            wp = wf.permute(1, 2, 3, 0).contiguous()
            y_old = torch.empty((b, o, 2 * h, 2 * h), device="cuda")

            def run_old():
                rc = old(x.data_ptr(), wp.data_ptr(), y_old.data_ptr(), b, i,
                         o, h, h, taps16.ctypes.data, demod.data_ptr(),
                         noise.data_ptr(), 0, bias.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"old kernel: CUDA error {rc}")

            def run_new():
                return kup.upconv_blur_cuda(x, wf, kf, demod, noise, bias)

            want = kup.upconv_blur_reference(x, wf, kf, demod, noise, bias)
            run_old()
            got = run_new()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            errs = [float((y - want).abs().max()) / scale
                    for y in (y_old, got)]
            if not max(errs) <= chip_smoke.UPCONV_RTOL:
                raise AssertionError(f"{(b, i, h, o)}: errors {errs}")
            times = [chip_smoke.time_ms(torch, fn, runs=a.runs)
                     for fn in (run_old, run_new, run_new, run_old)]
            bound, _ = chip_smoke.upconv_bound_ms(b, i, h, o)
            row = {"shape": [b, i, h, h, o], "old_ms": times[::3],
                   "new_ms": times[1:3], "bound_ms": bound,
                   "old_rel_err": errs[0], "new_rel_err": errs[1]}
            tile = kup._plan(b, i, h, h, o)
            taps4 = kup.flipped_taps(kf)
            for name, fn in variants.items():
                y_var = torch.empty_like(y_old)

                def run_var():
                    rc = fn(x.data_ptr(), wp.data_ptr(),
                            y_var.data_ptr(), b, i, o, h, h,
                            taps4.ctypes.data, demod.data_ptr(),
                            noise.data_ptr(), 0, bias.data_ptr(), *tile,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                run_var()
                torch.cuda.synchronize()
                err = float((y_var - want).abs().max()) / scale
                t_var = [chip_smoke.time_ms(torch, f, runs=a.runs)
                         for f in (run_var, run_new, run_new, run_var)]
                row[name] = {"ms": t_var[::3], "new_ms": t_var[1:3],
                             "rel_err": err}
                print(f"  {name}: {t_var[0]:.4f} / {t_var[3]:.4f} ms, new "
                      f"{t_var[1]:.4f} / {t_var[2]:.4f} ms; error {err:.2e} "
                      f"of max |plain| (limit {chip_smoke.UPCONV_RTOL})",
                      flush=True)
            rows.append(row)
            print(f"K1 {(b, i, h, h)} -> {o}: old {times[0]:.4f} / "
                  f"{times[3]:.4f} ms, new {times[1]:.4f} / {times[2]:.4f} "
                  f"ms, 3xTF32 bound {bound:.4f} ms; errors {errs[0]:.2e} / "
                  f"{errs[1]:.2e} of max |plain|", flush=True)
            del x, wf, wp, y_old, got, want
    print(json.dumps({"compare_upconv": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
