"""Where K1's one-pass bf16 kernel spends a block's time, on one CUDA
device, at (16,256,128,128)->128 and (8,128,256,256)->64 with the
epilogue.

    python3 scripts/profile_upconv_bf16.py [--runs 15]

Builds variants of ``csrc/upconv_blur_bf16.cu`` (the source's text with
substitutions, the current nvcc flags) and calls each launcher directly,
with the weights packed once:

- ``stamped``: thread 0 of each block writes ``clock64()`` at the phase
  boundaries (start, the first chunk converted, the K loop's end, the
  accumulators in shared memory, each blur round's row and column pass);
  prints each phase's median and mean cycles over the blocks of a launch;
- ablations, each timed (CUDA events, median) beside the source as it is:
  ``no_blur`` (no blur, epilogue or stores), ``no_convert`` (the K loop
  rounds no chunk of x), ``no_x`` (x is not loaded), ``mma_only`` (no
  loads, conversion, blur or stores after the first chunks).  Their
  outputs are wrong by design; a substitution that no longer matches the
  source raises.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rewriting_torch import _native_build as _build  # noqa: E402
from rewriting_torch.ops import upconv_blur as kup  # noqa: E402

SHAPES = ((16, 256, 128, 128, 128), (8, 128, 256, 256, 64))
PHASES = ("first chunk", "K loop", "accumulators", "row pass 0",
          "column pass 0", "row pass 1", "column pass 1")
BLUR_LOOP = "  for (int round = 0; round < kN / kCC; ++round) {"
# keeps the accumulators live when the blur is cut out
KEEP = ("  if (acc[0][0] == 1.2345f && acc[1][3] == 2.f && acc[2][5] == 3.f "
        "&& acc[3][7] == 4.f) y[0] = 1.f;\n")


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer has one {old!r}")
    return text.replace(old, new)


def stamp(k) -> str:
    blk = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"
    return (f"  if (threadIdx.x == 0 && {blk} < 65536) "
            f"g_stamp[{blk} * 8 + {k}] = clock64();\n")


def variants() -> dict:
    src = (_build.SOURCE_DIR / "upconv_blur_bf16.cu").read_text()
    t = sub(src, "namespace {\n",
            "__device__ unsigned long long g_stamp[1 << 20];\nnamespace {\n")
    t = sub(t, "  const int tid = threadIdx.x;\n",
            "  const int tid = threadIdx.x;\n" + stamp(0))
    t = sub(t, "  if (nchunks > 2) load_chunk(2);\n  cp_commit();\n",
            "  if (nchunks > 2) load_chunk(2);\n  cp_commit();\n" + stamp(1))
    t = sub(t, "  __syncthreads();   // the ring is free: it becomes the "
            "blur's buffers\n", "  __syncthreads();   // the ring is free: "
            "it becomes the blur's buffers\n" + stamp(2))
    t = sub(t, "  __syncthreads();\n  const float t0 = taps.v[0]",
            "  __syncthreads();\n" + stamp(3) + "  const float t0 = taps.v[0]")
    t = sub(t, "    __syncthreads();\n    // columns: output row r",
            "    __syncthreads();\n  " + stamp("4 + 2 * round")
            + "    // columns: output row r")
    t = sub(t, "    __syncthreads();   // the next round overwrites the "
            "row-pass buffer\n  }\n}\n", "    __syncthreads();   // the next "
            "round overwrites the row-pass buffer\n    if (round == 0) {\n  "
            + stamp(5) + "    }\n  }\n" + stamp(7) + "}\n")
    t += ('\nextern "C" int read_stamps(unsigned long long* h, int n) '
          '{ return (int)cudaMemcpyFromSymbol(h, g_stamp, n * 8); }\n')
    no_blur = sub(src, BLUR_LOOP, KEEP + "  for (int round = 0; round < 0; "
                  "++round) {")
    no_loads = sub(sub(sub(src, "      convert(c + 1);\n", ""),
                       "      if (c + 3 < nchunks) load_chunk(c + 3);\n", ""),
                   "      wait_chunk(c + 1);\n",
                   "      if (c + 1 < 3) wait_chunk(c + 1);\n")
    return {
        "source": src, "stamped": t, "no_blur": no_blur,
        "no_convert": sub(src, "      convert(c + 1);\n", ""),
        "no_x": sub(sub(src, "mbar_expect_tx(bar, kWChunkBytes + (tma ? "
                        "kKc * npos * 4 : 0));", "mbar_expect_tx(bar, "
                        "kWChunkBytes);"), "      if (tma)\n        "
                    "tma_load_4d(", "      if (0)\n        tma_load_4d("),
        "mma_only": sub(no_loads, BLUR_LOOP, KEEP + "  for (int round = 0; "
                        "round < 0; ++round) {"),
    }


def build(texts: dict, outdir: str) -> dict:
    """One nvcc a variant, all at once; the launchers by name."""
    procs = {}
    for name, text in texts.items():
        path = os.path.join(outdir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(outdir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name} ptxas -v:", line.strip())
        libs[name] = ctypes.CDLL(lib)
        fn = libs[name].upconv_blur_bf16_f32
        fn.argtypes = kup.library_bf16().argtypes
        fn.restype = ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=15)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_upconv_bf16: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print("card:", smi.stdout.strip())
    kf = (0.25, 0.75, 0.75, 0.25)
    taps4 = kup.flipped_taps(kf)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with tempfile.TemporaryDirectory(prefix="profile_upconv_bf16_") as tmp:
        libs = build(variants(), tmp)
        read = libs["stamped"].read_stamps
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for b, i, h, w, o in SHAPES:
            x = torch.randn((b, i, h, w), generator=gen, device="cuda")
            wf = torch.randn((o, i, 3, 3), generator=gen,
                             device="cuda") / (3.0 * i ** 0.5)
            demod = torch.rand((b, o), generator=gen, device="cuda") + 0.5
            noise = torch.randn((1, 1, 2 * h, 2 * w), generator=gen,
                                device="cuda")
            bias = torch.randn((o,), generator=gen, device="cuda")
            wp = kup.pack_weights_bf16(wf)
            y = torch.empty((b, o, 2 * h, 2 * w), device="cuda")
            tile = tuple(kup._plan_bf16(b, i, h, w, o))
            key = f"{(b, i, h, w)} -> {o}"
            row = {"tile": list(tile), "ms": {}}

            def launch(name):
                rc = libs[name].upconv_blur_bf16_f32(
                    x.data_ptr(), wp.data_ptr(), y.data_ptr(), b, i, o, h,
                    w, taps4.ctypes.data, demod.data_ptr(),
                    noise.data_ptr(), 0, bias.data_ptr(), *tile,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            for name in libs:
                if name != "stamped":
                    row["ms"][name] = chip_smoke.time_ms(
                        torch, lambda: launch(name), runs=a.runs)
            launch("stamped")
            torch.cuda.synchronize()
            nblocks = min(int(np.prod(kup._grid_bf16(b, h, w, o,
                                                     kup.TileBf16(*tile)))),
                          65536)
            st = np.zeros(nblocks * 8, np.uint64)
            if read(st.ctypes.data, st.size) != 0:
                raise RuntimeError("reading the stamps failed")
            st = st.reshape(nblocks, 8).astype(np.int64)
            d = np.diff(st, axis=1)
            row["cycles"] = {
                "block": float(np.median(st[:, 7] - st[:, 0])),
                **{p: float(np.median(d[:, k]))
                   for k, p in enumerate(PHASES)}}
            print(f"K1 one-pass {key}, tile {tile}: "
                  + ", ".join(f"{n} {t:.4f} ms" for n, t in
                              row["ms"].items()))
            print(f"  cycles a block (median): " + ", ".join(
                f"{p} {c:.0f}" for p, c in row["cycles"].items()))
            out[key] = row
            del x, wf, wp, y, demod, noise, bias
    print(json.dumps({"profile_upconv_bf16": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
