"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and includes
no PyTorch header, so it compiles in seconds into
``rewriting_torch/_build/lib<name>.so``.  The build runs at first use and is
keyed on a hash of the source and the flags: an unchanged source is not
built again.  nvcc is found through ``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda/bin``; a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ptxas's report (registers, shared memory, spills) of each build this
# process ran, by source name
build_logs = {}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found in $CUDA_HOME/bin, on PATH or in "
                       "/usr/local/cuda/bin")


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library on disk was built from
    the same source and flags; returns the library's path."""
    source = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = library_path(name)
    stamp = out.with_name(out.name + ".sha256")
    if out.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(find_nvcc(), source, tmp),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {source} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    stamp.write_text(digest)
    build_logs[name] = proc.stderr
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
