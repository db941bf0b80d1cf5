"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and includes
no PyTorch header, so it compiles in seconds into
``rewriting_torch/_build/lib<name>.so``.  The build runs at first use and is
keyed on a hash of the source and the flags: an unchanged source is not
built again.  :func:`build_all` starts one nvcc per source, all at once.
nvcc is found through ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda/bin``;
a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

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


def _digest(source: Path) -> str:
    return hashlib.sha256(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()


def _is_built(name: str) -> bool:
    out = library_path(name)
    stamp = out.with_name(out.name + ".sha256")
    return (out.is_file() and stamp.is_file()
            and stamp.read_text() == _digest(SOURCE_DIR / f"{name}.cu"))


def build_all(names: Sequence[str]) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` whose library on disk was not built
    from the same source and flags, one nvcc process per source, all
    started together; returns the libraries' paths."""
    todo = [n for n in dict.fromkeys(names) if not _is_built(n)]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        jobs = []
        for name in todo:
            source = SOURCE_DIR / f"{name}.cu"
            out = library_path(name)
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            jobs.append((name, source, out, tmp, _digest(source),
                         subprocess.Popen(nvcc_command(nvcc, source, tmp),
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE,
                                          text=True)))
        failed = []
        for name, source, out, tmp, digest, proc in jobs:
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {source} "
                              f"(exit {proc.returncode}):\n{stderr}")
                continue
            os.replace(tmp, out)
            out.with_name(out.name + ".sha256").write_text(digest)
            build_logs[name] = stderr
        if failed:
            raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in names]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library on disk was built from
    the same source and flags; returns the library's path."""
    return build_all([name])[0]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
