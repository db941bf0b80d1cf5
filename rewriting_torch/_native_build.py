"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, built by nvcc) or
``csrc/<name>.cpp`` (host code, built by the host compiler: ``$CXX``, else
``g++``) exposes a plain ``extern "C"`` interface and includes no PyTorch
header, so it compiles in seconds into ``rewriting_torch/_build/lib<name>.so``.
The build runs at first use and is keyed on a hash of the source and the
flags: an unchanged source is not built again.  :func:`build_all` starts
one compiler per source, all at once.  nvcc is found through
``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda/bin``; a missing compiler or a
failed build raises with the compiler's output.  The module imports no
torch, so the host decoder of ``native`` loads without it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"the host C++ compiler {cxx!r} ($CXX, else g++) "
                           "was not found")
    return found


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def source_path(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    cu = SOURCE_DIR / f"{name}.cu"
    return cu if cu.is_file() else SOURCE_DIR / f"{name}.cpp"


def _flags(source: Path):
    return NVCC_FLAGS if source.suffix == ".cu" else CXX_FLAGS


def _command(source: Path, output: Path) -> List[str]:
    if source.suffix == ".cu":
        return nvcc_command(find_nvcc(), source, output)
    return [find_cxx(), *CXX_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _digest(source: Path) -> str:
    return hashlib.sha256(source.read_bytes()
                          + " ".join(_flags(source)).encode()).hexdigest()


def _is_built(name: str) -> bool:
    out = library_path(name)
    stamp = out.with_name(out.name + ".sha256")
    return (out.is_file() and stamp.is_file()
            and stamp.read_text() == _digest(source_path(name)))


def build_all(names: Sequence[str]) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` or ``.cpp`` whose library on disk
    was not built from the same source and flags, one compiler process per
    source, all started together; returns the libraries' paths."""
    todo = [n for n in dict.fromkeys(names) if not _is_built(n)]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        commands = []
        for name in todo:
            source = source_path(name)
            out = library_path(name)
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            commands.append((name, source, out, tmp,
                             _command(source, tmp)))
        jobs = []
        for name, source, out, tmp, command in commands:
            jobs.append((name, source, out, tmp, _digest(source),
                         subprocess.Popen(command, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE,
                                          text=True)))
        failed = []
        for name, source, out, tmp, digest, proc in jobs:
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{Path(proc.args[0]).name} failed to build "
                              f"{source} "
                              f"(exit {proc.returncode}):\n{stderr}")
                continue
            os.replace(tmp, out)
            out.with_name(out.name + ".sha256").write_text(digest)
            build_logs[name] = stderr
        if failed:
            raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in names]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless the library on disk was
    built from the same source and flags; returns the library's path."""
    return build_all([name])[0]


_load_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``; one handle per process,
    built once however many threads ask for it first."""
    with _load_lock:
        return _load(name)
