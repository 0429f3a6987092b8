"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source compiles to its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

Libraries land in ``build/kernels/`` at the repository root, named by a
hash of their source, so an edited source rebuilds and an unchanged one
is reused. Sources build at first use, all in parallel (one nvcc per
source); ``build_all`` does the same up front and reports the time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or (CUDA_NVCC if os.path.exists(CUDA_NVCC) else None)
    if found is None:
        raise RuntimeError(
            f"nvcc not found (PATH or {CUDA_NVCC}): the port's CUDA "
            "kernels build from source on the machine with the card"
        )
    return found


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing, all nvcc processes
    started together. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, shared memory, spills per kernel).
    → {source stem: library path}. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Path] = {}
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = _lib_path(src)
        out[src.stem] = lib
        if lib.exists() and not verbose:
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, lib)
        if verbose:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(CSRC / f"{name}.cu")
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.dtpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dtpu_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib.dtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError {err} ({msg})")
