"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
and loaded with ``ctypes``.  The library's file name carries a hash of the
sources, so a changed source is always rebuilt and a stale build is never
reused.  Builds go to ``repro_torch/_build`` (listed in ``.gitignore``).

Nothing here runs at import: the CPU tests import every module, on
machines that may have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("retrieval_kernels.cu",)
HEADERS = ("retrieval_core.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int

#: C signatures of the exported launchers: (argtypes) -> int error code.
SIGNATURES = {
    "rt_backward_search": [_VP] * 8 + [_I] * 6 + [_VP],
    "rt_ilcp_list": [_VP] * 13 + [_I] * 7 + [_VP],
    "rt_rank": [_VP] * 4 + [_I] + [_VP],
    "rt_rmq": [_VP] * 5 + [_I] * 3 + [_VP],
}

_lib = None
#: what the last build printed (ptxas register / spill report) and took
build_log: dict = {}


def source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(SOURCES + HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists;
    return its path."""
    lib_path = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log.update(seconds=time.perf_counter() - t0,
                     output=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a launcher returned."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_operand(name: str, t, dims: int, device) -> None:
    """A kernel operand must be a contiguous int32 tensor of ``dims``
    dimensions on ``device``."""
    if (t.device != device or t.dtype != torch.int32 or t.dim() != dims
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous int32 {dims}-D tensor on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
