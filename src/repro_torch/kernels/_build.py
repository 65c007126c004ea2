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
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("retrieval_kernels.cu", "model_kernels.cu", "flash_hopper.cu", "probe_kernels.cu")
HEADERS = ("retrieval_core.cuh", "embedding_bag_core.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: C signatures of the exported launchers: (argtypes) -> int error code.
SIGNATURES = {
    "rt_backward_search": [_VP] * 8 + [_I] * 6 + [_VP],
    "rt_ilcp_list": [_VP] * 8 + [_I] * 6 + [_VP],
    "rt_ilcp_list_csa": [_VP] * 15 + [_I] * 12 + [_VP],
    "rt_sada_c_list": [_VP] * 7 + [_I] * 6 + [_VP],
    "rt_sada_c_list_csa": [_VP] * 14 + [_I] * 12 + [_VP],
    "rt_wt_list": [_VP] * 8 + [_I] * 4 + [_VP],
    "rt_pdl_gather": [_VP] * 24 + [_I] * 20 + [_VP],
    "rt_rank": [_VP] * 4 + [_I] + [_VP],
    "rt_rmq": [_VP] * 5 + [_I] * 3 + [_VP],
    "rt_flash_attention": [_VP] * 4 + [_I] * 8 + [_LL] * 12 + [_VP],
    "rt_flash_hopper": [_VP] * 4 + [_I] * 7 + [_LL] * 12 + [_VP],
    "rt_embedding_bag": [_VP] * 3 + [_I] * 5 + [_VP],
    "rt_chase": [_VP, _I, _VP, _VP],
    "rt_empty": [_VP],
}

#: shared memory one block may use on the card (227 KB of the SM's 256 KB)
MAX_SHARED_BYTES = 232_448

_lib = None
#: what the last build printed (``output``), its ptxas register / spill
#: report per kernel (``ptxas``, see ``ptxas_report``) and its ``seconds``
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
    return its path.  Each source is compiled by its own ``nvcc``, all
    started together, and the objects are linked into one library."""
    lib_path = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                               str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    outputs = [p.communicate()[0] for p in procs]
    build_log.update(output="".join(outputs))
    build_log.update(ptxas=ptxas_report(build_log["output"]))
    failed = [(src, p.returncode, out) for src, p, out in zip(SOURCES, procs, outputs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src} ({rc}):\n{out}" for src, rc, out in failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    build_log.update(seconds=time.perf_counter() - t0)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)
    return lib_path


def ptxas_report(output: str) -> dict:
    """Per kernel (mangled name) of ``nvcc -Xptxas -v`` output: registers,
    spill stores and loads and stack bytes; under ``"warnings"`` every
    ptxas warning line (``setmaxnreg`` ignored, ``wgmma`` serialised, ...)."""
    report, name = {"warnings": []}, None
    for line in output.splitlines():
        if "warning" in line and "ptxas" in line:
            report["warnings"].append(line.strip())
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line):
            name = m.group(1)
            report.setdefault(name, {})
        elif name and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m.group(1))
    return report


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


def check_operand(name: str, t, dims: int, device, dtypes=(torch.int32,),
                  inner_contiguous: bool = False) -> None:
    """A kernel operand must be a tensor of one of ``dtypes`` with ``dims``
    dimensions on ``device``, contiguous (or, with ``inner_contiguous``,
    with a contiguous last dimension: the kernel takes the other strides)."""
    ok = t.device == device and t.dtype in dtypes and t.dim() == dims
    if ok:
        ok = (t.stride(-1) == 1 or t.shape[-1] <= 1) if inner_contiguous \
            else t.is_contiguous()
    if not ok:
        names = "/".join(str(d).removeprefix("torch.") for d in dtypes)
        layout = "last-dimension-contiguous" if inner_contiguous else "contiguous"
        raise ValueError(
            f"{name}: expected a {layout} {names} {dims}-D tensor on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
