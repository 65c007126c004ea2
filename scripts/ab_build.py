"""Builds of one kernel source (``retrieval_kernels.cu`` by default) for
the A/B scripts (``pdl_gather_ab.py``, ``sada_c_ab.py``,
``embedding_bag_ab.py``): another checkout's sources, or this tree's with
text edits, each compiled by its own ``nvcc`` into its own library and bound
to the launchers an A/B script calls.  Needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import require  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

KERNELS = "retrieval_kernels.cu"


def bind(cdll: ctypes.CDLL, launchers) -> ctypes.CDLL:
    """``cdll`` with each launcher's C signature from ``_build.SIGNATURES``."""
    for name in launchers:
        getattr(cdll, name).argtypes = _build.SIGNATURES[name]
        getattr(cdll, name).restype = ctypes.c_int
    return cdll


def ptxas_line(label: str, report: dict, kernel: str) -> str:
    """ptxas's report of the kernels whose name holds ``kernel``, one line."""
    return f"[ab] {label} ptxas: " + json.dumps({k: v for k, v in report.items() if kernel in k})


def build_libraries(jobs, launchers, kernel: str, source: str = KERNELS) -> dict:
    """{label: library} of each (label, csrc, out) in ``jobs``: ``csrc``'s
    ``source`` compiled by its own nvcc into ``out``, all started together,
    bound to ``launchers``; prints ptxas's report of the kernels named
    ``kernel``."""
    procs = {}
    for label, csrc, out in jobs:
        lib = os.path.join(out, f"lib{label}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc, "-o", lib,
               os.path.join(csrc, source)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        output = proc.communicate()[0]
        require(proc.returncode == 0, f"nvcc of {label} failed:\n{output}")
        print(ptxas_line(label, _build.ptxas_report(output), kernel), flush=True)
        libs[label] = bind(ctypes.CDLL(lib), launchers)
    return libs


def build_library(csrc: str, out: str, label: str, launchers, kernel: str) -> ctypes.CDLL:
    """``csrc``'s retrieval kernels, built by nvcc into ``out`` and bound to
    ``launchers``; prints ptxas's report of the kernels named ``kernel``."""
    return build_libraries([(label, csrc, out)], launchers, kernel)[label]


def variant_sources(name: str, edits, out: str) -> str:
    """A copy of this tree's sources with ``edits`` (file, old text, new
    text; the old text occurs once) made, under ``out/name``."""
    dst = os.path.join(out, name)
    shutil.copytree(_build.CSRC, dst)
    for fname, old, new in edits:
        path = os.path.join(dst, fname)
        with open(path) as f:
            text = f.read()
        require(text.count(old) == 1, f"variant {name}: edit not found once in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst
