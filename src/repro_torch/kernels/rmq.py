"""Batched sparse-table RMQ (leftmost argmin): the Hopper kernel, its plain
version and the wrapper (counterpart of ``repro.kernels.rmq`` and
``repro.kernels.ops.rmq``).

For the inclusive range [lo, hi] with ``span = max(hi - lo + 1, 1)`` and
``k = floor(lg span)`` (clipped to the table's levels), the answer is the
leftmost minimum of the two table entries ``T[k, lo]`` and
``T[k, max(hi - 2^k + 1, lo)]``; ``hi < lo`` answers the span-1 query at
``lo``.  The kernel (``csrc/retrieval_kernels.cu``, ``rmq_kernel``) runs one
thread per query over ``rt::rmq_leftmost`` of ``retrieval_core.cuh``, the
helper the fused ILCP listing calls once per pop.
"""

from __future__ import annotations

import torch

from repro_torch.common import IDX
from repro_torch.kernels import _build
from repro_torch.kernels._record import record
from repro_torch.succinct.rmq import leftmost_argmin


def rmq_plain(values, table, lo, hi):
    """Plain PyTorch version of the kernel (mirrors
    ``repro.kernels.ref.rmq_ref``): int32[Q] positions into ``values``."""
    return leftmost_argmin(values, table, lo, hi)


def rmq(values, table, lo, hi):
    """Leftmost argmin of ``values[lo..hi]`` (inclusive; int32[Q] each,
    ``0 <= lo, hi < rho``) through the sparse ``table`` (int32[levels, rho]):
    int32[Q].

    On CUDA tensors this launches the kernel (counted in ``rmq.launches``);
    on CPU tensors it runs the plain version.  ``Q == 0`` has a closed-form
    empty answer and launches nothing."""
    dev = lo.device
    if lo.shape[0]:
        record("rmq", values, table, lo, hi)
    if dev.type != "cuda":
        return rmq_plain(values, table, lo, hi)
    for name, t, dims in (("values", values, 1), ("table", table, 2),
                          ("lo", lo, 1), ("hi", hi, 1)):
        _build.check_operand(name, t, dims, dev)
    levels, rho = table.shape
    Q = lo.shape[0]
    if values.shape[0] != rho or hi.shape[0] != Q:
        raise ValueError("rmq: inconsistent operand shapes")
    out = torch.empty(Q, dtype=IDX, device=dev)
    if Q == 0:
        return out
    err = _build.library().rt_rmq(
        values.data_ptr(), table.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), Q, levels, rho, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "rmq")
    rmq.launches += 1
    return out


rmq.launches = 0
