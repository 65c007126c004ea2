"""Embedding bag (gather rows, reduce per bag): the Hopper kernel, its plain
version and the wrapper (counterpart of ``repro.kernels.embedding_bag`` and
``repro.kernels.ops.embedding_bag``).

Bags come in the padded layout: ``padded_idx`` int32 [B, L], each row a
bag's row indices into ``table`` [V, D], negative entries (-1) padding.
``out[b] = sum of table[i] over the bag's entries`` (``"sum"``), divided by
``max(count, 1)`` for ``"mean"``; an empty bag gives zeros.  Both versions
accumulate in f32 in index order and round once to the table's dtype.

The kernel (``csrc/model_kernels.cu``, ``embedding_bag_kernel``; its
lane-group logic in ``csrc/embedding_bag_core.cuh``) gives each bag a group
of lanes sized to the row, each lane one vector of up to 16 bytes, and keeps
several rows in flight a lane (bags of one: several bags a group), for f32
and bf16 tables of up to 2^31 - 1 rows.  The vector width follows the row's
bytes and the table's and output's base addresses.  Indices must lie in
[0, V) or be negative; the wrapper does not read them back to check.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

MODES = ("sum", "mean")
#: table dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)


def _check_mode(*, mode):
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, got {mode!r}")


def embedding_bag_plain(table, padded_idx, *, mode="sum"):
    """Plain PyTorch version (the semantics of ``ref.embedding_bag_ref`` on
    the padded layout): [B, D] in the table's dtype."""
    _check_mode(mode=mode)
    B, L = padded_idx.shape
    valid = padded_idx >= 0
    safe = padded_idx.clamp(min=0).long()
    acc = torch.zeros(B, table.shape[1], dtype=torch.float32, device=table.device)
    for t in range(L):
        acc += torch.where(valid[:, t, None], table[safe[:, t]].float(), 0.0)
    if mode == "mean":
        acc = acc / valid.sum(dim=1).clamp(min=1).float()[:, None]
    return acc.to(table.dtype)


def embedding_bag(table, padded_idx, *, mode="sum"):
    """Per-bag sum or mean of ``table`` [V, D] (f32 or bf16) rows named by
    ``padded_idx`` int32 [B, L] (-1 = padding): [B, D] in the table's dtype.

    On CUDA tensors this launches the kernel (counted in
    ``embedding_bag.launches``); on CPU tensors it runs the plain version.
    An empty output (``B == 0`` or ``D == 0``) launches nothing."""
    _check_mode(mode=mode)
    dev = padded_idx.device
    if dev.type != "cuda":
        return embedding_bag_plain(table, padded_idx, mode=mode)
    _build.check_operand("table", table, 2, dev, dtypes=DTYPES)
    _build.check_operand("padded_idx", padded_idx, 2, dev)
    B, L = padded_idx.shape
    V, D = table.shape
    if V >= 2**31:
        raise ValueError(f"embedding_bag: {V} rows do not fit int32 indices")
    out = torch.empty(B, D, dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    err = _build.library().rt_embedding_bag(
        table.data_ptr(), padded_idx.data_ptr(), out.data_ptr(), B, L, D,
        int(mode == "mean"), int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0


def csr_to_padded(indices, offsets, max_len: int):
    """CSR bags (``indices``, ``offsets`` with bag b at
    ``indices[offsets[b]:offsets[b+1]]``) to the padded int32 [B, max_len]
    layout, a CPU tensor; bags longer than ``max_len`` keep their first
    ``max_len`` entries (as ``repro.kernels.embedding_bag.csr_to_padded``
    does)."""
    indices = torch.as_tensor(np.asarray(indices, np.int32))
    offsets = torch.as_tensor(np.asarray(offsets, np.int64))
    pos = offsets[:-1, None] + torch.arange(max_len)[None, :]
    keep = pos < offsets[1:, None]
    out = torch.full((offsets.numel() - 1, max_len), -1, dtype=torch.int32)
    out[keep] = indices[pos[keep]]
    return out
