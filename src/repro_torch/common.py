"""Common helpers: dtype policy, device choice, tensor dataclasses, bit math.

Every index structure in ``repro_torch`` is a plain ``@dataclass`` whose
array fields are tensors and whose integer metadata are Python ints.  The
``TensorDataclass`` mixin gives each one a ``.to(device)`` that moves every
tensor field (recursing into nested index objects) and keeps the metadata.

Index tensors are int32.  Bit words are stored as int32 *bit patterns*
(the reference keeps them as uint32), so a word compares element for
element with the reference's through ``np.ndarray.view(np.int32)``.  Bit
arithmetic on words widens to int64 and masks with ``0xFFFFFFFF``: torch
has no unsigned 32-bit shifts on the CPU and ``>>`` on int32 is arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Default integer dtype for index structures (all supported n < 2^31).
IDX = torch.int32

#: Word width of plain bitvectors.
WORD_BITS = 32

#: Sentinel larger than every document id (sort key of padding slots).
BIG = int(np.iinfo(np.int32).max)


# ---------------------------------------------------------------------------
# Devices and tensor dataclasses
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device without CUDA
    raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


class TensorDataclass:
    """Mixin for index dataclasses: ``.to(device)`` moves every tensor
    field (and every nested index object) and keeps the metadata."""

    def to(self, device):
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorDataclass)):
                changes[f.name] = v.to(device)
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        """The device of the first tensor field (all fields share one)."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorDataclass)):
                return v.device
        raise ValueError(f"{type(self).__name__} has no tensor field")


# ---------------------------------------------------------------------------
# Small math helpers (host-side, used at build time)
# ---------------------------------------------------------------------------


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ceil_log2(x: int) -> int:
    """ceil(lg x) for x >= 1; 0 for x <= 1."""
    if x <= 1:
        return 0
    return int(x - 1).bit_length()


def floor_log2(x: int) -> int:
    if x < 1:
        raise ValueError("floor_log2 requires x >= 1")
    return int(x).bit_length() - 1


def delta_code_len(v: int) -> int:
    """Length in bits of the Elias delta code of v >= 1 (modeled space)."""
    if v < 1:
        raise ValueError("delta codes encode positive integers")
    n = floor_log2(v)
    nn = floor_log2(n + 1)
    return 2 * nn + 1 + n


def gamma_code_len(v: int) -> int:
    if v < 1:
        raise ValueError("gamma codes encode positive integers")
    return 2 * floor_log2(v) + 1


def elias_fano_bits(m: int, n: int) -> int:
    """Modeled size in bits of a sparse bitmap with m ones out of n
    positions (Okanohara & Sadakane 2007): m*ceil(lg(n/m)) + 2m."""
    if m == 0:
        return 0
    low = max(0, ceil_log2(max(1, n // m)))
    return m * low + 2 * m


# ---------------------------------------------------------------------------
# Tensor helpers
# ---------------------------------------------------------------------------


def as_i32(x, device=None) -> torch.Tensor:
    """int32 tensor of ``x`` (numpy array, list, scalar or tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=IDX)
    return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)


def batch_of_one(x, device) -> torch.Tensor:
    """int32[1] on ``device`` from a Python int or a one-element tensor:
    the batch a single-query function hands its batch counterpart."""
    return as_i32(x, device).reshape(1)


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values, as int64."""
    return words.to(torch.int64) & 0xFFFFFFFF


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> int32 bit patterns."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(IDX)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of unsigned 32-bit values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def rank1_words(words: torch.Tensor, ones_prefix: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Ones in bits [0, pos) of a packed bitvector: the prefix count of
    whole words plus the popcount of the masked partial word."""
    pos = pos.to(torch.int64)
    w = pos >> 5
    mask = (torch.ones_like(pos) << (pos & 31)) - 1
    pc = popcount32(u32(words[w]) & mask)
    return (ones_prefix[w].to(torch.int64) + pc).to(IDX)


def floor_log2_t(x: torch.Tensor) -> torch.Tensor:
    """floor(lg x) for integer tensors x >= 1 (31 - clz), exact."""
    x64 = x.to(torch.int64)
    k = torch.floor(torch.log2(x64.to(torch.float64))).to(torch.int64)
    k = torch.where((1 << (k + 1)) <= x64, k + 1, k)
    k = torch.where((1 << k) > x64, k - 1, k)
    return k.to(IDX)


def searchsorted_i32(seq: torch.Tensor, values: torch.Tensor,
                     right: bool = False) -> torch.Tensor:
    return torch.searchsorted(seq, values.to(seq.dtype).contiguous(),
                              right=right, out_int32=True)


def arange_i32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=IDX, device=device)


def lexsort_rows(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Row-wise permutation (int64[B, W]) that orders each row by
    ``primary`` ascending, ties by ``secondary`` ascending: two stable
    sorts, the secondary key first (``np.lexsort((secondary, primary))``
    per row)."""
    order = torch.sort(secondary, dim=1, stable=True).indices
    p = torch.gather(primary, 1, order)
    return torch.gather(order, 1, torch.sort(p, dim=1, stable=True).indices)
