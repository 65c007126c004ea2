"""Call recorder of the counted kernel wrappers.

Each counted wrapper (``backward_search``, ``ilcp_list``, ``pdl_gather``,
``rank``, ``rmq``, ``sada_c_list``, ``wt_list``) calls
``record(name, *operands)`` where it commits to computing: past its
closed-form empty answers, before it picks the kernel (CUDA tensors) or
the plain version (CPU tensors).  Nothing is recorded unless a
``record_calls()`` context is open, so outside an audit the call costs one
test.  ``repro_torch.analysis`` reads the record: the wrappers called by
one run of an endpoint program, in order, with their operands' dtypes and
devices.

The recorder is separate from the wrappers' ``launches`` counters, which
count where a kernel launches and nowhere else.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One wrapper call: its name, and the dtype and device of every tensor
    operand (index objects walked field by field), in argument order."""

    name: str
    dtypes: tuple
    devices: tuple


_open: list = []  # the open recorders, innermost last


def tensors_of(x):
    """Every tensor in ``x``: a tensor, a dataclass (its fields, nested
    index objects too), or a tuple or list of those."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from tensors_of(getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors_of(v)


def dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def record(name: str, *operands) -> None:
    """Record one call of wrapper ``name`` in every open recorder."""
    if not _open:
        return
    ts = list(tensors_of(operands))
    call = KernelCall(name, tuple(dtype_name(t) for t in ts), tuple(str(t.device) for t in ts))
    for calls in _open:
        calls.append(call)


@contextlib.contextmanager
def record_calls():
    """Record the wrapper calls made inside the block: yields the list the
    calls are appended to (``KernelCall``s, in call order)."""
    calls: list = []
    _open.append(calls)
    try:
        yield calls
    finally:
        _open[:] = [c for c in _open if c is not calls]
