"""The docs axis of the sharded retrieval service (counterpart of the
docs-axis part of ``repro.dist.sharding``).

Documents are split into contiguous shards (``doc_shard_bounds``); each
shard indexes its own sub-collection (``core.suffix.subcollection``) and
the service merges the shards' answers exactly.

Placement.  The reference places every shard's index leaves replicated on
every device of its ``docs`` mesh (its module docstring, "Placement
note"), so each device holds every shard's stack.  The counterpart on one
card is every shard's stack on that card: the port's docs mesh is the
shard count and one device, and needs no device per shard.  Placing shard
s on ``cuda:s`` over ``torch.distributed`` is later work.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import resolve_device

DOCS_AXIS = "docs"


@dataclasses.dataclass(frozen=True)
class DocsMesh:
    """A 1-D ``docs`` mesh: ``n_shards`` document shards, every shard's
    index stack on ``device``."""

    n_shards: int
    device: torch.device


def make_docs_mesh(n_shards: int, device="cuda") -> DocsMesh:
    """The docs mesh of ``n_shards`` shards on ``device`` (the card unless
    the caller asks for the CPU)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return DocsMesh(n_shards=int(n_shards), device=resolve_device(device))


def docs_mesh_size(mesh: DocsMesh) -> int:
    return mesh.n_shards


def doc_shard_bounds(d: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous document ranges [dlo, dhi) per shard, balanced to within
    one document.  Every shard owns at least one document."""
    if n_shards > d:
        raise ValueError(
            f"n_shards={n_shards} > d={d}: every shard must own >= 1 document"
        )
    base, extra = divmod(d, n_shards)
    bounds = []
    lo = 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds
