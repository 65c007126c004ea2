"""Meshes (counterpart of ``repro.launch.mesh``) and the ranks that run
over one.

A ``Mesh`` is a description: axis names and sizes, no device and no
process.  The production meshes are the reference's TPU pod slices,
``(data 16, model 16)`` and, across two pods, ``(pod 2, data 16, model
16)``; the registry computes its partition specs on them, and the dry run
its per-device bytes.  Nothing here runs at import.

A rank mesh is a ``Mesh`` laid over a started ``torch.distributed``
world, one process a rank, ranks in row-major order of the mesh's
coordinates (rank 1 of a ``(2, 2)`` mesh is ``(data 0, model 1)``).
``init_rank_mesh`` builds the process groups that the multi-rank steps
talk over:

* ``model``: the ranks that share every other coordinate (the expert
  exchange of ``_moe_ffn_ep``);
* ``data``: the ranks that share the ``model`` coordinate, every other
  axis folded into it (the reference's data axes, ``pod`` and ``data``:
  the gradient reduction of replicated leaves and FSDP's gathers);
* ``all``: every rank (NequIP's halo exchange, the loss's sums).

``spawn_ranks`` starts such a world on this host.  The backend is always
the caller's choice: ``"nccl"`` for one rank a card, ``"gloo"`` for
several ranks on one card or on the CPU (gloo stages CUDA tensors through
host memory).  Nothing picks one, and nothing falls back from one to the
other.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
import tempfile
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

MODEL_AXIS = "model"
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh's description: ``axis_names`` and their ``sizes``."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or not self.sizes:
            raise ValueError(f"axes {self.axis_names} do not match sizes {self.sizes}")
        if any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be positive, got {self.sizes}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in mesh order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def model_axis(self) -> str:
        """The tensor-parallel axis: ``"model"`` where the mesh has one,
        else its last (the reference's ``axes_for_mesh``)."""
        return MODEL_AXIS if MODEL_AXIS in self.axis_names else self.axis_names[-1]

    @property
    def dp_axes(self) -> tuple:
        """The data axes: every axis but the model axis, in mesh order."""
        return tuple(a for a in self.axis_names if a != self.model_axis)

    def coords(self, rank: int) -> tuple:
        """The coordinates of ``rank`` (row-major)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        out = []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        r = 0
        for c, s in zip(coords, self.sizes):
            r = r * s + c
        return r


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: ``(data 16, model 16)``, or with
    ``multi_pod`` ``(pod 2, data 16, model 16)``."""
    if multi_pod:
        return Mesh(("pod", "data", MODEL_AXIS), (2, 16, 16))
    return Mesh(("data", MODEL_AXIS), (16, 16))


def make_host_mesh() -> Mesh:
    """The one-device ``(data 1, model 1)`` mesh."""
    return Mesh(("data", MODEL_AXIS), (1, 1))


@dataclasses.dataclass
class RankMesh:
    """One rank's view of a ``Mesh`` laid over a started world.

    ``groups`` maps ``"model"``, ``"data"`` and ``"all"`` to this rank's
    process groups (see the module docstring); ``device`` is the device its
    tensors live on.  ``traffic`` counts what this rank's collectives moved
    (``bytes``: the bytes it sent, ``calls``); with ``timed`` set, each
    collective also synchronizes the device before and after it and adds
    its wall seconds to ``traffic["seconds"]``."""

    mesh: Mesh
    rank: int
    backend: str
    device: torch.device
    groups: dict
    timed: bool = False
    traffic: dict = dataclasses.field(
        default_factory=lambda: {"bytes": 0, "calls": 0, "seconds": 0.0})

    @property
    def shape(self) -> dict:
        return self.mesh.shape

    @property
    def axis_names(self) -> tuple:
        return self.mesh.axis_names

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def model_axis(self) -> str:
        return self.mesh.model_axis

    @property
    def dp_axes(self) -> tuple:
        return self.mesh.dp_axes

    @property
    def coords(self) -> tuple:
        return self.mesh.coords(self.rank)

    def group_size(self, role: str) -> int:
        return dist.get_world_size(self.groups[role])

    def group_rank(self, role: str) -> int:
        return dist.get_rank(self.groups[role])

    def reset_traffic(self) -> None:
        self.traffic.update(bytes=0, calls=0, seconds=0.0)


def init_rank_mesh(shape, axes, backend: str, device) -> RankMesh:
    """This rank's ``RankMesh`` over the started default group, whose world
    size must be the mesh's size.  Every rank calls it, in the same order
    as every other collective: it creates each axis's groups collectively."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("init_rank_mesh runs inside a started world (spawn_ranks)")
    mesh = Mesh(tuple(axes), tuple(int(s) for s in shape))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} ranks in a world of {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the world runs {dist.get_backend()!r}, not {backend!r}")
    m_ax = mesh.axis_names.index(mesh.model_axis)
    ranks = [mesh.coords(r) for r in range(world)]

    def groups_by(key):
        """One group per value of ``key(coords)``, created on every rank in
        the same order; this rank's."""
        mine = None
        for k in sorted({key(c) for c in ranks}):
            members = [r for r, c in enumerate(ranks) if key(c) == k]
            g = dist.new_group(members, backend=backend)
            if rank in members:
                mine = g
        return mine

    groups = {
        "model": groups_by(lambda c: c[:m_ax] + c[m_ax + 1:]),
        "data": groups_by(lambda c: c[m_ax]),
        "all": dist.group.WORLD,
    }
    return RankMesh(mesh=mesh, rank=rank, backend=backend, device=torch.device(device),
                    groups=groups)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, shape, axes, backend, device, port, out_dir, args, timeout_s):
    dev = torch.device(str(device).format(rank=rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // math.prod(shape)))
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=math.prod(shape),
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    try:
        rm = init_rank_mesh(shape, axes, backend, dev)
        result = fn(rm, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    except BaseException:
        # every rank's own failure, for spawn_ranks to report (the spawn
        # context raises only the first it sees, often a peer's lost link)
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, shape, backend: str, device, args: tuple = (),
                axes=("data", MODEL_AXIS), timeout_s: float = 600.0) -> list[Any]:
    """Run ``fn(rank_mesh, *args)`` on every rank of a ``shape`` mesh of
    ``axes``: one process a rank, started with the ``spawn`` method,
    rendezvous on 127.0.0.1 at a free port.  ``device`` is each rank's
    device; ``"{rank}"`` in it takes the rank (``"cuda:{rank}"``: one card
    a rank).  ``fn`` must be importable (a module-level function) and
    ``args`` picklable.  Returns the ranks' return values in rank order,
    each passed through ``torch.save``/``torch.load`` onto the CPU.
    Raises ``RuntimeError`` if any rank raises or exits non-zero (the
    others are stopped), with every rank's traceback that was written, or
    if a collective waits longer than ``timeout_s``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    n = math.prod(shape)
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            torch.multiprocessing.start_processes(
                _rank_main, nprocs=n, join=True, start_method="spawn",
                args=(fn, tuple(shape), tuple(axes), backend, str(device), free_port(),
                      out_dir, tuple(args), timeout_s))
        except Exception as e:
            errs = [f"-- rank {r}:\n{open(p).read()}" for r in range(n)
                    if os.path.exists(p := os.path.join(out_dir, f"rank{r}.err"))]
            raise RuntimeError(f"{fn.__name__} failed on a {tuple(shape)} mesh:\n{e}\n"
                               + "\n".join(errs)) from e
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(n)]
