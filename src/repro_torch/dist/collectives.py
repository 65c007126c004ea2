"""Collectives of the multi-rank steps, over a ``launch.mesh.RankMesh``'s
groups, with the autograd rules those steps need.

Each is the reference's collective inside ``shard_map``:

* ``all_to_all``: ``jax.lax.all_to_all(tiled=True)`` with equal splits
  along dimension 0.  The exchange is its own transpose, so its backward is
  the same exchange of the gradient.
* ``all_gather``: ``jax.lax.all_gather(tiled=True)`` along a dimension.
  Its backward is the transpose, a reduce-scatter (sum): an exchange of the
  gradient's blocks and a local sum in f32.
* ``psum``: a sum over the group whose backward passes the gradient on
  unchanged.  Every rank holds the same sum and backpropagates the same
  cotangent into its own part, so the parts' gradients are those of the
  sum once, not once a rank.  ``pmean`` is ``psum`` over the group's size.
* ``all_reduce_mean``: the mean whose backward sums the ranks' cotangents
  (``torch.distributed.nn``'s ``all_reduce`` rule), for a mean that every
  rank adds to its own loss: each rank's part then receives the mean's
  cotangent once, as the mean over ranks of those losses asks.
* ``sum_grad``: the identity whose backward sums the cotangent over the
  group (Megatron's *f*; ``psum`` is its *g*).  A tensor that every rank
  of the group holds alike and feeds into its own block of a sharded
  product receives only that block's part of its cotangent on each rank;
  the sum makes it the whole cotangent on every rank.
* ``pmax``: the maximum over the group, without a gradient (a
  log-sum-exp's shift).

The exchanges move bytes: a tensor travels as its uint8 view (gloo
refuses some dtypes, int16 among them), so every dtype takes one path on
both backends.  Sums reduce in f32.  A group of one rank still calls its backend
(NCCL's path is then launched on one card), except ``reduce_grads_``,
which has nothing to reduce there.

Each call adds the bytes it sends to other ranks to ``mesh.traffic``
(``all_to_all``: (n-1)/n of its input; ``all_gather``: n-1 times its
block; an all-reduce, by a ring: 2(n-1)/n of its input); with
``mesh.timed`` it also synchronizes the device around the call and adds its
seconds (gloo stages CUDA tensors through host memory: that time is the
staging's)."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor (its last dimension times its
    element size), which every backend moves whatever the dtype."""
    return t.view(torch.uint8)


class _Account:
    """Adds one collective's bytes (and, timed, seconds) to ``mesh.traffic``."""

    def __init__(self, mesh, nbytes: float):
        self.mesh, self.nbytes = mesh, nbytes

    def __enter__(self):
        if self.mesh.timed and self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.mesh.timed and self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        tr = self.mesh.traffic
        tr["bytes"] += int(self.nbytes)
        tr["calls"] += 1
        if self.mesh.timed:
            tr["seconds"] += time.perf_counter() - self.t0
        return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _a2a(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    group = mesh.groups[role]
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all over {n} ranks of a leading dimension {x.shape[0]}")
    x = x.contiguous()
    out = torch.empty_like(x)
    with _Account(mesh, _nbytes(x) * (n - 1) / n):
        dist.all_to_all_single(_bits(out), _bits(x), group=group)
    return out


def _gather(x: torch.Tensor, mesh, role: str, dim: int) -> torch.Tensor:
    group = mesh.groups[role]
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    with _Account(mesh, _nbytes(x) * (n - 1)):
        dist.all_gather([_bits(p) for p in parts], _bits(x), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(g: torch.Tensor, mesh, role: str, dim: int) -> torch.Tensor:
    """Sum over the group of ``g``, each rank keeping its block along
    ``dim``: the blocks exchanged, then summed in f32."""
    n = mesh.group_size(role)
    blocks = g.movedim(dim, 0)
    blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:])
    got = _a2a(blocks, mesh, role)
    return got.float().sum(0).to(g.dtype).movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, role):
        ctx.mesh, ctx.role = mesh, role
        return _a2a(x, mesh, role)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.role), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, role, dim):
        ctx.mesh, ctx.role, ctx.dim = mesh, role, dim
        return _gather(x, mesh, role, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.role, ctx.dim), None, None, None


def _sum(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    out = x.detach().float().clone()
    n = mesh.group_size(role)
    with _Account(mesh, _nbytes(out) * 2 * (n - 1) / n):
        dist.all_reduce(out, group=mesh.groups[role])
    return out.to(x.dtype)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, role):
        return _sum(x, mesh, role)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, role):
        ctx.mesh, ctx.role = mesh, role
        return _sum(x, mesh, role)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.role), None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, role):
        ctx.mesh, ctx.role = mesh, role
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.role), None, None


def all_to_all(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    """Block j of ``x``'s dimension 0 (split into the group's size) goes to
    the group's rank j; block i of the result came from rank i."""
    return _AllToAll.apply(x, mesh, role)


def all_gather(x: torch.Tensor, mesh, role: str, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order."""
    return _AllGather.apply(x, mesh, role, dim)


def psum(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    """The sum over the group (in f32, cast back); the gradient passes
    through unchanged (module docstring)."""
    return _PSum.apply(x, mesh, role)


def pmean(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    return psum(x, mesh, role) / mesh.group_size(role)


def all_reduce_mean(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    """The mean over the group, whose backward all-reduces the cotangent:
    each rank's part receives the sum of every rank's cotangent of the
    mean (module docstring)."""
    return _AllReduce.apply(x, mesh, role) / mesh.group_size(role)


def sum_grad(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    """``x`` unchanged; its cotangent summed over the group in the
    backward (in f32, cast back; module docstring)."""
    return _SumGrad.apply(x, mesh, role)


@torch.no_grad()
def pmax(x: torch.Tensor, mesh, role: str) -> torch.Tensor:
    """The elementwise maximum over the group, no gradient."""
    out = x.detach().clone().contiguous()
    n = mesh.group_size(role)
    with _Account(mesh, _nbytes(out) * 2 * (n - 1) / n):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.groups[role])
    return out


@torch.no_grad()
def reduce_scatter_(g: torch.Tensor, mesh, role: str, dim: int) -> torch.Tensor:
    """The sum over the group of ``g``, this rank keeping its block along
    ``dim`` (the backward of ``all_gather``, for a gradient reduced after
    the backward)."""
    return _reduce_scatter(g, mesh, role, dim)


@torch.no_grad()
def gather_(x: torch.Tensor, mesh, role: str, dim: int) -> torch.Tensor:
    """``all_gather`` without a gradient."""
    return _gather(x, mesh, role, dim)


@torch.no_grad()
def reduce_grads_(tensors, mesh, role: str, scale: float = 1.0) -> None:
    """Sum each tensor over the group in place (in f32), times ``scale``.
    A group of one rank only scales."""
    n = mesh.group_size(role)
    for t in tensors:
        if n > 1:
            acc = t.float().contiguous()
            with _Account(mesh, _nbytes(acc) * 2 * (n - 1) / n):
                dist.all_reduce(acc, group=mesh.groups[role])
            t.copy_(acc * scale if scale != 1.0 else acc)
        elif scale != 1.0:
            t.mul_(scale)
