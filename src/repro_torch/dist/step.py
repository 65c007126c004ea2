"""Training steps over several ranks: the expert-parallel LM step and the
partitioned NequIP step, one process a rank of a ``launch.mesh.RankMesh``.

The expert-parallel layout (``ep_param_specs``).  A rank holds its
``E / ep`` experts of every MoE layer (the reference's ``shard_map``
in_specs ``P(model, None, F over data)``: F is cut over the data axes with
``ep_fsdp``) and every other parameter whole.  The registry's specs also
place the dense weights tensor-parallel and, with FSDP, over the data
axes; that placement is GSPMD's in the reference and is not run here.

The gradients (``ep_value_and_grad``).  Each rank backpropagates its own
loss, ``forward_train`` on its data shard: its shard's cross entropy plus
``0.01 / n_groups`` times the auxiliary loss averaged over every rank.
The reference's loss is the mean of those over the data shards.  The
exchanges are differentiated exactly (``dist.collectives``) and the
auxiliary loss's mean sums the ranks' cotangents in its backward, so each
rank's routing receives the mean's cotangent once.  After the backward,
with n ranks of which dp along the data axes:

* a replicated leaf holds its rank's share; the ranks of one data shard
  hold the same share, so the mean over the ``data`` group is the
  reference's gradient;
* an expert leaf received the cotangents of the ep ranks of its data
  shard, each holding the shard's loss once, so it holds ep times the
  shard's share: the sum over the ``data`` group over n is the
  reference's gradient; with ``ep_fsdp`` the gather's backward has already
  summed over ``data`` (a reduce-scatter), and only the 1/n remains.

AdamW then runs on each rank's own shards; its clipping norm is the whole
tree's, each leaf's squares summed over the ranks that split it."""

from __future__ import annotations

import torch

from repro_torch.dist.collectives import pmean, reduce_grads_
from repro_torch.dist.sharding import P, local_shard, spec_axes
from repro_torch.models import transformer as tf_mod
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.tree import flatten, unflatten

EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def ep_param_specs(params, mesh, fsdp: bool) -> dict:
    """Each leaf's spec in the expert-parallel layout on ``mesh`` (a
    ``Mesh`` or a ``RankMesh``; module docstring)."""
    mdl, dp = mesh.model_axis, mesh.dp_axes
    dp = (dp if len(dp) > 1 else dp[0]) if dp else None
    _, paths = flatten(params)

    def spec(path):
        name = path[-1]
        if name not in EXPERT_LEAVES:
            return P()
        if not fsdp:
            return P(None, mdl)
        return P(None, mdl, dp, None) if name == "we_down" else P(None, mdl, None, dp)

    return unflatten(params, [spec(p) for p in paths])


def shard_tree(tree, specs, mesh):
    """This rank's blocks of ``tree``'s leaves by ``specs``: a replicated
    leaf as it is, a sharded one as a contiguous copy of its block."""
    coords = dict(zip(mesh.axis_names, mesh.coords))
    return unflatten(tree, [local_shard(x, s, mesh.shape, coords).contiguous()
                            for x, s in zip(flatten(tree)[0], flatten(specs)[0])])


def _role(axes: tuple, mesh) -> str | None:
    """The group whose ranks split a leaf sharded over ``axes``."""
    if not axes:
        return None
    has_model = mesh.model_axis in axes
    has_data = any(a in mesh.dp_axes for a in axes)
    return "all" if has_model and has_data else "model" if has_model else "data"


def sharded_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of the tree that ``grads`` are this rank's blocks
    of: each leaf's f32 squares summed over the ranks that split it."""
    parts: dict = {}
    for g, s in zip(flatten(grads)[0], flatten(specs)[0]):
        role = _role(spec_axes(s), mesh)
        parts[role] = parts.get(role, 0) + torch.sum(torch.square(g.float()))
    total = 0
    for role, sq in parts.items():
        if role is not None:
            sq = torch.as_tensor(sq, dtype=torch.float32).reshape(1)
            reduce_grads_([sq], mesh, role)
        total = total + sq
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32).reshape(()))


def ep_value_and_grad(cfg, params, batch):
    """On every rank of ``cfg.ep_mesh`` together: (the reference's loss,
    this rank's blocks of its gradient).  ``params`` are the rank's blocks
    in ``ep_param_specs``' layout, ``batch`` its data shard of ``tokens``
    and ``labels``."""
    mesh = cfg.ep_mesh
    loss, grads = value_and_grad(
        lambda p, b: tf_mod.forward_train(cfg, p, b["tokens"], b["labels"]), params, batch)
    n, dpn = mesh.size, mesh.group_size("data")
    rep, experts = [], []
    for g, s in zip(flatten(grads)[0], flatten(ep_param_specs(params, cfg.ep_mesh, cfg.ep_fsdp))[0]):
        (experts if spec_axes(s) else rep).append(g)
    reduce_grads_(rep, mesh, "data", 1.0 / dpn)
    if cfg.ep_fsdp and dpn > 1:
        for g in experts:
            g.mul_(1.0 / n)
    else:
        reduce_grads_(experts, mesh, "data", 1.0 / n)
    return pmean(loss, mesh, "data"), grads


def ep_train_step(cfg, opt_cfg):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    every rank of ``cfg.ep_mesh``: ``ep_value_and_grad``, then AdamW on the
    rank's blocks (moments in the same layout)."""

    def step(params, opt_state, batch):
        loss, grads = ep_value_and_grad(cfg, params, batch)
        norm = None
        if opt_cfg.grad_clip is not None:
            norm = sharded_norm(grads, ep_param_specs(params, cfg.ep_mesh, cfg.ep_fsdp), cfg.ep_mesh)
        new_params, new_opt = adamw_update(opt_cfg, params, grads, opt_state, norm=norm)
        return new_params, new_opt, loss

    return step


def partitioned_value_and_grad(loss_fn, mesh, params, batch):
    """(loss, gradient) of a partitioned NequIP ``loss_fn`` on every rank
    of ``mesh`` together: each rank's gradient summed over the ranks."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    reduce_grads_(flatten(grads)[0], mesh, "all")
    return loss, grads


def partitioned_train_step(loss_fn, mesh, opt_cfg):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` of a
    partitioned NequIP ``loss_fn``: replicated parameters and moments, the
    summed gradient, AdamW on every rank alike."""

    def step(params, opt_state, batch):
        loss, grads = partitioned_value_and_grad(loss_fn, mesh, params, batch)
        new_params, new_opt = adamw_update(opt_cfg, params, grads, opt_state)
        return new_params, new_opt, loss

    return step
