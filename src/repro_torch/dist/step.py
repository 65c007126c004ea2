"""Training steps over several ranks: the LM step in a placement of its
weights, and the partitioned NequIP step, one process a rank of a
``launch.mesh.RankMesh``.

The LM step (``tp_train_step``) runs ``models.transformer.forward_train``
on the rank's blocks in a ``dist.tp.Layout``: the registry's own
placement (tensor parallelism over ``model``, FSDP over ``data``, experts
over ``model``; its LM train cells on several ranks take this step), or
the expert-parallel one (``ep_param_specs``: a rank holds its ``E / ep``
experts of every MoE layer, the reference's ``shard_map`` in_specs
``P(model, None, F over data)`` with F cut over the data axes with
``ep_fsdp``, and every other parameter whole; ``ep_train_step``).

The gradients (``tp_value_and_grad``).  Each rank backpropagates its own
loss, ``forward_train`` on its data shard: its shard's cross entropy plus
``0.01 / n_groups`` times the auxiliary loss averaged over every rank.
The reference's loss is the mean of those over the data shards.  The
collectives are differentiated exactly (``dist.collectives``) and the
auxiliary loss's mean sums the ranks' cotangents in its backward, so each
rank's routing receives the mean's cotangent once.  After the backward,
with n ranks of which dp along the data axes:

* a leaf whole over ``model`` holds the same share on every model rank
  (the layout's *f* operators sum the cotangents of split products), a
  leaf split over ``model`` its block's; the ranks of one data shard hold
  the same shard's share, so the mean over the ``data`` group is the
  reference's gradient;
* an expert leaf received the cotangents of the ep ranks of its data
  shard (the exchange carries every model rank's copy of the shard's
  tokens), each holding the shard's loss once, so it holds ep times the
  shard's share: the sum over the ``data`` group over n is the
  reference's gradient;
* a leaf sharded over ``data`` (FSDP) has been summed over ``data`` by its
  gather's backward (a reduce-scatter), and only the scale remains.

``mean_over_data`` applies these rules into the moments' layout; AdamW
then runs ZeRO-1 on each rank's moment blocks (``zero1_train_step``), its
clipping norm the whole tree's, each leaf's squares summed over the ranks
that split it."""

from __future__ import annotations

import torch

from repro_torch.dist.collectives import gather_, pmean, reduce_grads_, reduce_scatter_
from repro_torch.dist.sharding import P, local_shard, spec_axes, spec_dims
from repro_torch.dist.tp import Layout
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


def _gather_role(entry, mesh) -> str:
    """The group whose ranks split a dimension over the axes ``entry``
    names (one axis or a tuple, in mesh order): every axis, every data
    axis, or the model axis."""
    names = tuple(entry) if isinstance(entry, tuple) else (entry,)
    for role, axes in (("all", mesh.axis_names), ("data", mesh.dp_axes),
                       ("model", (mesh.model_axis,))):
        if names == tuple(axes):
            return role
    raise ValueError(f"no group of {mesh.axis_names} splits a dimension over {names}")


def unshard_tree(tree, specs, mesh):
    """The whole tensors from this rank's blocks of ``tree`` by ``specs``
    (the inverse of ``shard_tree``): each sharded dimension all-gathered
    over the group of its axes, in rank order, with no gradient."""
    def whole(x, spec):
        for dim, entry in enumerate(spec):
            if entry is not None:
                x = gather_(x, mesh, _gather_role(entry, mesh), dim)
        return x

    return unflatten(tree, [whole(x, s) for x, s in zip(flatten(tree)[0], flatten(specs)[0])])


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


def tp_value_and_grad(cfg, mesh, pspecs, mspecs, params, batch):
    """On every rank of ``mesh`` together: (the reference's loss, this
    rank's blocks of its gradient in the moments' layout ``mspecs``).
    ``params`` are the rank's blocks by ``pspecs``, ``batch`` its rows of
    ``tokens`` and ``labels`` (module docstring)."""
    lay = Layout(cfg, mesh, pspecs, params)
    loss, grads = value_and_grad(
        lambda p, b: tf_mod.forward_train(cfg, p, b["tokens"], b["labels"], layout=lay),
        params, batch)
    return pmean(loss, mesh, "data"), mean_over_data(grads, pspecs, mspecs, mesh,
                                                     over_all=EXPERT_LEAVES)


def tp_train_step(cfg, opt_cfg, mesh, pspecs, mspecs):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    every rank of ``mesh``: ``tp_value_and_grad``, then the ZeRO-1 AdamW
    step (``zero1_train_step``)."""
    return zero1_train_step(
        lambda p, b: tp_value_and_grad(cfg, mesh, pspecs, mspecs, p, b), opt_cfg, mesh,
        pspecs, mspecs)


def ep_value_and_grad(cfg, params, batch):
    """``tp_value_and_grad`` on ``cfg.ep_mesh`` in ``ep_param_specs``'
    layout (moments in the same layout)."""
    specs = ep_param_specs(params, cfg.ep_mesh, cfg.ep_fsdp)
    return tp_value_and_grad(cfg, cfg.ep_mesh, specs, specs, params, batch)


def ep_train_step(cfg, opt_cfg):
    """``tp_train_step`` on ``cfg.ep_mesh`` in ``ep_param_specs``' layout
    (moments in the same layout, so ZeRO-1 shards nothing further)."""

    def step(params, opt_state, batch):
        specs = ep_param_specs(params, cfg.ep_mesh, cfg.ep_fsdp)
        return tp_train_step(cfg, opt_cfg, cfg.ep_mesh, specs, specs)(params, opt_state, batch)

    return step


def zero_dim(ps, ms, ndim: int, mesh):
    """The dimension ZeRO-1 puts the data axes on: the moments' (spec
    ``ms``) data dimension where the parameter's (``ps``) has none, else
    None."""
    pd, md = spec_dims(ps, ndim, mesh)[1], spec_dims(ms, ndim, mesh)[1]
    return md if pd is None and md is not None else None


def mean_over_data(grads, pspecs, mspecs, mesh, over_all=()):
    """Each leaf's gradient of this rank's data shard's loss (a block by
    ``pspecs``) turned into this rank's block, by ``mspecs``, of the mean
    over the ``data`` group: a leaf sharded over ``data`` (FSDP) has been
    summed by its gather's backward and is only scaled; one whose moments
    ZeRO-1 shards is reduce-scattered onto the moments' block; any other is
    all-reduced.  Leaves named in ``over_all`` take the mean over all n
    ranks instead (expert leaves: module docstring)."""
    dpn, n = mesh.group_size("data"), mesh.size
    leaves, paths = flatten(grads)
    out = []
    for g, ps, ms, path in zip(leaves, flatten(pspecs)[0], flatten(mspecs)[0], paths):
        scale = 1.0 / (n if path[-1] in over_all else dpn)
        zd = zero_dim(ps, ms, g.dim(), mesh)
        if spec_dims(ps, g.dim(), mesh)[1] is not None:
            g = g * scale
        elif zd is not None:
            g = reduce_scatter_(g, mesh, "data", zd) * scale
        else:
            reduce_grads_([g], mesh, "data", scale)
        out.append(g)
    return unflatten(grads, out)


def zero1_train_step(value_and_grad_fn, opt_cfg, mesh, pspecs, mspecs):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    every rank of ``mesh``: ``value_and_grad_fn(params, batch)`` gives the
    loss and this rank's gradient blocks in the moments' layout
    (``mspecs``, ``opt_state_specs``'); AdamW then updates the block of each
    parameter that the rank's moments cover, clipping by ``sharded_norm``
    of the blocks, and all-gathers the updated block over ``data`` where
    ``pspecs`` leaves the parameter whole there (ZeRO-1)."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad_fn(params, batch)
        dr, dpn = mesh.group_rank("data"), mesh.group_size("data")
        p_leaves = flatten(params)[0]
        zdims = [zero_dim(ps, ms, p.dim(), mesh) for p, ps, ms in
                 zip(p_leaves, flatten(pspecs)[0], flatten(mspecs)[0])]
        blocks = [p if zd is None else p.narrow(zd, dr * (p.shape[zd] // dpn), p.shape[zd] // dpn)
                  for p, zd in zip(p_leaves, zdims)]
        norm = sharded_norm(grads, mspecs, mesh) if opt_cfg.grad_clip is not None else None
        new_blocks, new_opt = adamw_update(opt_cfg, unflatten(params, blocks), grads, opt_state,
                                           norm=norm)
        new = [b if zd is None else gather_(b, mesh, "data", zd)
               for b, zd in zip(flatten(new_blocks)[0], zdims)]
        return unflatten(params, new), new_opt, loss

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
