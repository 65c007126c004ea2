"""Carry an index built elsewhere into the port.

``from_numpy`` takes the fields of an index object as a (nested) dict of
numpy arrays and Python scalars — the layout of the reference package's
CSA, ILCP, Sada, PDL (listing and top-k) and wavelet/bitvector dataclasses,
keyed by field name — and returns the port's index object on a device.
uint32 bit words become their int32 bit patterns.  A field typed as a
union of bitvectors (Sada's ``hp``: plain, RLE or sparse) takes the type
whose fields the dict holds, so every Sada variant, C's sparse-table RMQ
and the DA wavelet matrix carry across as they are.

``service_from_numpy`` assembles a ``RetrievalService`` from such dicts, so
the port's query path can be held against the reference on the identical
index, separately from build parity.

``lm_params_from_numpy`` and ``lm_cache_from_numpy`` do the same for the
dense LM: the reference's parameter or KV-cache pytree as (nested) dicts of
numpy arrays (bf16 arrays as the ``bfloat16`` numpy dtype the reference
hands out) become the port's dict of tensors, so both packages compute the
same function on the same weights.

``recsys_params_from_numpy`` carries a recsys model's parameter pytree
(dicts and lists of numpy arrays), each leaf in its own dtype: the
serving copy mixes bf16 tables with f32 MLPs.

``nequip_params_from_numpy`` carries NequIP's parameter pytree (a dict
whose ``layers`` is a list of per-layer dicts).
"""

from __future__ import annotations

import dataclasses
import types
import typing

import numpy as np
import torch

from repro_torch.common import TensorDataclass, resolve_device
from repro_torch.core.csa import CSA
from repro_torch.core.ilcp import ILCPIndex
from repro_torch.core.pdl import PDLIndex
from repro_torch.core.sada import VARIANTS, SadaCount
from repro_torch.core.suffix import Collection
from repro_torch.models import nequip, recsys
from repro_torch.models.transformer import LMConfig, param_shapes
from repro_torch.serve.retrieval import RetrievalService
from repro_torch.train.tree import map_leaves


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def from_numpy(cls, fields: dict, device="cuda"):
    """Build a ``cls`` index object from a dict of its fields.  A field of
    a union of index types takes the member whose fields the dict holds."""
    dev = resolve_device(device)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        kind = hints[f.name]
        if isinstance(kind, types.UnionType) and isinstance(v, dict):
            kind = next(k for k in typing.get_args(kind)
                        if isinstance(k, type) and issubclass(k, TensorDataclass)
                        and all(g.name in v for g in dataclasses.fields(k)))
        if isinstance(kind, type) and issubclass(kind, TensorDataclass):
            kwargs[f.name] = from_numpy(kind, v, dev)
        elif kind is torch.Tensor:
            kwargs[f.name] = _tensor(v, dev)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def service_from_numpy(coll: Collection, csa: dict, ilcp: dict, sada: dict,
                       pdl_list: dict, da, pdl_topk: dict | None = None,
                       device="cuda", **knobs) -> RetrievalService:
    """A ``RetrievalService`` over an index given as field dicts (without
    ``pdl_topk`` it serves no ``topk`` or ``tfidf``); ``knobs`` are its
    other fields (``occ_df_threshold``, ``brute_window``)."""
    dev = resolve_device(device)
    if sada.get("variant", "sparse") not in VARIANTS:
        raise ValueError(f"unknown Sada variant {sada.get('variant')!r} (have {VARIANTS})")
    return RetrievalService(
        coll=coll,
        csa=from_numpy(CSA, csa, dev),
        ilcp=from_numpy(ILCPIndex, ilcp, dev),
        pdl_list=from_numpy(PDLIndex, pdl_list, dev),
        sada=from_numpy(SadaCount, sada, dev),
        da=_tensor(np.asarray(da, np.int32), dev),
        pdl_topk=None if pdl_topk is None else from_numpy(PDLIndex, pdl_topk, dev),
        **knobs,
    )


def _float_tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # no numpy dtype of its own: move the bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def _float_tree(tree, shapes, dtype, device, path=""):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'tree'}: expected keys {sorted(shapes)}, got {got}")
        return {k: _float_tree(tree[k], shapes[k], dtype, device, f"{path}/{k}")
                for k in shapes}
    if tuple(np.shape(tree)) != tuple(shapes):
        raise ValueError(f"{path}: expected shape {tuple(shapes)}, got {np.shape(tree)}")
    return _float_tensor(tree, dtype, device)


def lm_params_from_numpy(cfg: LMConfig, tree: dict, device="cuda") -> dict:
    """The port's parameter dict from the reference's parameter pytree
    (numpy leaves), in ``cfg.param_dtype``; keys and shapes are checked."""
    return _float_tree(tree, param_shapes(cfg), cfg.param_dtype, resolve_device(device))


def lm_cache_from_numpy(cfg: LMConfig, tree: dict, device="cuda") -> dict:
    """The port's KV cache from the reference's cache pytree (numpy leaves
    [G, B, S_max, K, Dh]), in ``cfg.act_dtype``."""
    k = np.shape(tree["pos0"]["k"])
    shape = (cfg.n_groups, *k[1:3], cfg.n_kv_heads, cfg.head_dim)
    shapes = {f"pos{p}": {"k": shape, "v": shape} for p in range(cfg.period)}
    return _float_tree(tree, shapes, cfg.act_dtype, resolve_device(device))


_RECSYS_INIT = {
    recsys.FMConfig: recsys.fm_init,
    recsys.SASRecConfig: recsys.sasrec_init,
    recsys.AutoIntConfig: recsys.autoint_init,
    recsys.DLRMConfig: recsys.dlrm_init,
}


def _leaf_tree(tree, like, device, path=""):
    """``tree`` (numpy leaves) in the dict/list structure and shapes of
    ``like`` (``meta`` tensors), each leaf in its own dtype."""
    if isinstance(like, (dict, list)):
        keys = sorted(like) if isinstance(like, dict) else range(len(like))
        if isinstance(like, dict) and (not isinstance(tree, dict) or set(tree) != set(like)):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'tree'}: expected keys {sorted(like)}, got {got}")
        if isinstance(like, list) and (not isinstance(tree, (list, tuple))
                                       or len(tree) != len(like)):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__
            raise ValueError(f"{path or 'tree'}: expected a list of {len(like)}, got {got}")
        out = {k: _leaf_tree(tree[k], like[k], device, f"{path}/{k}") for k in keys}
        return out if isinstance(like, dict) else [out[i] for i in keys]
    if tuple(np.shape(tree)) != tuple(like.shape):
        raise ValueError(f"{path}: expected shape {tuple(like.shape)}, got {np.shape(tree)}")
    return _float_tensor(tree, None, device)  # the leaf's own dtype


def recsys_params_from_numpy(cfg, tree: dict, device="cuda") -> dict:
    """The port's parameter tree of the recsys model ``cfg`` (an
    ``FMConfig``, ``SASRecConfig``, ``AutoIntConfig`` or ``DLRMConfig``)
    from the reference's parameter pytree (numpy leaves, lists included).
    Keys, list lengths and shapes are checked against the model's init;
    each leaf keeps its own dtype (bf16 leaves move bit for bit)."""
    like = _RECSYS_INIT[type(cfg)](cfg, None, device="meta")
    return _leaf_tree(tree, like, resolve_device(device))


def nequip_params_from_numpy(cfg: nequip.NequIPConfig, tree: dict, device="cuda") -> dict:
    """The port's NequIP parameters from the reference's pytree (numpy
    leaves), in ``cfg.param_dtype``.  Keys, the layer count and shapes are
    checked against ``abstract_params(cfg)``; the layers stay a list, in
    the order ``train/tree.py`` flattens (the reference's)."""
    dev = resolve_device(device)
    tree = _leaf_tree(tree, nequip.abstract_params(cfg), dev)
    return map_leaves(lambda t: t.to(cfg.param_dtype), tree)
