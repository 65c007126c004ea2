"""Carry an index built elsewhere into the port.

``from_numpy`` takes the fields of an index object as a (nested) dict of
numpy arrays and Python scalars — the layout of the reference package's
CSA, ILCP, Sada, PDL (listing and top-k) and wavelet/bitvector dataclasses,
keyed by field name — and returns the port's index object on a device.
uint32 bit words become their int32 bit patterns; fields the port does not
keep (Sada's unused filters) are ignored.

``service_from_numpy`` assembles a ``RetrievalService`` from such dicts, so
the port's query path can be held against the reference on the identical
index, separately from build parity.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch.common import TensorDataclass, resolve_device
from repro_torch.core.csa import CSA
from repro_torch.core.ilcp import ILCPIndex
from repro_torch.core.pdl import PDLIndex
from repro_torch.core.sada import SadaCount
from repro_torch.core.suffix import Collection
from repro_torch.serve.retrieval import RetrievalService


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def from_numpy(cls, fields: dict, device="cuda"):
    """Build a ``cls`` index object from a dict of its fields."""
    dev = resolve_device(device)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        kind = hints[f.name]
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
    if sada.get("variant", "sparse") != "sparse":
        raise ValueError("only the 'sparse' Sada variant is ported")
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
