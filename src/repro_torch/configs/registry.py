"""The architectures (counterpart of ``repro.configs.registry``'s
``ALL_ARCHS`` and ``get_arch_module``).

``ALL_ARCHS`` names the reference's architectures.  ``get_arch_module``
returns the config module of the five ported LMs and the four recsys
models, and raises ``NotImplementedError`` naming the ROADMAP item for
NequIP.  The reference's shape table and cells (abstract inputs,
partition specs, roofline metadata) wait for ROADMAP A12.5.
"""

from __future__ import annotations

import importlib

#: ported architectures: their config modules
_PORTED = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "fm": "repro_torch.configs.fm",
    "sasrec": "repro_torch.configs.sasrec",
    "autoint": "repro_torch.configs.autoint",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
}

#: the others: (family, ROADMAP item that ports them)
_WAITING = {
    "nequip": ("gnn", "A12.5"),
}

ALL_ARCHS = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "llama3.2-3b",
             "smollm-135m", "mistral-large-123b", "nequip", "fm", "sasrec", "autoint",
             "dlrm-mlperf")


def get_arch_module(arch_id: str):
    """The config module of ``arch_id`` (``config()``, ``reduced_config()``,
    ``ARCH_ID``, ``FAMILY``)."""
    if arch_id in _PORTED:
        return importlib.import_module(_PORTED[arch_id])
    if arch_id in _WAITING:
        family, item = _WAITING[arch_id]
        raise NotImplementedError(
            f"{arch_id} ({family} family) is not ported yet (ROADMAP {item})")
    raise KeyError(f"unknown architecture {arch_id!r} (have {', '.join(ALL_ARCHS)})")
