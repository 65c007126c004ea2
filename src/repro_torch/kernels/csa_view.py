"""The CSA operands of a kernel that locates through the CSA, in the order
of ``rt::CsaView`` (``csrc/retrieval_core.cuh``): the PDL gather's windows,
and the Sada-C-L and Sada-I-L listings' DA reads."""

from __future__ import annotations


def csa_operands(csa):
    """(tensors, ints): the view's pointers as (name, tensor, dims), then
    its sizes.  Also the order of the core's host builds in the tests."""
    wm = csa.wm
    tensors = [
        ("words", wm.words, 2), ("prefix", wm.ones_prefix, 2), ("zcount", wm.zcount, 1),
        ("counts", csa.counts, 1), ("sym_starts", wm.sym_starts, 1),
        ("sampled", csa.sampled.pos, 1), ("samples", csa.samples, 1),
        ("doc_starts", csa.doc_bv.pos, 1),
    ]
    ints = [
        wm.levels, int(wm.words.shape[1]), csa.n, csa.sample_rate,
        int(csa.sampled.pos.shape[0]), csa.sampled.m, int(csa.doc_bv.pos.shape[0]),
    ]
    return tensors, ints


def check_csa_operands(csa, device) -> list:
    """The view's tensors checked as kernel operands on ``device``; returns
    the launcher's arguments (pointers, then sizes)."""
    from repro_torch.kernels import _build

    tensors, ints = csa_operands(csa)
    for name, t, dims in tensors:
        _build.check_operand(name, t, dims, device)
    return [t.data_ptr() for _, t, _ in tensors], ints
