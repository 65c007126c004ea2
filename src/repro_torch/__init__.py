"""PyTorch and CUDA port of ``repro``: document retrieval on repetitive
string collections, served on an NVIDIA H100.

The layout mirrors ``repro`` (``core/``, ``succinct/``, ``data/``,
``serve/``, ``kernels/``), so each module's counterpart is found by name.
Index objects are dataclasses of int32 tensors with ``.to(device)``;
entry points take an explicit ``device`` and run on the card unless the
caller asks for the CPU.  The two hand-written Hopper kernels live in
``csrc/`` and are bound in ``kernels/``.
"""
