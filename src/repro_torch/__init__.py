"""PyTorch and CUDA port of ``repro``: document retrieval on repetitive
string collections, served on an NVIDIA H100, and the dense LMs of the
reference's model family.

The layout mirrors ``repro`` (``core/``, ``succinct/``, ``data/``,
``serve/``, ``kernels/``, ``models/``, ``configs/``), so each module's
counterpart is found by name.  Index objects are dataclasses of int32
tensors with ``.to(device)``; LM parameters are plain dicts with the
reference's keys.  Entry points take an explicit ``device`` and run on the
card unless the caller asks for the CPU.  The six hand-written Hopper
kernels live in ``csrc/`` and are bound in ``kernels/``.
"""
