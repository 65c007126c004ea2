"""The analysis gate over the serving stack: endpoint contracts checked on
recorded program runs and captured CUDA graphs, and an AST lint
(counterpart of ``repro.analysis``).

One CI gate, ``python -m repro_torch.analysis``:

* ``repro_torch.analysis.programs`` / ``repro_torch.analysis.contracts``:
  run every endpoint program once per bucket, recorded, and check its
  kernel calls, its captured graph's kernel nodes (on the card), host
  syncs, collectives and 64-bit dtypes;
* ``repro_torch.analysis.lint``: repo-specific AST rules (injectable
  clocks, no host sync in batched executors and kernels, registered fault
  sites only, no CUDA work at import time).
"""

from repro_torch.analysis.programs import (
    GraphNodes,
    ProgramTrace,
    kernel_base_name,
    parse_graph_dot,
    trace_program,
)

__all__ = [
    "GraphNodes",
    "ProgramTrace",
    "kernel_base_name",
    "parse_graph_dot",
    "trace_program",
]
