"""The benchmark of ``repro_torch``'s served retrieval path (see ``run.py``)."""
