"""Per-layer metrics: one reader a file, ``read(run) -> float | None``."""
