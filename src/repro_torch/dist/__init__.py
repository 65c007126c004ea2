"""repro_torch.dist (see the package docstring)."""
