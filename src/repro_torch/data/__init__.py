"""repro_torch.data (see the package docstring)."""
