"""repro_torch.serve (see the package docstring)."""
