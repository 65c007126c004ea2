"""repro_torch.core (see the package docstring)."""
