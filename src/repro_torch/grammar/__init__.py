"""repro_torch.grammar (see the package docstring)."""
