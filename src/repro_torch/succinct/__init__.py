"""repro_torch.succinct (see the package docstring)."""
