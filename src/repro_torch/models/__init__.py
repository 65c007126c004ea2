"""repro_torch.models: the dense LM family (see the package docstring)."""
