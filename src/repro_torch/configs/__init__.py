"""repro_torch.configs: the dense, period-1 LM configurations."""
