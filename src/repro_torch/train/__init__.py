"""Training substrate (counterpart of ``repro.train``): optimizer,
checkpointing, fault tolerance, gradient compression and the training
loop, over parameter trees of nested dicts of tensors."""
