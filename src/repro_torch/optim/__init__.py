"""Optimizers: AdamW over a pytree of tensors (``optim.adam``)."""
