"""Optimizers and the weight transfer from the JAX package's layout."""

from .optim import torch_adam  # noqa: F401
