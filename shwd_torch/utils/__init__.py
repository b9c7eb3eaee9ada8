"""Optimizers, checkpoints, logging and the weight transfer from the JAX
package's layout."""

from .checkpoint import load_checkpoint, save_checkpoint, state_payload  # noqa: F401
from .logging import RunLogger  # noqa: F401
from .optim import torch_adam  # noqa: F401
