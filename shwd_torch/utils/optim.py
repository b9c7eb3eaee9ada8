"""Optimizer builders.

``torch.optim.Adam(weight_decay=wd)`` folds the L2 penalty into the gradient
BEFORE the adaptive rescaling (coupled L2). That is the rule the JAX
package reproduces with ``add_decayed_weights`` + ``scale_by_adam``; the
decoupled AdamW form shrinks phi too aggressively once gradients are small.
"""

from __future__ import annotations

import torch


def torch_adam(params, lr: float, weight_decay: float = 0.0, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with coupled L2: grad += wd * w, then Adam scaling."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
