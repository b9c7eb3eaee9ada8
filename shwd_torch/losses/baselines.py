"""Baseline losses: Chamfer and Sinkhorn, with the trainer-facing signature.

Counterpart of ``shwd_tpu/losses/baselines.py``. Both return
``(loss, x, y)`` so trainers can treat every criterion uniformly (the SHWD
criteria return ``(w, sphere_x, sphere_y)``).
"""

from __future__ import annotations

import torch

from ..ops.chamfer import chamfer
from ..ops.sinkhorn import sinkhorn_loss


def chamfer_criterion(x: torch.Tensor, y: torch.Tensor):
    return chamfer(x, y), x, y


def make_sinkhorn_criterion(eps: float = 0.01, num_iters: int = 100,
                            p: float = 2, wasserstein_root: bool = False):
    def crit(x, y):
        return sinkhorn_loss(x, y, eps=eps, num_iters=num_iters, p=p,
                             wasserstein_root=wasserstein_root), x, y
    return crit
