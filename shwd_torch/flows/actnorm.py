"""ActNorm: per-dimension affine y = exp(s) * x + t, initialised from data.

Counterpart of ``shwd_tpu/flows/actnorm.py``. The data-dependent init is
an explicit ``init_from_data`` call (in place here), not a hidden first
forward.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import Flow


class ActNorm(Flow):
    """Parameters ``s`` and ``t`` (d,), zero at construction."""

    def __init__(self, dim: int = 3, device: str | torch.device | None = None):
        super().__init__()
        self.dim = dim
        self.s = nn.Parameter(torch.zeros(dim, device=device))
        self.t = nn.Parameter(torch.zeros(dim, device=device))

    @torch.no_grad()
    def init_from_data(self, x: torch.Tensor) -> None:
        """Set (s, t) so that the outputs of this batch are ~unit Gaussian
        per dimension (population standard deviation, as ``jnp.std``)."""
        flat = x.reshape(-1, self.dim)
        s = -torch.log(torch.std(flat, dim=0, correction=0) + 1e-6)
        self.s.copy_(s)
        self.t.copy_(-torch.mean(flat, dim=0) * torch.exp(s))

    def forward_logdet(self, x, logdet: bool = False):
        y = x * torch.exp(self.s) + self.t
        if not logdet:
            return y, None
        return y, torch.sum(self.s).expand(x.shape[:-1])

    def inverse(self, y):
        return (y - self.t) * torch.exp(-self.s)
