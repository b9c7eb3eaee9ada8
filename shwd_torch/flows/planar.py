"""Planar flow f(z) = z + u * tanh(w.z + b).

Counterpart of ``shwd_tpu/flows/planar.py``: the u-reparameterisation that
keeps w.u > -1 (invertibility) and the exact log-det. The alternative phi
of ``make_flow("Planar", L)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..models.pointnet import uniform_init
from .base import Flow


class PlanarFlow(Flow):
    """Parameters ``u``, ``w`` (d,) and the scalar ``b``; tanh only."""

    def __init__(self, dim: int = 3, act: str = "tanh",
                 generator: torch.Generator | None = None):
        super().__init__()
        if act != "tanh":
            raise NotImplementedError("only tanh planar flows are built")
        self.u = nn.Parameter(uniform_init((dim,), math.sqrt(2.0), generator))
        self.w = nn.Parameter(uniform_init((dim,), math.sqrt(2.0 / dim), generator))
        self.b = nn.Parameter(torch.zeros((), device=self.u.device))

    def constrained_u(self) -> torch.Tensor:
        """u + (softplus(w.u) - 1 - w.u) w / |w|^2, so that w.u > -1."""
        inner = torch.dot(self.w, self.u)
        return self.u + (F.softplus(inner) - 1.0 - inner) * self.w / torch.sum(self.w * self.w)

    def forward_logdet(self, x, logdet: bool = False):
        u = self.constrained_u()
        lin = torch.sum(self.w * x, dim=-1, keepdim=True) + self.b
        y = x + u * torch.tanh(lin)
        if not logdet:
            return y, None
        h_prime = 1.0 / torch.cosh(lin[..., 0]) ** 2
        return y, torch.log(torch.abs(1.0 + torch.dot(self.w, u) * h_prime))
