"""PointNet encoder: per-point MLP + global max-pool.

Counterpart of ``shwd_tpu/models/pointnet.py``: a stack of per-point linear
maps 3-64-64-64-128-1024 with ReLU after every layer (a 1x1 Conv1d over
points is a per-point linear map), then a max over points. Weights keep the
``(out, in)`` layout of the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def uniform_init(shape, bound: float,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """U(-bound, bound) of ``shape``, drawn from ``generator`` on its device."""
    dev = generator.device if generator is not None else None
    return (torch.rand(shape, generator=generator, device=dev) * 2 - 1) * bound


class PointLinear(nn.Module):
    """y = x @ w^T + b with ``w`` (out, in); init U(+-1/sqrt(fan_in)) for
    weight and bias, drawn from ``generator`` (on the target device)."""

    def __init__(self, n_in: int, n_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(n_in)
        self.w = nn.Parameter(uniform_init((n_out, n_in), bound, generator))
        self.b = nn.Parameter(uniform_init((n_out,), bound, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.T + self.b


class PointNet(nn.Module):
    """Per-point feature extractor; returns (B, N, emb_dims) features."""

    def __init__(self, emb_dims: int = 1024,
                 widths: Sequence[int] = (3, 64, 64, 64, 128),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.widths = tuple(widths) + (emb_dims,)
        self.emb_dims = emb_dims
        self.layers = nn.ModuleList(
            PointLinear(self.widths[i], self.widths[i + 1], generator)
            for i in range(len(self.widths) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, 3) -> (B, N, emb_dims); ReLU after every layer,
        including the last."""
        h = x
        for layer in self.layers:
            h = torch.relu(layer(h))
        return h


def max_pool(features: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, C): global max over points."""
    return torch.amax(features, dim=-2)
