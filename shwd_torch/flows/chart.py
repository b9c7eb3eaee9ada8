"""Learned-chart sphere maps: MLP -> angles -> S^2 embedding.

Counterpart of ``shwd_tpu/flows/chart.py``, the two non-flow phis of the
max-SSW criterion:

- ``SphereChartMLP``: Linear 3-16-4-2 with tanh, the head mapped to the
  angles theta1 in [0, pi], theta2 in [-pi, pi] and embedded on S^2;
- ``EncoderFlowChart``: a per-point ReLU encoder to 2-D, a chain of 2-D
  residual flows (zero-initialised last layers), the same embedding.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..models.pointnet import PointLinear
from .base import Flow, FlowChain
from .lipschitz import LipschitzMLP
from .residual import ResidualFlow


def _mlp(widths: Sequence[int], generator) -> nn.ModuleList:
    return nn.ModuleList(PointLinear(widths[i], widths[i + 1], generator)
                         for i in range(len(widths) - 1))


def _angles_to_sphere(h2: torch.Tensor) -> torch.Tensor:
    """(..., 2) head -> (..., 3) points on S^2."""
    theta1 = math.pi * (torch.tanh(h2[..., 0]) / 2.0 + 0.5)
    theta2 = math.pi * torch.tanh(h2[..., 1])
    return torch.stack([torch.sin(theta1) * torch.cos(theta2),
                        torch.sin(theta1) * torch.sin(theta2),
                        torch.cos(theta1)], dim=-1)


class SphereChartMLP(Flow):
    """tanh MLP 3 -> 16 -> 4 -> 2, then the angle embedding onto S^2."""

    def __init__(self, widths: Sequence[int] = (3, 16, 4, 2),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.layers = _mlp(widths, generator)

    def forward_logdet(self, x, logdet: bool = False):
        h = x
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < len(self.layers) - 1:
                h = torch.tanh(h)
        return _angles_to_sphere(h), None


class EncoderFlowChart(Flow):
    """Per-point 2-D encoder (ReLU between layers) -> 2-D residual flows
    -> S^2 embedding."""

    def __init__(self, encoder_widths: Sequence[int] = (3, 8, 8, 2),
                 n_flow_layers: int = 3, hidden_units: int = 8,
                 hidden_layers: int = 3, lipschitz_const: float = 0.95,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = _mlp(encoder_widths, generator)
        d = encoder_widths[-1]
        channels = [d] + [hidden_units] * (hidden_layers - 1) + [d]
        self.flow = FlowChain([
            ResidualFlow(LipschitzMLP(channels, lipschitz_const, init_zeros=True,
                                      generator=generator))
            for _ in range(n_flow_layers)])

    def forward_logdet(self, x, logdet: bool = False):
        h = x
        for i, layer in enumerate(self.encoder):
            h = layer(h)
            if i < len(self.encoder) - 1:
                h = torch.relu(h)
        return _angles_to_sphere(self.flow(h)), None

    @torch.no_grad()
    def update_state(self, n_iter: int = 1) -> None:
        self.flow.update_state(n_iter)
