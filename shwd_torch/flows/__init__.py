"""Normalizing flows and sphere charts (the phi of SHWD and max-SSW) as
``nn.Module`` trees."""

from __future__ import annotations

import torch

from .actnorm import ActNorm  # noqa: F401
from .base import Flow, FlowChain  # noqa: F401
from .chart import EncoderFlowChart, SphereChartMLP  # noqa: F401
from .lipschitz import LipschitzMLP, SpectralLinear, swish  # noqa: F401
from .planar import PlanarFlow  # noqa: F401
from .residual import ResidualFlow, make_residual_chain  # noqa: F401


def make_flow(flow_name: str = "Residual", n_flow_layers: int = 3,
              dim: int = 3, hidden_units: int = 8, hidden_layers: int = 7,
              lipschitz_const: float = 0.95,
              generator: torch.Generator | None = None) -> FlowChain:
    """'Planar' chains planar flows; 'Residual' chains invertible residual
    blocks over LipschitzMLPs [d, 8 x 6, d]. ``generator`` (on the target
    device) draws the init."""
    if flow_name == "Planar":
        return FlowChain([PlanarFlow(dim, generator=generator)
                          for _ in range(n_flow_layers)])
    if flow_name == "Residual":
        return make_residual_chain(n_flow_layers, dim, hidden_units,
                                   hidden_layers, lipschitz_const, generator)
    raise ValueError(f"Flow name is not valid: {flow_name!r}")
