"""Invertible residual flow f(x) = x + g(x), ||g||_Lip < 1.

Counterpart of ``shwd_tpu/flows/residual.py``: the plain forward (the SHWD
hot path needs no log-det), the exact log-det on request and the
fixed-point inverse.
"""

from __future__ import annotations

import torch

from .base import Flow, FlowChain
from .lipschitz import LipschitzMLP


class ResidualFlow(Flow):
    """f(x) = x + net(x) with net Lipschitz < 1 (forward direction)."""

    def __init__(self, net: LipschitzMLP):
        super().__init__()
        self.net = net

    def forward_logdet(self, x, logdet: bool = False):
        """(x + net(x), log|det(I + J_net)| per point or None). The log-det
        is exact: d forward-mode JVPs give each point's d x d Jacobian (the
        net is pointwise and its forward updates no buffer), and it is
        differentiable in x and in the net's parameters."""
        if not logdet:
            return x + self.net(x), None
        d = x.shape[-1]
        flat = x.reshape(-1, d)
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        g = None
        cols = []
        for i in range(d):
            g, col = torch.func.jvp(self.net, (flat,), (eye[i].expand_as(flat),))
            cols.append(col)
        jg = torch.stack(cols, dim=-1)                      # (P, d, d)
        ld = torch.linalg.slogdet(eye + jg)[1]
        return x + g.reshape(x.shape), ld.reshape(x.shape[:-1])

    @torch.no_grad()
    def update_state(self, n_iter: int = 1) -> None:
        self.net.update_state(n_iter)

    @torch.no_grad()
    def inverse(self, y, max_iter: int = 200, tol: float = 1e-6):
        """Banach fixed-point iteration x <- y - g(x) (a contraction).
        Checks convergence on the host each round; off the hot path."""
        x_prev = y
        x = y - self.net(y)
        for _ in range(max_iter):
            if not bool(torch.amax(torch.abs(x - x_prev)) > tol):
                break
            x_prev, x = x, y - self.net(x)
        return x


def make_residual_chain(n_flow_layers: int = 3, dim: int = 3,
                        hidden_units: int = 8, hidden_layers: int = 7,
                        lipschitz_const: float = 0.95,
                        generator: torch.Generator | None = None) -> FlowChain:
    """The default phi: each block wraps a LipschitzMLP with channels
    [d, 8 x 6, d], coeff 0.95, zero-init last layer."""
    channels = [dim] + [hidden_units] * (hidden_layers - 1) + [dim]
    return FlowChain([
        ResidualFlow(LipschitzMLP(channels, lipschitz_const, init_zeros=True,
                                  generator=generator))
        for _ in range(n_flow_layers)
    ])
