"""Invertible residual flow f(x) = x + g(x), ||g||_Lip < 1.

Counterpart of ``shwd_tpu/flows/residual.py``: the plain forward (the SHWD
hot path needs no log-det), the exact log-det on request and the
fixed-point inverse.

A ``FlowChain`` of such flows over ``LipschitzMLP``s of the widths
``ops.residual_chain.CHANNELS`` (phi of SHWD, whatever its number of
blocks) runs its forward without log-det and its power iterations on CUDA
f32 tensors as the hand-written kernels of ``ops.residual_chain``
(``kernel_route``); the modules stay the CPU path and every other path
(the log-det, the inverse, other widths).
"""

from __future__ import annotations

import torch

from ..ops import residual_chain
from .base import Flow, FlowChain
from .lipschitz import LipschitzMLP, SpectralLinear


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


def kernel_layers(chain: FlowChain) -> list[residual_chain.Layer] | None:
    """The chain's layers, block after block, as the kernels of
    ``ops.residual_chain`` take them, where every flow is a
    ``ResidualFlow`` over a ``LipschitzMLP`` of the widths
    ``residual_chain.CHANNELS`` (any number of blocks); None otherwise.
    Decided from the structure alone."""
    layers = []
    for f in chain.flows:
        if (type(f) is not ResidualFlow or type(f.net) is not LipschitzMLP
                or f.net.channels != residual_chain.CHANNELS
                or any(type(m) is not SpectralLinear for m in f.net.layers)):
            return None
        layers += [residual_chain.Layer(m.w, m.b, m.beta, m.u, m.v, m.coeff)
                   for m in f.net.layers]
    return layers or None


def kernel_route(chain: FlowChain, device, dtype: torch.dtype,
                 logdet: bool = False) -> list[residual_chain.Layer] | None:
    """The layers for the kernels where ``chain.forward_logdet`` on points
    of ``device`` and ``dtype`` (or its power iteration, on parameters of
    that device and dtype) runs them: CUDA f32, no log-det, a chain that
    ``kernel_layers`` takes; None where the modules run. A pure function
    of its arguments."""
    if logdet or torch.device(device).type != "cuda" or dtype != torch.float32:
        return None
    return kernel_layers(chain)


def make_residual_chain(n_flow_layers: int = 3, dim: int = 3,
                        hidden_units: int = 8, hidden_layers: int = 7,
                        lipschitz_const: float = 0.95,
                        generator: torch.Generator | None = None) -> FlowChain:
    """The default phi: each block wraps a LipschitzMLP with channels
    [d, 8 x 6, d], coeff 0.95, zero-init last layer. Every layer is drawn
    first, then the chain runs the 200 construction rounds of power
    iteration at once (which draw nothing, so the values are those of
    rounds run layer by layer)."""
    channels = [dim] + [hidden_units] * (hidden_layers - 1) + [dim]
    chain = FlowChain([
        ResidualFlow(LipschitzMLP(channels, lipschitz_const, init_zeros=True,
                                  generator=generator, power_iters=0))
        for _ in range(n_flow_layers)
    ])
    chain.update_state(200)
    return chain
