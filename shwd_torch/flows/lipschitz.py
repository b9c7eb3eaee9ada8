"""Lipschitz-constrained MLP: Swish + spectrally-normalized linear layers.

Counterpart of ``shwd_tpu/flows/lipschitz.py``: alternating Swish
(learnable beta, /1.1 so |swish'| <= 1) and a spectral linear layer with
the soft normalisation W / max(1, sigma/coeff).

- sigma = u . (W v) is computed from the live weight with u, v detached,
  so the gradient flows through W only.
- u, v are buffers; ``update_state`` runs power iterations on them in
  place under no-grad (never calling it keeps them frozen, as the original
  reference code did after its 200 construction-time iterations).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), eps)


def swish(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x * softplus(beta)) / 1.1."""
    return (x * torch.sigmoid(x * F.softplus(beta))) / 1.1


class SpectralLinear(nn.Module):
    """y = x @ W_hat^T + b, W_hat = W / max(1, sigma/coeff), preceded by
    the layer's Swish. Parameters ``w``, ``b``, ``beta``; buffers ``u``,
    ``v``."""

    def __init__(self, in_features: int, out_features: int,
                 coeff: float = 0.97, zero_init: bool = False,
                 generator: torch.Generator | None = None,
                 power_iters: int = 200):
        super().__init__()
        self.coeff = coeff
        # kaiming_uniform(a=sqrt(5)) == U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        bound = 1.0 / math.sqrt(in_features)
        dev = generator.device if generator is not None else None
        w = (torch.rand(out_features, in_features, generator=generator,
                        device=dev) * 2 - 1) * bound
        if zero_init:
            w = w / 1000.0           # the approximate zero init of the last layer
        b = (torch.rand(out_features, generator=generator, device=dev) * 2 - 1) * bound
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        self.beta = nn.Parameter(torch.full((1,), 0.5, device=dev))
        self.register_buffer("u", _normalize(
            torch.randn(out_features, generator=generator, device=dev)))
        self.register_buffer("v", _normalize(
            torch.randn(in_features, generator=generator, device=dev)))
        if power_iters > 0:
            self.power_iter(power_iters)

    @torch.no_grad()
    def power_iter(self, n_iter: int = 1) -> None:
        """n_iter rounds of power iteration for the top singular pair."""
        w = self.w.detach()
        u, v = self.u, self.v
        for _ in range(n_iter):
            u = _normalize(w @ v)
            v = _normalize(w.T @ u)
        self.u.copy_(u)
        self.v.copy_(v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = swish(x, self.beta)
        sigma = self.u @ (self.w @ self.v)      # differentiable through w
        w_hat = self.w / torch.clamp_min(sigma / self.coeff, 1.0)
        return x @ w_hat.T + self.b


class LipschitzMLP(nn.Module):
    """channels e.g. [3, 8, 8, 8, 8, 8, 8, 3]: Swish -> SpectralLinear per
    layer, the activation before each linear, the last linear
    approximately zero-initialised. Lipschitz constant < prod(coeff) < 1.
    Each layer runs ``power_iters`` rounds once drawn (0 leaves them to the
    caller: ``make_residual_chain`` runs them for the whole chain)."""

    def __init__(self, channels: Sequence[int], lipschitz_const: float = 0.97,
                 init_zeros: bool = True,
                 generator: torch.Generator | None = None,
                 power_iters: int = 200):
        super().__init__()
        self.channels = tuple(channels)
        n_layers = len(channels) - 1
        self.layers = nn.ModuleList(
            SpectralLinear(channels[i], channels[i + 1], lipschitz_const,
                           zero_init=init_zeros and i == n_layers - 1,
                           generator=generator, power_iters=power_iters)
            for i in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    @torch.no_grad()
    def update_state(self, n_iter: int = 1) -> None:
        for layer in self.layers:
            layer.power_iter(n_iter)
