"""Flow interface: each flow is an ``nn.Module``.

Counterpart of ``shwd_tpu/flows/base.py``. The JAX package threads
``(params, state)`` through pure functions; here parameters and buffers
live on the modules:

    y, logdet = flow.forward_logdet(x)     # or y = flow(x)
    flow.update_state(n_iter)              # power iteration etc., in place
    x = flow.inverse(y)

Every flow maps (..., d) to (..., d), so (N, 3) clouds and (B, N, 3)
batches go through the same module.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import residual_chain


class Flow(nn.Module):
    """Base class; subclasses override forward_logdet (+ optionally inverse)."""

    def forward_logdet(self, x: torch.Tensor, logdet: bool = False):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_logdet(x, logdet=False)[0]

    @torch.no_grad()
    def update_state(self, n_iter: int = 1) -> None:
        pass

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} has no inverse")


class FlowChain(Flow):
    """Composition of flows, applied left to right. A chain of residual
    blocks that ``flows.residual.kernel_route`` admits runs its forward
    (without log-det) and its power iterations as CUDA kernels."""

    def __init__(self, flows: Sequence[Flow]):
        super().__init__()
        self.flows = nn.ModuleList(flows)

    def forward_logdet(self, x, logdet: bool = False):
        from .residual import kernel_route
        layers = kernel_route(self, x.device, x.dtype, logdet)
        if layers is not None:
            return residual_chain.residual_chain(x, layers), None
        total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device) \
            if logdet else None
        for f in self.flows:
            x, ld = f.forward_logdet(x, logdet=logdet)
            if logdet:
                total = total + ld
        return x, total

    @torch.no_grad()
    def update_state(self, n_iter: int = 1) -> None:
        from .residual import kernel_route
        w = next(self.parameters(), None)
        layers = None if w is None else kernel_route(self, w.device, w.dtype)
        if layers is not None:
            residual_chain.power_iteration(layers, n_iter)
            return
        for f in self.flows:
            f.update_state(n_iter)

    def inverse(self, y):
        for f in reversed(self.flows):
            y = f.inverse(y)
        return y
