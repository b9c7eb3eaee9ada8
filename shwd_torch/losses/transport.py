"""Batched transport distances: cost matrix, OT solve per item, 1/p root.

Counterpart of ``shwd_tpu/losses/transport.py``. Ported solvers:

- 'hybrid': annealed-Sinkhorn duals warm-start the auction, which returns
  the exact permutation (the flow's exact-EMD path);
- 'auction': the auction from cold prices;
- 'sinkhorn_fast': single-temperature log-Sinkhorn.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops.auction import auction_emd2, hybrid_emd2
from ..ops.costs import cost_matrix as build_cost
from ..ops.sinkhorn import sinkhorn_log

# solvers of the JAX package that a later slice brings
_LATER = {
    "sinkhorn": "slice 2 (the fused cost-plus-Sinkhorn kernel)",
    "sinkhorn_div": "a later slice (Queue 1, transport and loss)",
    "exact": "a later slice (the differentiable exact-EMD bridge)",
    "ssw": "a later slice (the SSW family)",
}


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    cost: str = "lp"            # 'lp' | 'cosine' | 'geodesic'
    p: float = 2.0
    # 'hybrid' | 'auction' | 'sinkhorn_fast' here; see _LATER for the rest
    solver: str = "sinkhorn"
    eps: float = 5e-3
    num_iters: int = 50
    num_scales: int = 4
    num_projections: int = 100  # ssw only
    reduce: str = "mean"        # batch reduction: 'mean' | 'sum' | 'none'


def reduce_batch(v: torch.Tensor, how: str) -> torch.Tensor:
    if how == "mean":
        return torch.mean(v)
    if how == "sum":
        return torch.sum(v)
    return v


def make_transport(cfg: TransportConfig) -> Callable:
    """Returns w(x, y) -> scalar (or (B,) if reduce='none').

    x, y: (B, N, 3) / (B, M, 3) or unbatched (N, 3). Per item
    W = (OT cost)^(1/p), then the batch reduction.
    """
    if cfg.solver in _LATER:
        raise NotImplementedError(
            f"solver {cfg.solver!r} is ported in {_LATER[cfg.solver]}")
    if cfg.solver not in ("hybrid", "auction", "sinkhorn_fast"):
        raise ValueError(f"unknown solver {cfg.solver!r}")

    def w(x, y):
        batched = x.ndim == 3
        c = build_cost(x, y, cfg.cost, cfg.p)
        if not batched:
            c = c[None]
        if cfg.solver == "sinkhorn_fast":
            val, _, _ = sinkhorn_log(c, eps=cfg.eps, num_iters=cfg.num_iters)
        elif cfg.solver == "auction":
            val = auction_emd2(c, 1e-7)
        else:
            val = hybrid_emd2(c, 1e-7, cfg.eps, cfg.num_iters, cfg.num_scales)
        if not batched:
            val = val[0]
        val = torch.clamp_min(val, 1e-30) ** (1.0 / cfg.p)
        return reduce_batch(val, cfg.reduce) if batched else val

    return w
