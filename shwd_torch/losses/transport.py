"""Batched transport distances: cost matrix, OT solve per item, 1/p root.

Counterpart of ``shwd_tpu/losses/transport.py``, all seven solvers:

- 'sinkhorn': eps-scaled log-Sinkhorn from the raw clouds; on the card the
  fused cost-plus-Sinkhorn kernel (``ops.sinkhorn_fused.emd2_points``);
- 'sinkhorn_div': the debiased Sinkhorn divergence;
- 'hybrid': annealed-Sinkhorn duals warm-start the auction, which returns
  the exact permutation (the flow's exact-EMD path);
- 'auction': the auction from cold prices;
- 'sinkhorn_fast': single-temperature log-Sinkhorn;
- 'ssw': spherical sliced-Wasserstein (no cost matrix; ``cost`` is
  ignored), on frames drawn from the call's generator;
- 'exact': the host network simplex / assignment with the plan as the
  gradient (``ops.emd_exact.emd2_exact_torch``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops.auction import auction_emd2, hybrid_emd2
from ..ops.costs import cost_matrix as build_cost
from ..ops.emd_exact import emd2_exact_torch
from ..ops.sinkhorn import sinkhorn_divergence_cost, sinkhorn_log
from ..ops.sinkhorn_fused import emd2_points
from ..ops.spherical import sliced_cost_sphere, stiefel_frames

SOLVERS = ("sinkhorn", "sinkhorn_div", "sinkhorn_fast", "ssw", "exact",
           "auction", "hybrid")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    cost: str = "lp"            # 'lp' | 'cosine' | 'geodesic'
    p: float = 2.0
    solver: str = "sinkhorn"    # one of SOLVERS
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
    """Returns w(x, y, generator=None, frames=None) -> scalar (or (B,) if
    reduce='none').

    x, y: (B, N, 3) / (B, M, 3) or unbatched (N, 3). Per item
    W = (OT cost)^(1/p), then the batch reduction. Only 'ssw' reads
    ``generator`` (its frames are drawn from it; None means a generator
    seeded 0, the same frames on every call, as the JAX package's
    ``key=None``) and ``frames`` (given frames, (L, 3, 2), replace the
    draw).
    """
    if cfg.solver not in SOLVERS:
        raise ValueError(f"unknown solver {cfg.solver!r}")

    if cfg.solver == "ssw":
        def w(x, y, generator=None, frames=None):
            if frames is None:
                if generator is None:
                    generator = torch.Generator(device=x.device).manual_seed(0)
                frames = stiefel_frames(generator, cfg.num_projections,
                                        x.shape[-1], device=x.device)
            val = sliced_cost_sphere(x, y, frames, p=cfg.p) ** (1.0 / cfg.p)
            return reduce_batch(val, cfg.reduce) if x.ndim == 3 else val
        return w

    def w(x, y, generator=None, frames=None):
        batched = x.ndim == 3
        if not batched:
            x, y = x[None], y[None]
        if cfg.solver == "sinkhorn":
            # the fused kernel for CUDA tensors, emd2_approx elsewhere
            val = emd2_points(x, y, cfg.cost, cfg.p, eps=cfg.eps,
                              num_iters=cfg.num_iters,
                              num_scales=cfg.num_scales)
        elif cfg.solver == "sinkhorn_div":
            val = sinkhorn_divergence_cost(
                build_cost(x, y, cfg.cost, cfg.p),
                build_cost(x, x, cfg.cost, cfg.p),
                build_cost(y, y, cfg.cost, cfg.p),
                eps=cfg.eps, num_iters=cfg.num_iters,
                num_scales=cfg.num_scales)
        else:
            c = build_cost(x, y, cfg.cost, cfg.p)
            if cfg.solver == "sinkhorn_fast":
                val, _, _ = sinkhorn_log(c, eps=cfg.eps, num_iters=cfg.num_iters)
            elif cfg.solver == "exact":
                val = emd2_exact_torch(c)
            elif cfg.solver == "auction":
                val = auction_emd2(c, 1e-7)
            else:
                val = hybrid_emd2(c, 1e-7, cfg.eps, cfg.num_iters, cfg.num_scales)
        val = torch.clamp_min(val, 1e-30) ** (1.0 / cfg.p)
        return reduce_batch(val, cfg.reduce) if batched else val[0]

    return w
