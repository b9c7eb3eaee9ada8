"""Pairwise transport-cost matrices, (B, N, D) x (B, M, D) -> (B, N, M).

Counterpart of ``shwd_tpu/ops/costs.py``: Lp, cosine, geodesic and squared
Euclidean costs. The arccos input is clipped away from +-1 so gradients
stay finite. Products run in full f32 on the card (TF32 off).
"""

from __future__ import annotations

import torch

from ..device import disable_tf32

_EPS_ACOS = 1e-7


def _no_tf32(x: torch.Tensor) -> None:
    if x.is_cuda:
        disable_tf32()


def lp_cost(x: torch.Tensor, y: torch.Tensor, p: float = 2) -> torch.Tensor:
    """C[b, i, j] = sum_d |x[b,i,d] - y[b,j,d]|^p.

    For p == 2 the matmul expansion ||x||^2 + ||y||^2 - 2 x.y cancels
    catastrophically once the clouds nearly coincide (|x-y|^2 ~ 1e-6 as a
    difference of O(1) terms), which stalls Wasserstein flows at W2 ~ 1e-2.
    For the geometric D <= 8 case the direct broadcast difference is used
    (error relative to the difference, not the magnitudes); the expansion
    only for large D.
    """
    if p == 2:
        if x.shape[-1] <= 8:
            diff = x[..., :, None, :] - y[..., None, :, :]
            return torch.sum(diff * diff, dim=-1)
        _no_tf32(x)
        x2 = torch.sum(x * x, dim=-1)[..., :, None]
        y2 = torch.sum(y * y, dim=-1)[..., None, :]
        xy = torch.einsum("...nd,...md->...nm", x, y)
        return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    return torch.sum(diff ** p, dim=-1)


def cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """S[b, i, j] = cos angle between x[b,i] and y[b,j], one batched product."""
    _no_tf32(x)
    xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)
    yn = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), eps)
    return torch.einsum("...nd,...md->...nm", xn, yn)


def cosine_cost(x: torch.Tensor, y: torch.Tensor, p: float = 1) -> torch.Tensor:
    """C = (1 - cos)^p."""
    return (1.0 - cosine_similarity(x, y)) ** p


def geodesic_cost(x: torch.Tensor, y: torch.Tensor, p: float = 1) -> torch.Tensor:
    """C = arccos(cos)^p, the great-circle distance cost on S^2."""
    cos = torch.clamp(cosine_similarity(x, y), -1.0 + _EPS_ACOS, 1.0 - _EPS_ACOS)
    return torch.arccos(cos) ** p


def sqeuclidean_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean cost (the exact-W2 eval cost of the flow runs)."""
    return lp_cost(x, y, p=2)


def cost_matrix(x: torch.Tensor, y: torch.Tensor, kind: str = "lp",
                p: float = 2) -> torch.Tensor:
    """Dispatch on cost kind: 'lp' | 'cosine' | 'geodesic' | 'sqeuclidean'."""
    if kind == "lp":
        return lp_cost(x, y, p)
    if kind == "cosine":
        return cosine_cost(x, y, p)
    if kind == "geodesic":
        return geodesic_cost(x, y, p)
    if kind == "sqeuclidean":
        return sqeuclidean_cost(x, y)
    raise ValueError(f"unknown cost kind: {kind!r}")
