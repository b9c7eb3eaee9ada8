"""Spherical sliced-Wasserstein: great-circle projections and circular OT.

Counterpart of ``shwd_tpu/ops/spherical.py``:

1. draw L uniform rank-2 frames on the Stiefel manifold V_{d,2};
2. project each cloud onto each frame's plane, renormalise onto S^1;
3. angle coordinates t = (atan2(-y, -x) + pi) / (2 pi) in [0, 1);
4. exact circular OT per slice: closed-form W_1 or ``circle_ot``.

Everything is batched over (B, L) in one shot.
"""

from __future__ import annotations

import math

import torch

from .ot1d import circle_ot, emd1d_circle


def stiefel_frames(generator: torch.Generator | None, num_projections: int,
                   d: int = 3, batch_shape: tuple = (),
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Uniform frames on V_{d,2}: (*batch_shape, L, d, 2), orthonormal
    columns, drawn from ``generator`` (on ``device``; the generator's own
    device when not given).

    The JAX package takes the Q of a QR of Gaussians. Here the two columns
    are Gram-Schmidt-orthonormalised in closed form, the same law (Q with
    R's diagonal positive) in a few elementwise kernels and without
    a batched LAPACK call; the columns' signs may differ from a QR's, and
    the SSW value does not depend on them (a sign flip reflects or turns
    the circle for both clouds alike).
    """
    if device is None:
        device = generator.device if generator is not None else None
    z = torch.randn(*batch_shape, num_projections, d, 2, generator=generator,
                    device=device)
    a, b = z[..., 0], z[..., 1]
    q1 = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    for _ in range(2):      # twice: one pass leaves ~1e-6 of q1 in f32
        b = b - torch.sum(q1 * b, dim=-1, keepdim=True) * q1
    q2 = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return torch.stack([q1, q2], dim=-1)


def project_to_circle(x: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """Angle coordinates in [0, 1) on each frame's great circle:
    x (..., N, d), frames (..., L, d, 2) -> (..., L, N), with the
    convention (atan2(-y, -x) + pi) / 2pi.

    The plane projection is an explicit elementwise contraction over d,
    never a matrix product: a product that rounds to TF32 or bf16 floors
    every downstream 1-D OT at ~1e-3.
    """
    xb = x[..., None, :, :]                              # (..., 1, N, d)
    fb = frames[..., :, None, :, :]                      # (..., L, 1, d, 2)
    proj = sum(xb[..., k:k + 1] * fb[..., k, :] for k in range(x.shape[-1]))
    norm = torch.clamp_min(torch.linalg.vector_norm(proj, dim=-1, keepdim=True), 1e-12)
    proj = proj / norm
    return (torch.atan2(-proj[..., 1], -proj[..., 0]) + math.pi) / (2.0 * math.pi)


def sliced_cost_sphere(x: torch.Tensor, y: torch.Tensor, frames: torch.Tensor,
                       p: float = 2) -> torch.Tensor:
    """Mean over slices of circular W_p^p between the projected clouds:
    x (..., N, 3), y (..., M, 3), frames (..., L, 3, 2) -> (...,)."""
    ax = project_to_circle(x, frames)
    ay = project_to_circle(y, frames)
    w = emd1d_circle(ax, ay) if p == 1 else circle_ot(ax, ay, p=p)
    return torch.mean(w, dim=-1)


def sliced_wasserstein_sphere(generator: torch.Generator | None, x: torch.Tensor,
                              y: torch.Tensor, num_projections: int = 100,
                              p: float = 2,
                              per_batch_frames: bool = False,
                              frames: torch.Tensor | None = None) -> torch.Tensor:
    """SSW_p^p between clouds on S^2, the batch mean if batched.
    ``per_batch_frames`` draws independent frames per batch element;
    otherwise all elements share L frames. ``frames`` replaces the draw."""
    batched = x.ndim == 3
    if frames is None:
        batch_shape = (x.shape[0],) if batched and per_batch_frames else ()
        frames = stiefel_frames(generator, num_projections, x.shape[-1],
                                batch_shape=batch_shape, device=x.device)
    cost = sliced_cost_sphere(x, y, frames, p=p)
    return torch.mean(cost) if batched else cost
