"""Synthetic genus-0 geometry samplers (cube / ellipsoid / sphere surfaces).

Counterpart of ``shwd_tpu/ops/sphere_sampling.py``. The streams differ from
``jax.random``'s for the same seed, so tests hand both packages numpy
clouds.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_cube_surface(rng: np.random.Generator, n: int, side: float = 1.0,
                        biased: bool = False,
                        device: str | torch.device = "cpu") -> torch.Tensor:
    """Sample n points on the surface of a cube centred at the origin.

    ``biased=False``: face chosen uniformly, in-face coordinates uniform.
    ``biased=True``: in-face coordinates Beta(2, 5)-distributed (a
    corner-skewed density on each face). ``torch.Generator`` cannot drive a
    Beta draw, so this sampler takes a numpy ``Generator`` and builds the
    cloud on the host; it returns f32 on ``device``.
    """
    face = rng.integers(0, 6, size=n)
    if biased:
        uv = rng.beta(2.0, 5.0, size=(n, 2))
    else:
        uv = rng.uniform(size=(n, 2))
    uv = (uv - 0.5) * side
    half = side / 2.0

    axis = face % 3                  # which coordinate is pinned to a face
    pinned = np.where(face < 3, half, -half)
    u, v = uv[:, 0], uv[:, 1]
    c0 = np.where(axis == 0, pinned, u)
    c1 = np.where(axis == 1, pinned, np.where(axis == 0, u, v))
    c2 = np.where(axis == 2, pinned, v)
    pts = np.stack([c0, c1, c2], axis=-1).astype(np.float32)
    return torch.as_tensor(pts, device=device)


def sample_ellipsoid_surface(generator: torch.Generator, n: int,
                             semi_axes=(2.0, 1.0, 1.0),
                             biased_scale: float | None = None,
                             device: str | torch.device = "cpu") -> torch.Tensor:
    """Sample n points on an ellipsoid x^2/a^2 + y^2/b^2 + z^2/c^2 = 1:
    uniform-on-sphere directions stretched by the semi-axes.
    ``biased_scale`` concentrates the Gaussian draw along one octant.
    ``generator`` must live on ``device``."""
    z = torch.randn(n, 3, generator=generator, device=device)
    if biased_scale is not None:
        z = torch.abs(z) * biased_scale + 0.5
    z = z / torch.clamp_min(torch.linalg.vector_norm(z, dim=-1, keepdim=True), 1e-12)
    return z * torch.tensor(semi_axes, dtype=z.dtype, device=z.device)


def sample_sphere_surface(generator: torch.Generator, n: int,
                          radius: float = 1.0,
                          device: str | torch.device = "cpu") -> torch.Tensor:
    """Uniform points on S^2 of given radius. ``generator`` must live on
    ``device``."""
    z = torch.randn(n, 3, generator=generator, device=device)
    return radius * z / torch.clamp_min(
        torch.linalg.vector_norm(z, dim=-1, keepdim=True), 1e-12)
