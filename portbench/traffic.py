"""The benchmark's inputs, made from the seed: shape banks and cloud pairs.

Everything here is the benchmark's own (numpy only), so a change to the
program cannot move what the cells are fed. The same seed gives the same
arrays; every seed gives arrays of the same sizes.

- ``composite_bank``: the chiral three-lobe shapes the registration rows
  train on (an ellipsoid body, a box lobe on +x, a cone lobe on +z),
  surface-sampled and scaled into the unit cube, drawn for all shapes at
  once.
- ``cube_pair``: the Flow_cube clouds, a uniform cube surface as the source
  and a corner-skewed (Beta(2, 5) in-face coordinates) cube surface as the
  target.
"""

from __future__ import annotations

import numpy as np

# the two in-face axes of a box face whose normal is axis 0, 1, 2
_OTHERS = np.array([[1, 2], [0, 2], [0, 1]])


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for (seed, stream...); any non-negative seed."""
    return np.random.default_rng([int(seed), *map(int, stream)])


def _box_surface(rng, s, n, half):
    """(s, n, 3) points on the surfaces of s boxes with half extents
    ``half`` (s, 3), faces picked by area."""
    areas = np.stack([half[:, 1] * half[:, 2], half[:, 0] * half[:, 2],
                      half[:, 0] * half[:, 1]], axis=-1)
    areas = np.concatenate([areas, areas], axis=-1)               # (s, 6)
    cum = np.cumsum(areas / areas.sum(-1, keepdims=True), axis=-1)
    u = rng.random((s, n))
    face = np.minimum((u[..., None] > cum[:, None, :]).sum(-1), 5)
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    uv = rng.uniform(-1.0, 1.0, (s, n, 2))
    rows = np.arange(s)[:, None]
    pts = np.zeros((s, n, 3))
    np.put_along_axis(pts, axis[..., None],
                      (sign * half[rows, axis])[..., None], axis=-1)
    for k in range(2):
        other = _OTHERS[axis, k]
        np.put_along_axis(pts, other[..., None],
                          (uv[..., k] * half[rows, other])[..., None], axis=-1)
    return pts


def _cone_surface(rng, s, n, radius, height):
    """(s, n, 3) points on s cones (lateral surface and base, by area)."""
    lat = np.pi * radius * np.hypot(radius, height)
    p_lat = lat / (lat + np.pi * radius ** 2)
    theta = rng.uniform(0.0, 2 * np.pi, (s, n))
    on_lat = rng.random((s, n)) < p_lat[:, None]
    t = np.sqrt(rng.random((s, n)))
    r_base = np.sqrt(rng.random((s, n)))
    r, h = radius[:, None], height[:, None]
    rho = np.where(on_lat, t, r_base) * r
    z = np.where(on_lat, h * (1 - t) - h / 2, -h / 2)
    return np.stack([np.cos(theta) * rho, np.sin(theta) * rho, z], axis=-1)


def composite_bank(seed: int, num_shapes: int, points: int) -> np.ndarray:
    """(num_shapes, points, 3) float32 composite shapes, each centred and
    scaled so that its largest coordinate is 0.999999."""
    rng = seed_rng(seed, 0)
    s = num_shapes
    n1 = points // 2
    n2 = (points - n1) // 2
    n3 = points - n1 - n2
    semi = rng.uniform(0.5, 0.9, (s, 3))
    body = rng.normal(size=(s, n1, 3))
    body = body / np.maximum(np.linalg.norm(body, axis=-1, keepdims=True), 1e-12)
    body = body * semi[:, None, :]
    half = rng.uniform(0.15, 0.35, (s, 3))
    box = _box_surface(rng, s, n2, half)
    box[..., 0] += rng.uniform(0.6, 0.9, s)[:, None]
    cone = _cone_surface(rng, s, n3, rng.uniform(0.15, 0.35, s),
                         rng.uniform(0.4, 0.8, s))
    cone[..., 1] += rng.uniform(0.1, 0.3, s)[:, None]
    cone[..., 2] += rng.uniform(0.5, 0.9, s)[:, None]
    pts = np.concatenate([body, box, cone], axis=1)
    pts = pts - pts.mean(axis=1, keepdims=True)
    scale = np.abs(pts).max(axis=(1, 2), keepdims=True)
    return (pts * (0.999999 / np.maximum(scale, 1e-12))).astype(np.float32)


def cube_surface(rng: np.random.Generator, n: int, biased: bool) -> np.ndarray:
    """n points on the surface of the unit-side cube at the origin: a face
    picked uniformly, in-face coordinates uniform or Beta(2, 5)."""
    face = rng.integers(0, 6, size=n)
    uv = rng.beta(2.0, 5.0, size=(n, 2)) if biased else rng.uniform(size=(n, 2))
    uv = uv - 0.5
    axis = face % 3
    pinned = np.where(face < 3, 0.5, -0.5)
    u, v = uv[:, 0], uv[:, 1]
    c0 = np.where(axis == 0, pinned, u)
    c1 = np.where(axis == 1, pinned, np.where(axis == 0, u, v))
    c2 = np.where(axis == 2, pinned, v)
    return np.stack([c0, c1, c2], axis=-1).astype(np.float32)


def cube_pair(seed: int, index: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The source and target clouds of flow ``index`` of a run."""
    rng = seed_rng(seed, 1, index)
    return cube_surface(rng, n, biased=False), cube_surface(rng, n, biased=True)


def flow_seed(seed: int, index: int) -> int:
    """The seed of flow ``index``'s own draws (phi's initial weights)."""
    return int(seed_rng(seed, 2, index).integers(0, 2 ** 62))
