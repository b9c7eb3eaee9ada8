"""Procedural genus-0 shape bank (numpy only).

Copy of ``shwd_tpu/data/synthetic.py``: the same arrays for the same seed,
bit for bit. A deterministic multi-class bank of genus-0 surfaces (box,
ellipsoid, cylinder, cone, and the chiral ``composite``) that stands in for
ModelNet when no mesh data is present. Distribution properties match the
preprocessed ModelNet data: unit-cube normalized, surface-sampled.
"""

from __future__ import annotations

import numpy as np

from .modelnet import normalize_scale


def _sample_box(rng, n, half_extents):
    areas = np.array([
        half_extents[1] * half_extents[2],
        half_extents[0] * half_extents[2],
        half_extents[0] * half_extents[1],
    ]).repeat(2)
    probs = areas / areas.sum()
    face = rng.choice(6, n, p=probs)
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.empty((n, 3), np.float32)
    for i in range(n):
        a = axis[i]
        others = [j for j in range(3) if j != a]
        pts[i, a] = sign[i] * half_extents[a]
        pts[i, others[0]] = uv[i, 0] * half_extents[others[0]]
        pts[i, others[1]] = uv[i, 1] * half_extents[others[1]]
    return pts


def _sample_ellipsoid(rng, n, semi):
    z = rng.normal(size=(n, 3))
    z /= np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-12)
    return (z * semi).astype(np.float32)


def _sample_cylinder(rng, n, radius, height):
    # split between lateral surface and caps by area
    lat = 2 * np.pi * radius * height
    cap = np.pi * radius ** 2
    p_lat = lat / (lat + 2 * cap)
    pts = np.empty((n, 3), np.float32)
    on_lat = rng.random(n) < p_lat
    theta = rng.uniform(0, 2 * np.pi, n)
    pts[:, 0] = np.cos(theta) * radius
    pts[:, 1] = np.sin(theta) * radius
    pts[:, 2] = rng.uniform(-height / 2, height / 2, n)
    r_cap = radius * np.sqrt(rng.random(n))
    cap_side = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    pts[~on_lat, 0] = (np.cos(theta) * r_cap)[~on_lat]
    pts[~on_lat, 1] = (np.sin(theta) * r_cap)[~on_lat]
    pts[~on_lat, 2] = (cap_side * height / 2)[~on_lat]
    return pts


def _sample_cone(rng, n, radius, height):
    lat = np.pi * radius * np.hypot(radius, height)
    base = np.pi * radius ** 2
    p_lat = lat / (lat + base)
    theta = rng.uniform(0, 2 * np.pi, n)
    on_lat = rng.random(n) < p_lat
    # lateral: radial coordinate ~ sqrt for uniform area
    t = np.sqrt(rng.random(n))
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = np.cos(theta) * radius * t
    pts[:, 1] = np.sin(theta) * radius * t
    pts[:, 2] = height * (1 - t) - height / 2
    r_base = radius * np.sqrt(rng.random(n))
    pts[~on_lat, 0] = (np.cos(theta) * r_base)[~on_lat]
    pts[~on_lat, 1] = (np.sin(theta) * r_base)[~on_lat]
    pts[~on_lat, 2] = -height / 2
    return pts


def _sample_composite(rng, n):
    """Chiral three-lobe shape (ellipsoid body + box lobe on +x + cone lobe
    on +z): no mirror or 180-degree rotational symmetry about any axis.
    ModelNet objects (chairs, desks) are asymmetric like this; the primitive
    classes above are not — a 180-degree x-rotation maps a box/ellipsoid
    onto itself, which would invert the monotonicity of a distance in the
    rotation angle."""
    n1 = n // 2
    n2 = (n - n1) // 2
    n3 = n - n1 - n2
    body = _sample_ellipsoid(rng, n1, rng.uniform(0.5, 0.9, 3))
    box = (_sample_box(rng, n2, rng.uniform(0.15, 0.35, 3))
           + np.array([rng.uniform(0.6, 0.9), 0.0, 0.0], np.float32))
    cone = (_sample_cone(rng, n3, rng.uniform(0.15, 0.35),
                         rng.uniform(0.4, 0.8))
            + np.array([0.0, rng.uniform(0.1, 0.3),
                        rng.uniform(0.5, 0.9)], np.float32))
    return np.concatenate([body, box, cone], axis=0).astype(np.float32)


_GENERATORS = ("box", "ellipsoid", "cylinder", "cone")


def shape_bank(num_items: int, point_num: int, seed: int = 0,
               kinds: tuple = _GENERATORS) -> np.ndarray:
    """(num_items, point_num, 3) normalized genus-0 shapes with randomized
    proportions — the ModelNet10 stand-in. ``kinds`` selects the classes
    (pass ``("composite",)`` for asymmetric ModelNet-like objects)."""
    rng = np.random.default_rng(seed)
    out = np.empty((num_items, point_num, 3), np.float32)
    for i in range(num_items):
        kind = kinds[i % len(kinds)]
        if kind == "box":
            pts = _sample_box(rng, point_num, rng.uniform(0.3, 1.0, 3))
        elif kind == "ellipsoid":
            pts = _sample_ellipsoid(rng, point_num, rng.uniform(0.3, 1.0, 3))
        elif kind == "cylinder":
            pts = _sample_cylinder(rng, point_num, rng.uniform(0.2, 0.8),
                                   rng.uniform(0.5, 1.5))
        elif kind == "cone":
            pts = _sample_cone(rng, point_num, rng.uniform(0.3, 0.9),
                               rng.uniform(0.5, 1.5))
        elif kind == "composite":
            pts = _sample_composite(rng, point_num)
        else:
            raise ValueError(f"unknown shape kind {kind!r}")
        out[i] = normalize_scale(pts)
    return out
