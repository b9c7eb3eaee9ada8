"""ModelNet-style mesh dataset: OFF loading, area-weighted sampling, caching
(numpy only).

Copy of ``shwd_tpu/data/modelnet.py``. Meshes are preprocessed offline into
dense (num_meshes, N, 3) float32 arrays saved as .npz; a training job then
loads arrays and never touches mesh code. Area-weighted triangle sampling
and unit-cube scale normalization reproduce torch_geometric's
SamplePoints / NormalizeScale at the distribution level.

When neither a cache file nor a ModelNet directory is available,
``load_dataset`` falls back to the procedural shape bank in
``synthetic.py`` with the same array contract.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def read_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OFF mesh -> (vertices (V,3) f32, faces (F,3) i32).

    Handles the common ModelNet quirk of 'OFF' glued to the count line.
    Quads are fan-triangulated.
    """
    with open(path, "r") as f:
        first = f.readline().strip()
        if first == "OFF":
            counts = f.readline().split()
        elif first.startswith("OFF"):
            counts = first[3:].split()
        else:
            raise ValueError(f"not an OFF file: {path}")
        nv, nf = int(counts[0]), int(counts[1])
        verts = np.loadtxt(f, max_rows=nv, dtype=np.float32).reshape(nv, 3)
        faces = []
        for _ in range(nf):
            row = f.readline().split()
            k = int(row[0])
            idx = [int(v) for v in row[1:1 + k]]
            for j in range(1, k - 1):
                faces.append([idx[0], idx[j], idx[j + 1]])
    return verts, np.asarray(faces, np.int32)


def sample_mesh_points(rng: np.random.Generator, verts: np.ndarray,
                       faces: np.ndarray, n: int) -> np.ndarray:
    """Area-weighted uniform surface sampling (SamplePoints equivalent)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = areas.sum()
    probs = areas / total if total > 0 else np.full(len(areas), 1 / len(areas))
    tri = rng.choice(len(faces), size=n, p=probs)
    u = rng.random((n, 1)).astype(np.float32)
    v = rng.random((n, 1)).astype(np.float32)
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])


def normalize_scale(points: np.ndarray) -> np.ndarray:
    """Center and scale into [-1, 1]^3 * 0.999999 (NormalizeScale parity)."""
    points = points - points.mean(axis=-2, keepdims=True)
    scale = np.abs(points).max(axis=(-2, -1), keepdims=True)
    return points * (0.999999 / np.maximum(scale, 1e-12))


def preprocess_modelnet(root: str, out_dir: str, point_num: int,
                        split: str = "train", name: str = "10",
                        seed: int = 0) -> str:
    """Offline pass: sample every OFF mesh of ModelNet<name>/<class>/<split>
    into an (M, point_num, 3) array + integer labels; saves npz, returns path.
    """
    root_p = Path(root)
    classes = sorted(d.name for d in root_p.iterdir() if d.is_dir())
    rng = np.random.default_rng(seed)
    clouds, labels = [], []
    for ci, cls in enumerate(classes):
        for off in sorted((root_p / cls / split).glob("*.off")):
            verts, faces = read_off(str(off))
            pts = sample_mesh_points(rng, verts, faces, point_num)
            clouds.append(normalize_scale(pts))
            labels.append(ci)
    arr = np.stack(clouds).astype(np.float32)
    out = Path(out_dir) / f"modelnet{name}_{point_num}_{split}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, clouds=arr, labels=np.asarray(labels, np.int32),
                        classes=np.asarray(classes))
    return str(out)


def load_dataset(point_num: int, split: str = "train",
                 modelnet_root: Optional[str] = None,
                 cache_dir: str = "modelnet_cache",
                 num_synthetic: int = 512, seed: int = 0,
                 synthetic_kinds: Optional[tuple] = None) -> np.ndarray:
    """(M, point_num, 3) clouds: cached ModelNet arrays if available,
    else the procedural genus-0 shape bank (synthetic.py)."""
    cache = Path(cache_dir) / f"modelnet10_{point_num}_{split}.npz"
    if cache.exists():
        return np.load(cache)["clouds"]
    if modelnet_root and Path(modelnet_root).exists():
        path = preprocess_modelnet(modelnet_root, cache_dir, point_num, split)
        return np.load(path)["clouds"]
    from .synthetic import shape_bank
    n_items = num_synthetic if split == "train" else max(num_synthetic // 4, 8)
    kw = {} if synthetic_kinds is None else {"kinds": tuple(synthetic_kinds)}
    return shape_bank(n_items, point_num,
                      seed=seed + (0 if split == "train" else 10_000), **kw)
