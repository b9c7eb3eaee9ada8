"""Metric-behaviour sweeps: Wasserstein against Chamfer, Sinkhorn and KL.

Counterpart of ``shwd_tpu/train/comparison.py``:

- ``rotation_sweep`` / ``translation_sweep``: for a grid of rotation
  angles (or translation magnitudes), the mean Chamfer, Sinkhorn and
  near-exact Wasserstein distances between each cloud and its transformed
  copy: the evidence that W grows steadily where Chamfer flattens;
- ``gaussian_kl_vs_w2``: the closed-form KL against W2 for translated
  Gaussians.

One dataset is moved per grid point on the device; the metrics need no
gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.transforms import TransformConfig, make_registration_batch
from ..device import resolve_device
from ..ops.chamfer import chamfer
from ..ops.costs import lp_cost
from ..ops.sinkhorn import emd2_approx, sinkhorn_log


@dataclasses.dataclass
class SweepResult:
    grid: np.ndarray
    chamfer: np.ndarray
    sinkhorn: np.ndarray
    wasserstein: np.ndarray


@torch.no_grad()
def _metrics_batch(template: torch.Tensor, source: torch.Tensor):
    """(Chamfer, mean Sinkhorn W, mean near-exact W) of one batch; the two
    transport values are square roots of <P, C> on the squared cost."""
    cd = chamfer(source, template)
    c = lp_cost(source, template, 2)
    sk, _, _ = sinkhorn_log(c, eps=0.01, num_iters=100)
    wd = emd2_approx(c, eps=2e-3, num_iters=60, num_scales=5)
    return (cd, torch.mean(torch.sqrt(torch.clamp_min(sk, 1e-30))),
            torch.mean(torch.sqrt(torch.clamp_min(wd, 1e-30))))


def rotation_sweep(clouds: np.ndarray, angles_deg: np.ndarray,
                   noise_sigma: float = 0.0, seed: int = 0,
                   device: str | torch.device | None = None,
                   sources: Optional[Sequence[np.ndarray]] = None) -> SweepResult:
    """For each angle: rotate every cloud (B, N, 3) by exactly that angle
    about x and record the metric means. Runs on the card unless
    ``device="cpu"``; ``sources`` (one (B, N, 3) array per angle) replaces
    the transformed clouds the generator would draw."""
    return _sweep(clouds, angles_deg, "rotation", noise_sigma, seed, device, sources)


def translation_sweep(clouds: np.ndarray, magnitudes: np.ndarray,
                      noise_sigma: float = 0.0, seed: int = 0,
                      device: str | torch.device | None = None,
                      sources: Optional[Sequence[np.ndarray]] = None) -> SweepResult:
    """For each magnitude: translate every cloud by that length in a random
    direction and record the metric means (``sources`` as in
    ``rotation_sweep``)."""
    return _sweep(clouds, magnitudes, "translation", noise_sigma, seed, device, sources)


def _sweep(clouds, grid, mode, noise_sigma, seed, device, sources):
    dev = resolve_device(device)
    target = torch.as_tensor(np.asarray(clouds), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cds, sks, wds = [], [], []
    for i, g in enumerate(grid):
        if sources is not None:
            source = torch.as_tensor(np.asarray(sources[i]), dtype=torch.float32,
                                     device=dev)
        else:
            if mode == "rotation":
                cfg = TransformConfig(angle_range_deg=float(g), translation_range=1e-12,
                                      noise_sigma=noise_sigma, rotation_axes="x",
                                      fixed_angle=True)
            else:
                cfg = TransformConfig(angle_range_deg=1e-9,
                                      translation_range=float(g) ** 2 + 1e-12,
                                      noise_sigma=noise_sigma)
            source = make_registration_batch(gen, target, target, cfg).source
        cd, sk, wd = _metrics_batch(target, source)
        cds.append(float(cd))
        sks.append(float(sk))
        wds.append(float(wd))
    return SweepResult(np.asarray(grid), np.asarray(cds), np.asarray(sks),
                       np.asarray(wds))


def gaussian_kl_vs_w2(sigma: np.ndarray, translations: np.ndarray):
    """Closed forms for N(0, diag(sigma^2)) against its translate by t:
    KL = 0.5 t^T Sigma^{-1} t, W2 = ||t||."""
    t = np.asarray(translations, np.float64)          # (G, d)
    inv = 1.0 / np.asarray(sigma, np.float64) ** 2    # (d,)
    kl = 0.5 * np.sum(t * t * inv, axis=-1)
    w2 = np.linalg.norm(t, axis=-1)
    return kl, w2
