"""Rigid-transform / noise / outlier dataset math, on the batch's device.

Counterpart of ``shwd_tpu/data/transforms.py``: every sample pairs a clean
target cloud with a noisy, rigidly-transformed source cloud plus the
ground-truth pose. The whole batch of transforms is drawn and applied as
tensor math on the device of the clouds; random draws come from an explicit
``torch.Generator`` on that device.

Distributions:
- rotation: per-axis Euler angles uniform in +-angle_range deg, order "xyz";
- translation: direction uniform on the sphere (normalized cube sample),
  magnitude sqrt(translation_range);
- noise: N(mean, sigma^2) on the source only;
- outliers: replace ``outlier_num`` random points of the source with
  N(0, sigma_out^2).

Axis-restricted rotation modes (``rotation_axes``, ``fixed_angle``) give
the x/y/z-only variants and the fixed-angle test sweeps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.quaternion import (
    create_pose_7d, euler_to_quaternion, pose_translation, quat_to_matrix,
    quaternion_rotate,
)


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    angle_range_deg: float = 45.0
    translation_range: float = 1.0
    noise_mean: float = 0.0
    noise_sigma: float = 0.02
    rotation_axes: str = "xyz"       # 'xyz' | 'x' | 'y' | 'z' (restricted modes)
    fixed_angle: bool = False        # True: angle == angle_range (test sweeps)
    outlier_num: int = 0
    outlier_sigma: float = 1.0


class RegistrationBatch(NamedTuple):
    target: torch.Tensor           # (B, M, 3) clean template
    source: torch.Tensor           # (B, N, 3) noisy, transformed source
    igt_rotation: torch.Tensor     # (B, 3, 3) the applied rotation R
    igt_translation: torch.Tensor  # (B, 3)


def _uniform(shape, low, high, generator):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (high - low) * u


def random_pose_7d(generator: torch.Generator, batch: int,
                   cfg: TransformConfig) -> torch.Tensor:
    """Draw B ground-truth poses on ``generator``'s device."""
    dev = generator.device
    max_rot = math.radians(cfg.angle_range_deg)
    if cfg.fixed_angle:
        euler = torch.zeros(batch, 3, device=dev)
        axis_idx = {"x": 0, "y": 1, "z": 2}[cfg.rotation_axes]
        euler[:, axis_idx] = max_rot
    else:
        euler = _uniform((batch, 3), -max_rot, max_rot, generator)
        if cfg.rotation_axes != "xyz":
            for i, axis in enumerate("xyz"):
                if axis not in cfg.rotation_axes:
                    euler[:, i] = 0.0
    quat = euler_to_quaternion(euler, "xyz")
    trans = _uniform((batch, 3), -1.0, 1.0, generator)
    trans = (math.sqrt(cfg.translation_range)
             * trans / torch.linalg.vector_norm(trans, dim=-1, keepdim=True))
    return create_pose_7d(torch.cat([quat, trans], dim=-1))


def apply_pose(source: torch.Tensor, pose_7d: torch.Tensor):
    """Transform (B, N, 3) source; return (transformed, igt_R, igt_t).

    igt_rotation is the applied rotation R; the error metric composes
    R @ est_R and expects est_R ~ R^T at convergence.
    """
    transformed = (quaternion_rotate(source, pose_7d)
                   + pose_translation(pose_7d)[:, None, :])
    igt_rot = quat_to_matrix(pose_7d[..., :4])
    return transformed, igt_rot, pose_translation(pose_7d)


def replace_outliers(noisy: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Replace points ``idx`` (B, K) of each cloud with ``vals`` (B, K, 3)."""
    out = noisy.clone()
    out.scatter_(1, idx[..., None].expand(-1, -1, noisy.shape[-1]), vals)
    return out


def make_registration_batch(generator: torch.Generator, target: torch.Tensor,
                            source: torch.Tensor, cfg: TransformConfig,
                            ) -> RegistrationBatch:
    """Full pipeline: noise source -> (optional) outliers -> rigid transform.
    ``generator`` lives on the clouds' device."""
    b, n, _ = source.shape
    dev = source.device
    noisy = source + (cfg.noise_mean + cfg.noise_sigma * torch.randn(
        source.shape, generator=generator, device=dev, dtype=source.dtype))
    if cfg.outlier_num > 0:
        # outlier_num distinct points per cloud: the first entries of a
        # random order of each row
        order = torch.argsort(
            torch.rand(b, n, generator=generator, device=dev), dim=1)
        idx = order[:, :cfg.outlier_num]
        vals = cfg.outlier_sigma * torch.randn(
            b, cfg.outlier_num, 3, generator=generator, device=dev,
            dtype=source.dtype)
        noisy = replace_outliers(noisy, idx, vals)
    pose = random_pose_7d(generator, b, cfg)
    transformed, igt_rot, igt_t = apply_pose(noisy, pose)
    return RegistrationBatch(target, transformed, igt_rot, igt_t)
