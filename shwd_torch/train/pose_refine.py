"""Pose refinement: per-object SE(3) poses fitted by gradient descent.

Counterpart of ``shwd_tpu/train/pose_refine.py``: given B (source, target)
cloud pairs, Adam optimises each object's raw 7-vector (quaternion and
translation, the parameterisation PCRNet regresses) against a
differentiable cloud distance. Objects are independent: the objective is
the sum over the batch, so gradients never mix.

Losses: ``"cd"`` (Chamfer both ways), ``"ssw"`` (spherical sliced
Wasserstein on fresh frames each step) and ``"sinkhorn"`` (``emd2_points``:
on the card the fused Sinkhorn kernel K3 with its envelope gradient, one
launch per step and one for the final per-object loss).

``refine_model_output`` seeds the poses from a registration model's
estimate (coarse network, fine refinement). The step loop runs on the
device without host syncs; the loss trace stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops.chamfer import chamfer_directional
from ..ops.quaternion import (
    create_pose_7d, pose_translation, quat_to_matrix, quaternion_transform,
)
from ..ops.sinkhorn_fused import emd2_points
from ..ops.spherical import sliced_cost_sphere, stiefel_frames


@dataclasses.dataclass(frozen=True)
class PoseRefineConfig:
    loss: str = "cd"            # 'cd' | 'ssw' | 'sinkhorn'
    num_steps: int = 100
    lr: float = 0.01
    p: float = 2.0
    num_projections: int = 64   # ssw
    eps: float = 5e-3           # sinkhorn
    num_iters: int = 30
    num_scales: int = 3


class PoseRefineResult(NamedTuple):
    pose_7d: torch.Tensor          # (B, 7) normalised quaternion + translation
    est_R: torch.Tensor            # (B, 3, 3)
    est_t: torch.Tensor            # (B, 3)
    losses: torch.Tensor           # (num_steps,) summed objective trace
    per_object_loss: torch.Tensor  # (B,) final per-object loss


def _per_object_loss(cfg: PoseRefineConfig, moved, target, generator, frames=None):
    """(B,) loss of the moved clouds; ``frames`` (L, 3, 2) replaces the
    ``ssw`` draw."""
    if cfg.loss == "cd":
        return chamfer_directional(moved, target) + chamfer_directional(target, moved)
    if cfg.loss == "ssw":
        if frames is None:
            frames = stiefel_frames(generator, cfg.num_projections, moved.shape[-1],
                                    device=moved.device)
        return sliced_cost_sphere(moved, target, frames, p=cfg.p)
    if cfg.loss == "sinkhorn":
        return emd2_points(moved, target, "lp", cfg.p, eps=cfg.eps,
                           num_iters=cfg.num_iters, num_scales=cfg.num_scales)
    raise ValueError(f"unknown refine loss {cfg.loss!r}")


def refine_poses(source: torch.Tensor, target: torch.Tensor,
                 cfg: PoseRefineConfig = PoseRefineConfig(),
                 generator: Optional[torch.Generator] = None,
                 init_pose: Optional[torch.Tensor] = None,
                 frames: Optional[torch.Tensor] = None) -> PoseRefineResult:
    """Optimise per-object poses aligning source -> target.

    source (B, N, 3), target (B, M, 3), on the card or the CPU.
    ``init_pose``: optional (B, 7) raw pose (e.g. PCRNet's output), the
    identity by default. ``generator`` draws the ``ssw`` frames (a fresh
    one seeded 0 on the clouds' device when not given); ``frames``
    (num_steps + 1, L, 3, 2) replaces those draws, the last for the final
    per-object loss.
    """
    if cfg.loss not in ("cd", "ssw", "sinkhorn"):
        raise ValueError(f"unknown refine loss {cfg.loss!r}")
    source, target = source.detach(), target.detach()
    b, dev = source.shape[0], source.device
    if generator is None and cfg.loss == "ssw" and frames is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if init_pose is None:
        init_pose = torch.zeros(b, 7, dtype=source.dtype, device=dev)
        init_pose[:, 0] = 1.0
    raw = init_pose.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([raw], lr=cfg.lr)

    def objective(raw, s):
        moved = quaternion_transform(source, create_pose_7d(raw))
        per_obj = _per_object_loss(cfg, moved, target, generator,
                                   None if frames is None else frames[s])
        return torch.sum(per_obj), per_obj

    losses = []
    with torch.enable_grad():
        for s in range(cfg.num_steps):
            total, _ = objective(raw, s)
            opt.zero_grad(set_to_none=True)
            total.backward()
            opt.step()
            losses.append(total.detach())
    with torch.no_grad():
        pose = create_pose_7d(raw)
        _, per_obj = objective(raw, cfg.num_steps)
    return PoseRefineResult(
        pose_7d=pose,
        est_R=quat_to_matrix(pose[..., :4]),
        est_t=pose_translation(pose),
        losses=torch.stack(losses) if losses else source.new_zeros(0),
        per_object_loss=per_obj,
    )


def refine_model_output(source: torch.Tensor, target: torch.Tensor,
                        est_R: torch.Tensor, est_t: torch.Tensor,
                        cfg: PoseRefineConfig = PoseRefineConfig(),
                        generator: Optional[torch.Generator] = None,
                        frames: Optional[torch.Tensor] = None) -> PoseRefineResult:
    """Polish a learned registration estimate (coarse to fine).

    Takes PCRNet's est_R (B, 3, 3) and est_t (B, 1, 3) or (B, 3) and
    refines from there. The rotation becomes the initial quaternion through
    the JAX package's branchless form, clamps included (exact for rotations
    with trace > -1).
    """
    r = est_R.detach()
    t = est_t.detach().reshape(est_t.shape[0], 3)
    m00, m11, m22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    w = torch.sqrt(torch.clamp_min(1.0 + m00 + m11 + m22, 1e-12)) / 2.0
    den = torch.clamp_min(4.0 * w, 1e-8)
    x = (r[..., 2, 1] - r[..., 1, 2]) / den
    y = (r[..., 0, 2] - r[..., 2, 0]) / den
    z = (r[..., 1, 0] - r[..., 0, 1]) / den
    init = torch.cat([torch.stack([w, x, y, z], -1), t], dim=-1)
    return refine_poses(source, target, cfg, generator, init_pose=init, frames=frames)
