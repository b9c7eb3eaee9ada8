"""Quaternion / SE(3) math on tensors.

Counterpart of ``shwd_tpu/ops/quaternion.py``: the pose math of the
registration pipeline (qmul, qrot, euler_to_quaternion), the pose-7d
helpers (create / rotate / transform / 4x4 compose) and the rotation and
translation error metrics.

Conventions: quaternions are scalar-first (w, x, y, z); a pose-7d is
``[quat(4), translation(3)]`` with the quaternion normalized on use.
"""

from __future__ import annotations

import torch


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q (x) r, broadcasting over leading dims."""
    w1, x1, y1, z1 = torch.unbind(q, -1)
    w2, x2, y2, z2 = torch.unbind(r, -1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return torch.stack([w, x, y, z], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4), broadcasting
    (Rodrigues via two cross products)."""
    qvec = q[..., 1:]
    qvec, v = torch.broadcast_tensors(qvec, v)
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def euler_to_quaternion(e: torch.Tensor, order: str = "xyz") -> torch.Tensor:
    """Euler angles (..., 3) -> quaternion (..., 4), including the final
    antipodal sign flip for right-handed orders."""
    x, y, z = torch.unbind(e, -1)
    zeros = torch.zeros_like(x)
    comp = {
        "x": torch.stack([torch.cos(x / 2), torch.sin(x / 2), zeros, zeros], dim=-1),
        "y": torch.stack([torch.cos(y / 2), zeros, torch.sin(y / 2), zeros], dim=-1),
        "z": torch.stack([torch.cos(z / 2), zeros, zeros, torch.sin(z / 2)], dim=-1),
    }
    result = comp[order[0]]
    for axis in order[1:]:
        result = qmul(result, comp[axis])
    if order in ("xyz", "yzx", "zxy"):
        result = -result
    return result


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = torch.unbind(q, -1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# pose-7d helpers (quat + translation)
# ---------------------------------------------------------------------------

def create_pose_7d(vec: torch.Tensor) -> torch.Tensor:
    """Normalize the quaternion part of a raw (..., 7) pose vector."""
    quat = vec[..., :4]
    quat = quat / torch.clamp_min(
        torch.linalg.vector_norm(quat, dim=-1, keepdim=True), 1e-12)
    return torch.cat([quat, vec[..., 4:]], dim=-1)


def pose_quaternion(pose_7d: torch.Tensor) -> torch.Tensor:
    return pose_7d[..., :4]


def pose_translation(pose_7d: torch.Tensor) -> torch.Tensor:
    return pose_7d[..., 4:]


def quaternion_rotate(points: torch.Tensor, pose_7d: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 3) points by the quaternion of a (..., 7) pose."""
    quat = pose_quaternion(pose_7d)[..., None, :]
    return qrot(quat.expand(points.shape[:-1] + (4,)), points)


def quaternion_transform(points: torch.Tensor, pose_7d: torch.Tensor) -> torch.Tensor:
    """Apply the full rigid transform R p + t."""
    return quaternion_rotate(points, pose_7d) + pose_translation(pose_7d)[..., None, :]


def convert2transformation(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) rotation + (B, 1, 3) translation -> (B, 4, 4) homogeneous."""
    batch = rot.shape[0]
    top = torch.cat([rot, trans.transpose(-1, -2)], dim=-1)          # (B, 3, 4)
    # filled on the device: a tensor made from a Python list would be a
    # synchronising host-to-device copy inside the train step
    bottom = rot.new_zeros(batch, 1, 4)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# error metrics
# ---------------------------------------------------------------------------

def rotation_error_deg(rot: torch.Tensor, est_rot: torch.Tensor) -> torch.Tensor:
    """|axis-angle(R @ R_hat)| in degrees, batched over leading dims.

    The angle uses ``atan2(|skew(E)| / 2, (tr(E) - 1) / 2)``, which stays
    accurate at small angles where an arccos of the trace alone loses
    digits.
    """
    err = torch.einsum("...ij,...jk->...ik", rot, est_rot)
    tr = err[..., 0, 0] + err[..., 1, 1] + err[..., 2, 2]
    cos = (tr - 1.0) / 2.0
    axis = torch.stack([
        err[..., 2, 1] - err[..., 1, 2],
        err[..., 0, 2] - err[..., 2, 0],
        err[..., 1, 0] - err[..., 0, 1],
    ], dim=-1)
    sin = torch.linalg.vector_norm(axis, dim=-1) / 2.0
    return torch.abs(torch.rad2deg(torch.atan2(sin, cos)))


def translation_error(rot: torch.Tensor, trans: torch.Tensor,
                      est_trans: torch.Tensor) -> torch.Tensor:
    """L2 of (-R^T t - t_hat), batched; ``trans``/``est_trans`` are (..., 3)."""
    target = -torch.einsum("...ji,...j->...i", rot, trans)
    return torch.sqrt(torch.sum(torch.square(target - est_trans), dim=-1))
