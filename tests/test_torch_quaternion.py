"""Port parity: the quaternion / SE(3) functions vs shwd_tpu.ops.quaternion.

Inputs come from a numpy seed; every comparison is rtol 1e-5 / atol 1e-6
(the same f32 formulas, only the order of a few sums may differ).
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.ops import quaternion as tq
from shwd_tpu.ops import quaternion as jq

TOL = dict(rtol=1e-5, atol=1e-6)


def _rng():
    return np.random.default_rng(21)


def _quat(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rot(rng, n):
    """n rotation matrices as a writable numpy array."""
    return np.array(jq.quat_to_matrix(jnp.asarray(_quat(rng, n))))


def _both(name, *arrays, **kw):
    want = getattr(jq, name)(*(jnp.asarray(a) for a in arrays), **kw)
    got = getattr(tq, name)(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got


def test_qmul():
    rng = _rng()
    _both("qmul", _quat(rng, 5, 3), _quat(rng, 5, 3))


def test_qrot():
    rng = _rng()
    got = _both("qrot", _quat(rng, 4, 7), rng.normal(size=(4, 7, 3)).astype(np.float32))
    assert got.shape == (4, 7, 3)


@pytest.mark.parametrize("order", ["xyz", "zyx", "yzx"])
def test_euler_to_quaternion(order):
    e = _rng().uniform(-1, 1, size=(6, 3)).astype(np.float32)
    _both("euler_to_quaternion", e, order=order)


def test_quat_to_matrix():
    got = _both("quat_to_matrix", _quat(_rng(), 2, 5))
    eye = torch.eye(3).expand(2, 5, 3, 3)
    np.testing.assert_allclose((got @ got.transpose(-1, -2)).numpy(), eye.numpy(),
                               atol=1e-5)


def test_create_pose_7d_and_accessors():
    vec = _rng().normal(size=(4, 7)).astype(np.float32)
    pose = _both("create_pose_7d", vec)
    np.testing.assert_allclose(torch.linalg.vector_norm(pose[:, :4], dim=-1).numpy(),
                               np.ones(4), atol=1e-6)
    _both("pose_quaternion", pose.numpy())
    _both("pose_translation", pose.numpy())
    # a zero quaternion is clamped, not divided by zero
    assert torch.isfinite(tq.create_pose_7d(torch.zeros(1, 7))).all()


def test_quaternion_rotate_and_transform():
    rng = _rng()
    pts = rng.normal(size=(3, 9, 3)).astype(np.float32)
    pose = np.concatenate([_quat(rng, 3), rng.normal(size=(3, 3)).astype(np.float32)], -1)
    _both("quaternion_rotate", pts, pose)
    _both("quaternion_transform", pts, pose)


def test_convert2transformation():
    rng = _rng()
    rot = _rot(rng, 3)
    trans = rng.normal(size=(3, 1, 3)).astype(np.float32)
    got = _both("convert2transformation", rot, trans)
    assert got.shape == (3, 4, 4)


def test_rotation_error_deg():
    """Includes the identity (error 0) and a half turn (error 180), where
    an arccos form would lose digits."""
    rng = _rng()
    rot = _rot(rng, 6)
    est = _rot(rng, 6)
    est[0] = rot[0].T
    est[1] = rot[1].T @ np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    got = _both("rotation_error_deg", rot, est)
    assert float(got[0]) < 1e-2 and abs(float(got[1]) - 180.0) < 1e-2


def test_translation_error():
    rng = _rng()
    rot = _rot(rng, 5)
    _both("translation_error", rot, rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(5, 3)).astype(np.float32))
