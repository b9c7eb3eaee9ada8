"""Pose refinement in the port: recovery of known rigid transforms (as
``tests/test_pose_refine.py``) and 20-step parity with the JAX package for
each loss on the same clouds and draws.

For ``"sinkhorn"`` both routes are held: by default the port's CPU tensors
take ``emd2_approx`` (one batch-global eps0), as the JAX package's XLA
fallback does on the CPU; the kernel route (per-item eps0) is the port's
plain twin of K3 (``use_kernel=True``) against the JAX package's Pallas
kernel in interpret mode (``use_pallas=True, interpret=True``), each
patched into its module inside the test. About 40 s on one worker (the
interpret-mode kernel and the 300-step recovery).
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.ops import sinkhorn_fused as t_fused
from shwd_torch.ops.quaternion import rotation_error_deg
from shwd_torch.train import pose_refine as tpr
from shwd_tpu.ops import sinkhorn_pallas as j_fused
from shwd_tpu.ops.spherical import stiefel_frames
from shwd_tpu.train import pose_refine as jpr


def _make_problem(rng, b=4, n=64, angle_deg=20.0):
    """Random clouds; target = R @ source + t."""
    src = rng.normal(size=(b, n, 3)).astype(np.float32)
    angles = np.radians(rng.uniform(-angle_deg, angle_deg, size=(b,)))
    cs, ss = np.cos(angles), np.sin(angles)
    R = np.zeros((b, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1] = cs, -ss
    R[:, 1, 0], R[:, 1, 1] = ss, cs
    R[:, 2, 2] = 1.0
    t = 0.3 * rng.normal(size=(b, 1, 3)).astype(np.float32)
    tgt = np.einsum("bij,bnj->bni", R, src) + t
    return src, tgt.astype(np.float32), R, t[:, 0]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_refine_recovers_rigid_transform(rng):
    src, tgt, R_true, t_true = _make_problem(rng)
    s, g, R = _t(src, tgt, R_true)
    res = tpr.refine_poses(s, g, tpr.PoseRefineConfig(loss="cd", num_steps=300, lr=0.02))
    err = rotation_error_deg(res.est_R.transpose(-1, -2), R)
    assert float(err.max()) < 2.0
    np.testing.assert_allclose(res.est_t.numpy(), t_true, atol=0.05)
    assert float(res.losses[-1]) < 0.05 * float(res.losses[0])


def test_refine_loss_trace_falls_and_quaternions_are_unit(rng):
    src, tgt, _, _ = _make_problem(rng, b=2, n=48)
    res = tpr.refine_poses(*_t(src, tgt), tpr.PoseRefineConfig(num_steps=100, lr=0.02))
    assert res.losses.shape == (100,) and float(res.losses[-1]) < float(res.losses[0])
    assert res.pose_7d.shape == (2, 7) and res.per_object_loss.shape == (2,)
    np.testing.assert_allclose(np.linalg.norm(res.pose_7d[:, :4].numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_refine_from_model_output_improves(rng):
    """Seeded from a pose 5 deg and 0.05 off the truth, refinement
    converges (coarse to fine)."""
    src, tgt, R_true, t_true = _make_problem(rng, b=3)
    e = np.radians(5.0)
    P = np.asarray([[np.cos(e), -np.sin(e), 0], [np.sin(e), np.cos(e), 0], [0, 0, 1]],
                   np.float32)
    R0 = np.einsum("ij,bjk->bik", P, R_true)
    s, g, r0, t0, R = _t(src, tgt, R0, t_true + 0.05, R_true)
    res = tpr.refine_model_output(s, g, r0, t0,
                                  tpr.PoseRefineConfig(loss="cd", num_steps=150, lr=0.01))
    err = rotation_error_deg(res.est_R.transpose(-1, -2), R)
    assert float(err.max()) < 2.0


def _frames(key, cfg):
    keys = jax.random.split(key, cfg.num_steps + 1)
    return torch.from_numpy(np.stack([np.asarray(stiefel_frames(k, cfg.num_projections, 3))
                                      for k in keys]))


@pytest.mark.parametrize("case", ["cd", "cd_model_output", "ssw", "sinkhorn",
                                  "sinkhorn_kernel_route"])
def test_twenty_steps_match_jax(case, rng, monkeypatch):
    """20 Adam steps from the same start (the identity, or a model's
    estimate 8 deg off): the loss trace, the final poses and the final
    per-object losses agree (rtol 1e-4, poses atol 1e-5)."""
    loss = case.split("_")[0]
    src, tgt, R_true, t_true = _make_problem(rng, b=3, n=32)
    cfg = dict(loss=loss, num_steps=20, lr=0.01, num_projections=16)
    jcfg, tcfg = jpr.PoseRefineConfig(**cfg), tpr.PoseRefineConfig(**cfg)
    key = jax.random.PRNGKey(7)
    frames = _frames(key, tcfg) if loss == "ssw" else None
    if case == "sinkhorn_kernel_route":
        monkeypatch.setattr(jpr, "emd2_points", functools.partial(
            j_fused.emd2_points, use_pallas=True, interpret=True))
        monkeypatch.setattr(tpr, "emd2_points", functools.partial(
            t_fused.emd2_points, use_kernel=True))
    if case == "cd_model_output":
        e = np.radians(8.0)
        P = np.asarray([[1, 0, 0], [0, np.cos(e), -np.sin(e)], [0, np.sin(e), np.cos(e)]],
                       np.float32)
        R0 = np.einsum("ij,bjk->bik", P, R_true)
        t0 = t_true - 0.04
        want = jpr.refine_model_output(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(R0),
                                       jnp.asarray(t0), jcfg, key)
        got = tpr.refine_model_output(*_t(src, tgt, R0, t0), tcfg)
    else:
        want = jpr.refine_poses(jnp.asarray(src), jnp.asarray(tgt), jcfg, key)
        got = tpr.refine_poses(*_t(src, tgt), tcfg, frames=frames)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
    np.testing.assert_allclose(got.pose_7d.numpy(), np.asarray(want.pose_7d), atol=1e-5)
    np.testing.assert_allclose(got.est_R.numpy(), np.asarray(want.est_R), atol=1e-5)
    np.testing.assert_allclose(got.per_object_loss.numpy(),
                               np.asarray(want.per_object_loss), rtol=1e-4)
    assert float(got.losses[-1]) < float(got.losses[0])


def test_unknown_loss_raises():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="unknown refine loss"):
        tpr.refine_poses(x, x, tpr.PoseRefineConfig(loss="emd"))
