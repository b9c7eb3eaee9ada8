"""Pose refinement's fused path on the CPU.

``refine_poses`` caches, per configuration and shape, the refine step and
the final objective as ``StepGraph``s with their static buffers; on the CPU
a graph is its function called directly on those buffers, so the fused
path must give the per-step path's numbers (``fused=False``: fresh
buffers, the same steps op by op) bit for bit, and a second call on the
same cache entry must start from a clean state (``raw``, Adam's moments
and step, the trace's counter). Held for ``cd``, ``ssw`` with handed-in
frames and with the generator's draws, and ``sinkhorn``; then the fused
path against the JAX ``refine_poses`` at the tolerances of
``test_torch_pose_refine.py::test_twenty_steps_match_jax``. About 10 s on
one worker.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.train import pose_refine as tpr
from shwd_tpu.ops.spherical import stiefel_frames
from shwd_tpu.train import pose_refine as jpr
from test_torch_pose_refine import _make_problem


def _frames(key, cfg):
    keys = jax.random.split(key, cfg.num_steps + 1)
    return torch.from_numpy(np.stack([np.asarray(stiefel_frames(k, cfg.num_projections, 3))
                                      for k in keys]))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["cd", "ssw_frames", "ssw_generator", "sinkhorn"])
def test_fused_refinement_equals_the_per_step_path(case):
    """Two fused calls (the second on the cached buffers, after a call on
    other clouds) and one per-step call from the same start: poses, loss
    trace and per-object losses equal bit for bit; with the generator's
    draws the caller's generator ends where the per-step draws leave it."""
    loss = case.split("_")[0]
    rng = np.random.default_rng(3)
    src, tgt, _, _ = _make_problem(rng, b=3, n=32)
    other, _, _, _ = _make_problem(rng, b=3, n=32)
    s, g, o = (torch.from_numpy(a) for a in (src, tgt, other))
    cfg = tpr.PoseRefineConfig(loss=loss, num_steps=12, lr=0.01, num_projections=8)
    frames = _frames(jax.random.PRNGKey(4), cfg) if case == "ssw_frames" else None
    init = torch.tensor([[0.98, 0.1, -0.1, 0.05, 0.02, -0.03, 0.01]] * 3)
    tpr.clear_cache()
    gens = [torch.Generator().manual_seed(9) for _ in range(3)]
    first = tpr.refine_poses(s, g, cfg, gens[0], init_pose=init, frames=frames)
    tpr.refine_poses(o, g, cfg, torch.Generator().manual_seed(1), frames=frames)
    second = tpr.refine_poses(s, g, cfg, gens[1], init_pose=init, frames=frames)
    step = tpr.refine_poses(s, g, cfg, gens[2], init_pose=init, frames=frames, fused=False)
    assert _same(first, step) and _same(second, step)
    assert float(step.losses[-1]) < float(step.losses[0])
    if case == "ssw_generator":
        assert torch.equal(gens[0].get_state(), gens[2].get_state())
        assert torch.equal(gens[1].get_state(), gens[2].get_state())
    stats = tpr.cached_graphs()
    assert [st["name"].split(" of")[0] for st in stats] == ["refine step", "refine final"]
    assert [st["replays"] for st in stats] == [3 * cfg.num_steps, 3]


def test_fused_results_are_copies():
    """A result survives the next call on the same cache entry."""
    rng = np.random.default_rng(5)
    src, tgt, _, _ = _make_problem(rng, b=2, n=16)
    s, g = torch.from_numpy(src), torch.from_numpy(tgt)
    cfg = tpr.PoseRefineConfig(loss="cd", num_steps=4)
    a = tpr.refine_poses(s, g, cfg)
    kept = [t.clone() for t in a]
    tpr.refine_poses(g, s, cfg)
    assert _same(a, kept)


@pytest.mark.parametrize("loss", ["cd", "ssw", "sinkhorn"])
def test_fused_refinement_matches_jax(loss):
    """20 steps of the fused path (the cached step, called twice to hold the
    reset too) against the JAX refine_poses from the identity on the same
    clouds and frames: loss trace and per-object losses rtol 1e-4, poses
    and rotations atol 1e-5."""
    rng = np.random.default_rng(0)
    src, tgt, _, _ = _make_problem(rng, b=3, n=32)
    kw = dict(loss=loss, num_steps=20, lr=0.01, num_projections=16)
    jcfg, tcfg = jpr.PoseRefineConfig(**kw), tpr.PoseRefineConfig(**kw)
    key = jax.random.PRNGKey(7)
    frames = _frames(key, tcfg) if loss == "ssw" else None
    want = jpr.refine_poses(jnp.asarray(src), jnp.asarray(tgt), jcfg, key)
    s, g = torch.from_numpy(src), torch.from_numpy(tgt)
    for _ in range(2):
        got = tpr.refine_poses(s, g, tcfg, frames=frames)
        np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-4)
        np.testing.assert_allclose(got.pose_7d.numpy(), np.asarray(want.pose_7d), atol=1e-5)
        np.testing.assert_allclose(got.est_R.numpy(), np.asarray(want.est_R), atol=1e-5)
        np.testing.assert_allclose(got.per_object_loss.numpy(),
                                   np.asarray(want.per_object_loss), rtol=1e-4)
