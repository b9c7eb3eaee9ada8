"""The port's parallel layer (``shwd_torch.parallel``) against the JAX
package's on the same inputs: meshes, the data x slices sharded SSW, the
data-sharded transport, sharded pose refinement and the scaling harness.

The port runs 2 and 4 gloo processes on the CPU (``tests/torch_dist.py``,
about 4 s a spawn); the JAX side runs in this process on the first 2 or 4
devices of the 8-device virtual mesh that ``conftest.py`` sets up. The
inputs are the JAX package's own test inputs (``tests/test_parallel.py``),
converted to numpy. About 50 s on one worker.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist
from shwd_torch.ops.spherical import sliced_cost_sphere as t_sliced
from shwd_torch.train import pose_refine as tpr
from shwd_tpu.ops.spherical import stiefel_frames
from shwd_tpu.parallel import make_mesh, make_sharded_ssw, make_sharded_transport
from shwd_tpu.train import pose_refine as jpr

MESHES = {2: (2, 1), 4: (2, 2)}


def _inputs():
    """test_parallel.py's SSW clouds and frames, and its transport clouds."""
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 32, 3))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    y = jnp.roll(x, 1, axis=1) + 0.05
    frames = stiefel_frames(jax.random.PRNGKey(1), 16)
    tx = jax.random.normal(jax.random.PRNGKey(0), (8, 16, 3))
    return [np.array(a, np.float32) for a in (x, y, frames, tx, tx + 0.1)]


def _jax_values(world, x, y, frames, tx, ty):
    data, slices = MESHES[world]
    mesh = make_mesh(data=data, slices=slices, devices=jax.devices()[:world])
    put = (lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)))
    ssw = jax.jit(make_sharded_ssw(mesh, p=2))(
        put(x, P("data")), put(y, P("data")), put(frames, P("slices")))
    tr = jax.jit(make_sharded_transport(mesh, cost="lp", p=2.0))(
        put(tx, P("data")), put(ty, P("data")))
    return float(ssw), float(tr)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ssw_and_transport_match_jax(world, tmp_path):
    """Every rank: the mesh's shape, make_sharded_ssw's value against the JAX
    package's on its mesh (rtol 1e-5), its gradient (the ranks' mean)
    finite, nonzero and equal to the one-process port gradient (rtol 1e-5,
    atol 1e-7 for entries that cancel), and make_sharded_transport's value
    (rtol 1e-4: each rank's own eps0, as in JAX's shard_map body)."""
    x, y, frames, tx, ty = _inputs()
    data, slices = MESHES[world]
    out = torch_dist.spawn(torch_dist.sharded_losses, world, tmp_path, data, slices,
                           x, y, frames, tx, ty)
    want_ssw, want_tr = _jax_values(world, x, y, frames, tx, ty)

    xt = torch.from_numpy(x).requires_grad_(True)
    one = torch.mean(t_sliced(xt, torch.from_numpy(y), torch.from_numpy(frames), p=2))
    (g_one,) = torch.autograd.grad(one, xt)
    np.testing.assert_allclose(float(one.detach()), want_ssw, rtol=1e-5)
    for r in out:
        assert r["shape"] == {"data": data, "slices": slices}
        np.testing.assert_allclose(r["ssw"], want_ssw, rtol=1e-5)
        np.testing.assert_allclose(r["transport"], want_tr, rtol=1e-4)
        assert np.isfinite(r["grad"]).all() and np.abs(r["grad"]).max() > 0
        np.testing.assert_allclose(r["grad"], g_one.numpy(), rtol=1e-5, atol=1e-7)


def test_make_mesh_defaults_and_rejects_a_wrong_size(tmp_path):
    """One process: the default mesh is the one-process world, made without
    any environment; a mesh larger than the world raises before a group is
    made."""
    out = torch_dist.spawn(torch_dist.one_process_mesh, 1, tmp_path)
    assert out == [((1, 1), True, "a 2x1 mesh needs 2 ranks; 1 given of a world of 1")]


@pytest.mark.parametrize("loss", ["cd", "sinkhorn"])
def test_sharded_refinement_matches_unsharded(tmp_path, loss):
    """``sharded_refine_poses`` on 2 ranks (``tests/test_pose_refine.py``'s
    sharded case: 8 objects of 32 points, 50 steps at lr 0.02) equals the
    port's unsharded ``refine_poses``, and the JAX package's refinement with
    the batch sharded over 8 devices equals its own unsharded one (rtol
    1e-4, atol 1e-5). ``sinkhorn`` takes the plain route here, whose eps0
    is batch-wide: it needs the all-reduced max."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(8, 32, 3)).astype(np.float32)
    angles = np.radians(rng.uniform(-20, 20, size=(8,)))
    rot = np.zeros((8, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1] = np.cos(angles), -np.sin(angles)
    rot[:, 1, 0], rot[:, 1, 1] = np.sin(angles), np.cos(angles)
    rot[:, 2, 2] = 1.0
    tgt = (np.einsum("bij,bnj->bni", rot, src)
           + 0.3 * rng.normal(size=(8, 1, 3))).astype(np.float32)
    want = tpr.refine_poses(torch.from_numpy(src), torch.from_numpy(tgt),
                            tpr.PoseRefineConfig(loss=loss, num_steps=50, lr=0.02))
    for r in torch_dist.spawn(torch_dist.refine, 2, tmp_path, src, tgt, loss, 50, 0.02):
        for k in ("pose_7d", "est_R", "est_t", "per_object_loss", "losses"):
            np.testing.assert_allclose(r[k], getattr(want, k).numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)

    jcfg = jpr.PoseRefineConfig(loss=loss, num_steps=50, lr=0.02)
    j_local = jpr.refine_poses(jnp.asarray(src), jnp.asarray(tgt), jcfg)
    sh = NamedSharding(make_mesh(data=8, slices=1), P("data"))
    j_sharded = jax.jit(lambda s, t: jpr.refine_poses(s, t, jcfg))(
        jax.device_put(jnp.asarray(src), sh), jax.device_put(jnp.asarray(tgt), sh))
    np.testing.assert_allclose(np.asarray(j_sharded.pose_7d), np.asarray(j_local.pose_7d),
                               rtol=1e-4, atol=1e-5)


def test_scaling_harness_runs_and_reports(tmp_path):
    """``measure_scaling([1, 2])`` on 2 ranks, as ``tests/test_scaling.py``:
    one point per mesh size, the first at efficiency 1, every rate and step
    time positive, the same points on both ranks."""
    out = torch_dist.spawn(torch_dist.scaling, 2, tmp_path)
    assert out[0] == out[1]
    pts = out[0]
    assert [p["devices"] for p in pts] == [1, 2]
    assert pts[0]["efficiency"] == 1.0
    for p in pts:
        assert p["clouds_per_second"] > 0 and p["step_seconds"] > 0
