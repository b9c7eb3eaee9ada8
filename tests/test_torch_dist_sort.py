"""The port's point-axis parallelism (``shwd_torch.parallel.dist_sort``)
against the JAX package's on the same inputs.

The port runs 2 and 4 gloo processes on the CPU, each holding one block of
the point axis (``tests/torch_dist.py``, about 4 s a spawn); the JAX side
runs its ``shard_map`` functions in this process on as many devices of the
virtual mesh. Shapes and seeds are those of ``tests/test_dist_sort.py``.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist
from shwd_torch.ops.spherical import sliced_cost_sphere as t_sliced
from shwd_tpu.ops.spherical import stiefel_frames
from shwd_tpu.parallel import (dist_cumsum, dist_emd1d, dist_emd1d_circle,
                               dist_sort, make_dist_ssw)


def _inputs():
    f32 = (lambda a: np.asarray(a, np.float32))
    x = f32(np.random.default_rng(0).normal(size=(3, 5, 64)))
    keys = f32(np.random.default_rng(1).permutation(128)[None])
    w = f32(np.random.default_rng(2).normal(size=(4, 64)))
    rng = np.random.default_rng(3)
    u = f32(rng.normal(size=(5, 128)))
    v = f32(rng.normal(size=(5, 128)) + 0.3)
    rng = np.random.default_rng(4)
    cu = f32(rng.uniform(size=(6, 128)))
    cv = f32(rng.uniform(size=(6, 64)))
    return x, keys, -2.0 * keys, w, u, v, cu, cv


def _spmd(fn, mesh, *args, out_specs):
    specs = tuple(P(*([None] * (a.ndim - 1) + ["points"])) for a in args)
    f = shard_map(fn, mesh=mesh, in_specs=specs, out_specs=out_specs, check_vma=False)
    return np.asarray(jax.jit(f)(*(jnp.asarray(a) for a in args)))


def _jax_side(world, x, keys, payload, w, u, v, cu, cv):
    d = world
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:d]).reshape(1, d),
                             ("data", "points"))
    last = P(None, None, "points")
    sorted_kp = _spmd(lambda k, p: jnp.stack(dist_sort(k, d, payload=p)), mesh,
                      keys, payload, out_specs=last)
    return {"sort": _spmd(lambda a: dist_sort(a, d), mesh, x, out_specs=last),
            "keys": sorted_kp[0], "payload": sorted_kp[1],
            "cumsum": _spmd(lambda a: dist_cumsum(a, d), mesh, w,
                            out_specs=P(None, "points")),
            "emd1d": _spmd(lambda a, b: dist_emd1d(a, b, d, p=2), mesh, u, v,
                           out_specs=P(None)),
            "circle": _spmd(lambda a, b: dist_emd1d_circle(a, b, d), mesh, cu, cv,
                            out_specs=P(None))}


@pytest.mark.parametrize("world", [2, 4])
def test_dist_ops_match_jax(world, tmp_path):
    """dist_sort (exact, and the payload follows its keys), dist_cumsum,
    dist_emd1d and dist_emd1d_circle on every rank against the JAX functions
    on as many devices: rtol 1e-5 (the prefix sum atol 2e-6, as the JAX
    test against numpy; the circle atol 1e-7 near zero)."""
    arrays = _inputs()
    want = _jax_side(world, *arrays)
    x, keys = arrays[0], arrays[1]
    for r in torch_dist.spawn(torch_dist.dist_sort_ops, world, tmp_path, *arrays):
        np.testing.assert_array_equal(r["sort"], want["sort"])
        np.testing.assert_array_equal(r["sort"], np.sort(x, axis=-1))
        np.testing.assert_array_equal(r["keys"], np.sort(keys, axis=-1))
        np.testing.assert_array_equal(r["payload"], -2.0 * r["keys"])
        np.testing.assert_array_equal(r["payload"], want["payload"])
        np.testing.assert_allclose(r["cumsum"], want["cumsum"], rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(r["emd1d"], want["emd1d"], rtol=1e-5)
        np.testing.assert_allclose(r["circle"], want["circle"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world,points", [(2, 2), (4, 2), (4, 4)])
def test_dist_ssw_matches_jax_and_one_process_gradient(world, points, tmp_path):
    """make_dist_ssw on a (data, points) mesh: its value against the JAX
    package's on the same mesh shape (rtol 1e-5), and its gradient (the
    ranks' mean) against the gradient of the one-process port SSW_1
    (rtol 1e-5, atol 1e-7), finite and nonzero."""
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (4, 64, 3))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    y = jnp.roll(x, 1, axis=1) + 0.05
    frames = stiefel_frames(jax.random.PRNGKey(1), 6)
    x, y, frames = (np.array(a, np.float32) for a in (x, y, frames))

    data = world // points
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]).reshape(data, points),
                              ("data", "points"))
    sh = NamedSharding(jmesh, P("data", "points"))
    want = float(jax.jit(make_dist_ssw(jmesh))(
        jax.device_put(jnp.asarray(x), sh), jax.device_put(jnp.asarray(y), sh),
        jax.device_put(jnp.asarray(frames), NamedSharding(jmesh, P()))))

    xt = torch.from_numpy(x).requires_grad_(True)
    one = torch.mean(t_sliced(xt, torch.from_numpy(y), torch.from_numpy(frames), p=1))
    (g_one,) = torch.autograd.grad(one, xt)
    for r in torch_dist.spawn(torch_dist.dist_ssw, world, tmp_path, points, x, y, frames):
        np.testing.assert_allclose(r["value"], want, rtol=1e-5)
        np.testing.assert_allclose(r["value"], float(one.detach()), rtol=1e-5)
        assert np.isfinite(r["grad"]).all() and np.abs(r["grad"]).max() > 0
        np.testing.assert_allclose(r["grad"], g_one.numpy(), rtol=1e-5, atol=1e-7)
