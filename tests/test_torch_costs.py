"""Port parity: cost matrices of shwd_torch vs shwd_tpu on the same inputs."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.ops import sphere_sampling as tss
from shwd_torch.ops.costs import cost_matrix as t_cost
from shwd_tpu.ops.costs import cost_matrix as j_cost


@pytest.mark.parametrize("kind,p", [("lp", 2.0), ("lp", 1.0), ("cosine", 1.0),
                                    ("cosine", 2.0), ("geodesic", 1.0),
                                    ("sqeuclidean", 2.0)])
def test_cost_matrix_matches_jax(kind, p):
    """All cost kinds, f32: atol 1e-6 (same formulas, f32 rounding; values
    stay below ~4, where 1e-6 is a few ulp)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 17, 3)).astype(np.float32)
    y = rng.normal(size=(2, 23, 3)).astype(np.float32)
    want = np.asarray(j_cost(jnp.asarray(x), jnp.asarray(y), kind, p))
    got = t_cost(torch.from_numpy(x), torch.from_numpy(y), kind, p).numpy()
    assert got.shape == (2, 17, 23)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_lp2_large_dim_uses_expansion():
    """D > 8 takes the matmul expansion; still matches JAX (f32, atol 1e-5
    on O(10) values: the expansion cancels, as in JAX)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 9, 12)).astype(np.float32)
    y = rng.normal(size=(1, 11, 12)).astype(np.float32)
    want = np.asarray(j_cost(jnp.asarray(x), jnp.asarray(y), "lp", 2.0))
    got = t_cost(torch.from_numpy(x), torch.from_numpy(y), "lp", 2.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_unknown_cost_kind_raises():
    with pytest.raises(ValueError):
        t_cost(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3), "nope")


def test_cube_sampler_on_surface():
    """Every point lies on a face: one coordinate is +-side/2, the others
    inside; the biased sampler skews toward a corner (Beta(2, 5) mean)."""
    rng = np.random.default_rng(0)
    for biased in (False, True):
        pts = tss.sample_cube_surface(rng, 600, biased=biased).numpy()
        assert pts.shape == (600, 3) and pts.dtype == np.float32
        on_face = np.isclose(np.abs(pts), 0.5).sum(-1) >= 1
        assert on_face.all()
        assert (np.abs(pts) <= 0.5 + 1e-6).all()
    free = pts[~np.isclose(np.abs(pts), 0.5)]
    np.testing.assert_allclose(free.mean(), 2 / 7 - 0.5, atol=0.03)


def test_sphere_and_ellipsoid_samplers():
    g = torch.Generator().manual_seed(0)
    s = tss.sample_sphere_surface(g, 200, radius=2.0)
    np.testing.assert_allclose(torch.linalg.vector_norm(s, dim=-1).numpy(), 2.0,
                               rtol=1e-5)
    e = tss.sample_ellipsoid_surface(g, 200, semi_axes=(2.0, 1.0, 1.0))
    q = (e[:, 0] / 2) ** 2 + e[:, 1] ** 2 + e[:, 2] ** 2
    np.testing.assert_allclose(q.numpy(), 1.0, rtol=1e-5)
