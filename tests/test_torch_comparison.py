"""The metric sweeps in the port: the behaviour ``tests/test_comparison.py``
asks of the JAX package, and parity with it on the JAX package's own
transformed clouds (handed in as ``sources``): Chamfer and the Sinkhorn
value at rtol 1e-5, the near-exact W (300 annealed iterations in f32) at
rtol 1e-4. About 15 s on one worker.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import numpy as np
import pytest

from shwd_torch.data.synthetic import shape_bank
from shwd_torch.train.comparison import (
    gaussian_kl_vs_w2, rotation_sweep, translation_sweep,
)
from shwd_tpu.data.transforms import TransformConfig, make_registration_batch
from shwd_tpu.train import comparison as jc


@pytest.fixture(scope="module")
def clouds():
    return shape_bank(12, 64, seed=0, kinds=("composite",))


def test_rotation_sweep_wd_monotone_and_more_sensitive(clouds):
    r = rotation_sweep(clouds, np.arange(0.0, 91.0, 15.0), device="cpu")
    assert np.isfinite(r.chamfer).all() and np.isfinite(r.wasserstein).all()
    assert (np.diff(r.wasserstein) > 0).all()
    assert r.wasserstein[1] > 3.0 * r.chamfer[1]
    assert r.wasserstein[1] / r.wasserstein[-1] > r.chamfer[1] / r.chamfer[-1]


def test_translation_sweep_wd_linear_cd_lags(clouds):
    mags = np.arange(0.0, 1.01, 0.25)
    t = translation_sweep(clouds, mags, device="cpu")
    np.testing.assert_allclose(t.wasserstein[1:], mags[1:], rtol=0.1)
    assert (t.chamfer[1:3] < 0.6 * t.wasserstein[1:3]).all()
    assert (np.diff(t.wasserstein) > 0).all()
    assert (np.diff(t.chamfer) > 0).all()
    assert np.isfinite(t.sinkhorn).all() and t.sinkhorn[-1] > t.sinkhorn[0]


def test_gaussian_kl_vs_w2_closed_form():
    sigma = np.array([1.0, 0.5, 0.25])
    mags = np.linspace(0.0, 2.0, 9)
    t = np.stack([mags, np.zeros_like(mags), np.zeros_like(mags)], -1)
    kl, w2 = gaussian_kl_vs_w2(sigma, t)
    np.testing.assert_allclose(w2, mags)
    np.testing.assert_allclose(kl, 0.5 * mags ** 2)
    np.testing.assert_array_equal(kl, jc.gaussian_kl_vs_w2(sigma, t)[0])


def _jax_sources(clouds, grid, mode, seed=0):
    """The transformed clouds the JAX package's _sweep draws, per grid point."""
    target = jax.numpy.asarray(clouds)
    key, out = jax.random.PRNGKey(seed), []
    for g in grid:
        if mode == "rotation":
            cfg = TransformConfig(angle_range_deg=float(g), translation_range=1e-12,
                                  noise_sigma=0.0, rotation_axes="x", fixed_angle=True)
        else:
            cfg = TransformConfig(angle_range_deg=1e-9,
                                  translation_range=float(g) ** 2 + 1e-12, noise_sigma=0.0)
        key, k = jax.random.split(key)
        out.append(np.asarray(make_registration_batch(k, target, target, cfg).source))
    return out


@pytest.mark.parametrize("mode", ["rotation", "translation"])
def test_sweep_values_match_jax(clouds, mode):
    grid = np.array([0.0, 20.0, 60.0]) if mode == "rotation" else np.array([0.0, 0.3, 0.9])
    jfn, tfn = ((jc.rotation_sweep, rotation_sweep) if mode == "rotation"
                else (jc.translation_sweep, translation_sweep))
    want = jfn(clouds, grid)
    got = tfn(clouds, grid, device="cpu", sources=_jax_sources(clouds, grid, mode))
    np.testing.assert_array_equal(got.grid, want.grid)
    np.testing.assert_allclose(got.chamfer, want.chamfer, rtol=1e-5)
    np.testing.assert_allclose(got.sinkhorn, want.sinkhorn, rtol=1e-5)
    np.testing.assert_allclose(got.wasserstein, want.wasserstein, rtol=1e-4)
