"""Port parity: the exact EMD oracle vs shwd_tpu.ops.emd_exact."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import shutil

import numpy as np
import pytest

from shwd_torch.ops import emd_exact as te
from shwd_tpu.ops import emd_exact as je


def test_w2_exact_matches_jax_package():
    """n == m goes through scipy's assignment on both sides (rtol 1e-12)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3))
    y = rng.normal(size=(50, 3)) + 0.3
    np.testing.assert_allclose(te.w2_exact(x, y), je.w2_exact(x, y), rtol=1e-12)


@pytest.mark.parametrize("n,m", [(12, 17), (30, 21)])
def test_emd2_exact_unequal_sizes_matches(n, m):
    """n != m: the port's own build of the network simplex vs the JAX
    package's (the same source; rtol 1e-9), plan marginals exact."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the network simplex")
    rng = np.random.default_rng(n)
    c = rng.random((n, m))
    v, plan = te.emd2_exact(c, return_plan=True)
    np.testing.assert_allclose(v, je.emd2_exact(c), rtol=1e-9)
    np.testing.assert_allclose(plan.sum(1), 1 / n, atol=1e-9)
    np.testing.assert_allclose(plan.sum(0), 1 / m, atol=1e-9)
    np.testing.assert_allclose((plan * c).sum(), v, rtol=1e-9)


def test_emd2_exact_batch():
    rng = np.random.default_rng(3)
    c = rng.random((3, 10, 10))
    np.testing.assert_allclose(te.emd2_exact_batch(c), je.emd2_exact_batch(c),
                               rtol=1e-12)
