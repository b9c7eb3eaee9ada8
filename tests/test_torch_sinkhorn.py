"""Port parity: Sinkhorn and the warm-up kernel's plain version vs shwd_tpu.

The JAX warm-up runs as its own tests run it here: the Pallas kernel in
interpret mode. The CUDA kernel itself is held against the plain version
on the card in test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.ops import sinkhorn as ts
from shwd_torch.ops import sinkhorn_kernels as tk
from shwd_tpu.ops import sinkhorn as js
from shwd_tpu.ops.sinkhorn_pallas import emd2_warmup_pallas, warmup_supported


def _cost(rng, b, n, m):
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    y = rng.normal(size=(b, m, 3)).astype(np.float32)
    return np.sum((x[:, :, None, :] - y[:, None, :, :]) ** 2, -1).astype(np.float32)


def test_emd2_approx_matches_jax():
    """(val, f, g) on a batch (batch-global eps0 on both sides): val rtol
    1e-3, f/g atol 1e-4 (f32 log-sum-exp in another summation order)."""
    c = _cost(np.random.default_rng(3), 3, 32, 28)
    v1, f1, g1 = js.emd2_approx(jnp.asarray(c), eps=1e-3, num_iters=30,
                                num_scales=4, return_potentials=True)
    v2, f2, g2 = ts.emd2_approx(torch.from_numpy(c), eps=1e-3, num_iters=30,
                                num_scales=4, return_potentials=True)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v1), rtol=1e-3)
    np.testing.assert_allclose(f2.numpy(), np.asarray(f1), atol=1e-4)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g1), atol=1e-4)


def test_sinkhorn_log_matches_jax():
    """Single-temperature Sinkhorn (val rtol 1e-4, f/g atol 1e-5)."""
    c = _cost(np.random.default_rng(4), 2, 20, 20)
    v1, f1, g1 = js.sinkhorn_log(jnp.asarray(c), eps=0.05, num_iters=50)
    v2, f2, g2 = ts.sinkhorn_log(torch.from_numpy(c), eps=0.05, num_iters=50)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v1), rtol=1e-4)
    np.testing.assert_allclose(f2.numpy(), np.asarray(f1), atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g1), atol=1e-5)


def test_emd2_approx_plan_is_detached():
    """The gradient wrt the cost is the (constant) plan: d<P,C>/dC = P."""
    c = torch.from_numpy(_cost(np.random.default_rng(5), 1, 12, 12))
    c.requires_grad_(True)
    ts.emd2_approx(c, eps=1e-2).sum().backward()
    grad = c.grad[0]
    np.testing.assert_allclose(grad.sum(-1).numpy(), 1 / 12, rtol=2e-2)


@pytest.mark.parametrize("shape", [(1, 40, 40), (2, 24, 40), (1, 48, 33)])
def test_warmup_reference_matches_pallas(shape):
    """Plain K1 vs the Pallas warm-up (interpret mode), eps 1e-3, 30 x 4,
    per-item eps0: val rtol 1e-3, f/g atol 1e-4 (the tolerances the JAX
    package holds its kernel to)."""
    c = _cost(np.random.default_rng(6), *shape)
    v1, f1, g1 = emd2_warmup_pallas(jnp.asarray(c), eps=1e-3, num_iters=30,
                                    num_scales=4, interpret=True)
    v2, f2, g2 = tk.emd2_warmup_reference(torch.from_numpy(c), eps=1e-3,
                                          num_iters=30, num_scales=4)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v1), rtol=1e-3)
    np.testing.assert_allclose(f2.numpy(), np.asarray(f1), atol=1e-4)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g1), atol=1e-4)


def test_warmup_wrapper_on_cpu_is_the_reference():
    c = torch.from_numpy(_cost(np.random.default_rng(7), 2, 16, 16))
    before = tk.emd2_warmup.launches
    got = tk.emd2_warmup(c, eps=1e-3, num_iters=5, num_scales=3)
    want = tk.emd2_warmup_reference(c, eps=1e-3, num_iters=5, num_scales=3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tk.emd2_warmup.launches == before      # no kernel on the CPU


@pytest.mark.parametrize("n,m", [(1200, 1200), (512, 512), (2048, 2048),
                                 (64, 4000), (3000, 1000)])
def test_warmup_supported_matches_jax(n, m):
    assert tk.warmup_supported(n, m) == warmup_supported(n, m)
