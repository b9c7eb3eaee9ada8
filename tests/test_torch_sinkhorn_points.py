"""Port parity: the fused point-cloud Sinkhorn vs shwd_tpu.ops.sinkhorn_pallas.

The JAX kernel runs as its own tests run it here: the Pallas kernel in
interpret mode. The port side is the CUDA kernel's plain version (what the
wrapper runs for CPU tensors); the kernel itself is held against it on the
card in test_torch_kernels_gpu.py.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.ops import sinkhorn_fused as tf
from shwd_tpu.ops import sinkhorn_pallas as jp

KW = dict(eps=5e-3, num_iters=30, num_scales=4)


def _clouds(b, n, m, seed, sphere=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    y = rng.normal(size=(b, m, 3)).astype(np.float32)
    if sphere:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        y /= np.linalg.norm(y, axis=-1, keepdims=True)
    return x, y


@pytest.mark.parametrize("kind,p,shape", [
    ("lp", 2.0, (3, 40, 28)),          # odd batch, N != M
    ("lp", 2.0, (2, 24, 24)),
    ("cosine", 2.0, (3, 32, 20)),
    ("cosine", 1.0, (1, 20, 36)),
    ("geodesic", 2.0, (3, 28, 40)),
    ("geodesic", 1.0, (2, 16, 16)),
])
def test_plain_version_matches_pallas_interpret(kind, p, shape):
    """(val, f, g) of _fused_forward(interpret=True): val rtol 1e-3, f/g
    atol 1e-4 (f32 log-sum-exp in another summation order, over 120
    dependent iterations; the cosine product is an f32 dot on both sides)."""
    x, y = _clouds(*shape, seed=41, sphere=kind != "lp")
    v1, f1, g1 = jp._fused_forward(jnp.asarray(x), jnp.asarray(y), kind, p,
                                   interpret=True, **KW)
    v2, f2, g2 = tf.sinkhorn_points_reference(torch.from_numpy(x),
                                              torch.from_numpy(y), kind, p, **KW)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v1), rtol=1e-3)
    np.testing.assert_allclose(f2.numpy(), np.asarray(f1), atol=1e-4)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g1), atol=1e-4)


def test_single_scale_keeps_the_jax_behaviour():
    """num_scales=1: the only temperature is eps0 while the plan is formed
    with eps; both sides do the same (tolerances as above)."""
    x, y = _clouds(2, 20, 24, seed=42)
    kw = dict(eps=5e-2, num_iters=20, num_scales=1)
    v1, f1, _ = jp._fused_forward(jnp.asarray(x), jnp.asarray(y), "lp", 2.0,
                                  interpret=True, **kw)
    v2, f2, _ = tf.sinkhorn_points_reference(torch.from_numpy(x),
                                             torch.from_numpy(y), "lp", 2.0, **kw)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v1), rtol=1e-3)
    np.testing.assert_allclose(f2.numpy(), np.asarray(f1), atol=1e-4)


@pytest.mark.parametrize("kind,p", [("lp", 2.0), ("cosine", 2.0), ("geodesic", 1.0)])
def test_sinkhorn_points_value_and_gradient_match_jax(kind, p):
    """sinkhorn_points(..., interpret=True) against the port's
    autograd.Function on CPU tensors: value rtol 1e-3; the envelope
    gradient wrt x and y rtol 5e-3 / atol 2e-5 (the plan is
    exp((f + g - C) / eps): dual differences of ~1e-5 between the two f32
    solves become ~2e-3 relative in the plan at eps = 5e-3)."""
    x, y = _clouds(3, 24, 20, seed=43, sphere=kind != "lp")
    w = np.arange(1.0, 4.0, dtype=np.float32)

    def jloss(xx, yy):
        return jnp.sum(jp.sinkhorn_points(xx, yy, kind, p, KW["eps"],
                                          KW["num_iters"], KW["num_scales"],
                                          True) * w)

    jval, (jgx, jgy) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    tval = (tf.sinkhorn_points(xt, yt, kind, p, **KW) * torch.from_numpy(w)).sum()
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-3)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=5e-3, atol=2e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgy), rtol=5e-3, atol=2e-5)


def test_gradient_only_for_the_inputs_that_ask():
    x, y = (torch.from_numpy(a) for a in _clouds(2, 12, 12, seed=44))
    xt = x.clone().requires_grad_(True)
    tf.sinkhorn_points(xt, y, **KW).sum().backward()
    assert xt.grad is not None and y.grad is None


@pytest.mark.parametrize("kind,p", [("lp", 2.0), ("lp", 1.0), ("cosine", 2.0)])
def test_cpu_default_route_matches_emd2_points(kind, p):
    """use_kernel=None on a CPU tensor is the cost_matrix + emd2_approx
    route (batch-global eps0), as emd2_points picks off the TPU: value
    rtol 1e-3, gradient rtol 5e-3 / atol 2e-5 (as above)."""
    x, y = _clouds(3, 24, 24, seed=45)
    jval, jgx = jax.value_and_grad(
        lambda xx: jnp.sum(jp.emd2_points(xx, jnp.asarray(y), kind, p, **KW)))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tval = tf.emd2_points(xt, torch.from_numpy(y), kind, p, **KW).sum()
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-3)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=5e-3, atol=2e-5)


def test_forced_kernel_route_on_cpu_differs_from_default_by_the_eps0_rule():
    """use_kernel=True on a CPU tensor runs the kernel's plain version
    (per-item eps0, rescaled potentials) and counts no launch; both routes
    approximate the same EMD (rtol 2e-2 between them at this depth)."""
    x, y = (torch.from_numpy(a) for a in _clouds(3, 24, 24, seed=46))
    before = tf.sinkhorn_points.launches
    a = tf.emd2_points(x, y, use_kernel=True, **KW)
    b = tf.emd2_points(x, y, use_kernel=False, **KW)
    assert tf.sinkhorn_points.launches == before
    want, _, _ = tf.sinkhorn_points_reference(x, y, **KW)
    assert torch.equal(a, want)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2)


def test_fused_supported_matches_jax_on_a_grid():
    for kind in ("lp", "sqeuclidean", "cosine", "geodesic", "manhattan"):
        for p in (1.0, 2.0, 3.0):
            for n in (1, 100, 128, 129, 512, 640, 641, 1200):
                for m in (64, 128, 640, 768, 1024):
                    assert (tf.fused_supported(n, m, kind, p)
                            == jp.fused_supported(n, m, kind, p)), (kind, p, n, m)


def test_unsupported_cost_raises():
    x, y = (torch.from_numpy(a) for a in _clouds(1, 8, 8, seed=47))
    with pytest.raises(ValueError):
        tf.sinkhorn_points(x, y, "lp", 1.0)
    with pytest.raises(ValueError):
        tf.sinkhorn_points_reference(x, y, "manhattan", 2.0)


@pytest.mark.parametrize("n,m,want", [
    (128, 128, "registers"),      # the trainer's train and eval batches
    (100, 120, "registers"),
    (7, 9, "registers"),
    (1, 128, "registers"),
    (128, 1, "registers"),
    (100, 130, "general"),
    (129, 100, "general"),
    (129, 129, "general"),
    (640, 640, "general"),        # the JAX gate's edge
    (40, 600, "general"),
])
def test_pick_route(n, m, want):
    """Tiles up to 128 x 128 take the register route, larger tiles the
    general one."""
    assert tf.pick_route(n, m) == want


def test_cpu_wrapper_ignores_the_route():
    """On CPU tensors the wrapper runs the plain version whatever route is
    asked for, and counts no launch."""
    x, y = (torch.from_numpy(a) for a in _clouds(2, 16, 20, seed=48))
    before = tf.sinkhorn_points.launches
    got = tf._fused_forward(x, y, "lp", 2.0, route="general", **KW)
    want = tf.sinkhorn_points_reference(x, y, "lp", 2.0, **KW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tf.sinkhorn_points.launches == before
