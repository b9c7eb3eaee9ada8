"""Port parity: 1-D optimal transport on the line and on the circle vs
shwd_tpu.ops.ot1d, and against exact solvers.

Inputs are numpy draws from a seed. Values are held at rtol 1e-5 / atol
1e-6, gradients against ``jax.grad`` at rtol 1e-4 / atol 1e-6.

The unequal-size bisection (``circle_ot`` with n != m) is held against the
JAX function run op by op (``jax.disable_jit``): compiled by XLA on the
CPU, the JAX function returns on some inputs a value below the exact
minimum (ROADMAP Queue 3); ``test_circle_ot_unequal_sizes_is_exact`` holds
the port to the exact solver on such an input.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from shwd_torch.ops import ot1d as T
from shwd_torch.ops.emd_exact import emd2_exact
from shwd_tpu.ops import ot1d as J

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _draw(shape_u, shape_v, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape_u).astype(np.float32),
            rng.uniform(size=shape_v).astype(np.float32))


def _both(jfn, tfn, u, v, eager=False):
    """Value and gradient (wrt u and v of the sum) of both packages."""
    def jv(a, b):
        return jnp.sum(jfn(a, b))
    ju, jv_ = jnp.asarray(u), jnp.asarray(v)
    if eager:
        with jax.disable_jit():
            jval = np.asarray(jfn(ju, jv_))
            jgu, jgv = jax.grad(jv, argnums=(0, 1))(ju, jv_)
    else:
        jval = np.asarray(jfn(ju, jv_))
        jgu, jgv = jax.grad(jv, argnums=(0, 1))(ju, jv_)
    tu = torch.from_numpy(u).requires_grad_(True)
    tv = torch.from_numpy(v).requires_grad_(True)
    tval = tfn(tu, tv)
    tval.sum().backward()
    return (jval, np.asarray(jgu), np.asarray(jgv)), (tval.detach().numpy(),
                                                       tu.grad.numpy(), tv.grad.numpy())


def _check(jside, tside):
    np.testing.assert_allclose(tside[0], jside[0], **VAL)
    np.testing.assert_allclose(tside[1], jside[1], **GRAD)
    np.testing.assert_allclose(tside[2], jside[2], **GRAD)


@pytest.mark.parametrize("n,m,p", [(32, 32, 2), (32, 32, 1), (16, 24, 2), (16, 24, 3)])
def test_emd1d_matches_jax(n, m, p):
    """emd1d (equal sizes) and its dispatch to emd1d_general (unequal)."""
    u, v = _draw((3, 5, n), (3, 5, m), seed=n + m + p)
    u, v = 2 * u - 1, 3 * v - 1
    _check(*_both(lambda a, b: J.emd1d(a, b, p=p), lambda a, b: T.emd1d(a, b, p=p), u, v))


def test_emd1d_general_equal_sizes_is_emd1d():
    u, v = _draw((4, 20), (4, 20), seed=3)
    np.testing.assert_allclose(
        T.emd1d_general(torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        T.emd1d(torch.from_numpy(u), torch.from_numpy(v)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("n,m", [(24, 24), (16, 23), (40, 9)])
def test_emd1d_circle_matches_jax(n, m):
    u, v = _draw((2, 3, n), (2, 3, m), seed=n * m)
    _check(*_both(J.emd1d_circle, T.emd1d_circle, u, v))


@pytest.mark.parametrize("n,m,p", [(32, 32, 2.0), (128, 128, 2.0), (16, 16, 1.5),
                                   (16, 16, 3.0), (20, 20, 2.5)])
def test_circle_ot_equal_sizes_matches_jax(n, m, p):
    """The p == 2 DFT branch (exact vertex minimum; near-ties may pick
    other windows of the same cost, so values and gradients are compared,
    never the windows) and the contiguous-roll bisection for other p."""
    u, v = _draw((3, 4, n), (3, 4, m), seed=int(n * p))
    _check(*_both(lambda a, b: J.circle_ot(a, b, p=p),
                  lambda a, b: T.circle_ot(a, b, p=p), u, v))


@pytest.mark.parametrize("n,m,p", [(16, 20, 2.0), (24, 17, 3.0), (12, 30, 1.5)])
def test_circle_ot_unequal_sizes_matches_jax(n, m, p):
    """The general bisection against the JAX function run op by op."""
    u, v = _draw((2, 3, n), (2, 3, m), seed=n + m)
    _check(*_both(lambda a, b: J.circle_ot(a, b, p=p),
                  lambda a, b: T.circle_ot(a, b, p=p), u, v, eager=True))


def _circle_cost(u, v, p):
    d = np.abs(np.float64(u)[:, None] - np.float64(v)[None, :])
    return np.minimum(d, 1.0 - d) ** p


def test_circle_ot_unequal_sizes_is_exact():
    """On this input XLA's compiled JAX function returns 7.6420e-3 for
    item (1, 0), 3.7 % below the exact minimum 7.9346e-3; the port (and
    the JAX function run op by op) give the exact value."""
    rng = np.random.default_rng(0)
    rng.uniform(size=(3, 5, 16))
    rng.uniform(size=(3, 5, 16))
    u = rng.uniform(size=(3, 5, 16)).astype(np.float32)
    v = rng.uniform(size=(3, 5, 20)).astype(np.float32)
    got = T.circle_ot(torch.from_numpy(u), torch.from_numpy(v), p=2).numpy()
    want = np.array([[emd2_exact(_circle_cost(u[i, j], v[i, j], 2)) for j in range(5)]
                     for i in range(3)])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got[1, 0], 7.9346e-3, rtol=1e-4)


@pytest.mark.parametrize("n,p", [(5, 1.0), (6, 2.0), (7, 1.5), (8, 3.0)])
def test_circle_ot_equal_sizes_brute_force(n, p):
    """Against the best of all n! assignments on the circular cost
    (n <= 8), several problems per size."""
    u, v = _draw((6, n), (6, n), seed=100 + n)
    t = (T.emd1d_circle if p == 1 else lambda a, b: T.circle_ot(a, b, p=p))(
        torch.from_numpy(u), torch.from_numpy(v)).numpy()
    for k in range(6):
        c = _circle_cost(u[k], v[k], p)
        best = min(c[np.arange(n), list(perm)].mean()
                   for perm in itertools.permutations(range(n)))
        r, s = linear_sum_assignment(c)
        assert abs(best - c[r, s].mean()) < 1e-12
        np.testing.assert_allclose(t[k], best, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n,m,p", [(5, 7, 1.0), (8, 6, 2.0), (4, 7, 3.0)])
def test_circle_ot_unequal_sizes_brute_force(n, m, p):
    """Unequal sizes against the exact transport on the circular cost
    (the network simplex, uniform weights)."""
    u, v = _draw((5, n), (5, m), seed=200 + n * m)
    t = (T.emd1d_circle if p == 1 else lambda a, b: T.circle_ot(a, b, p=p))(
        torch.from_numpy(u), torch.from_numpy(v)).numpy()
    want = [emd2_exact(_circle_cost(u[k], v[k], p)) for k in range(5)]
    np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-7)


def test_circle_ot_batched_rows_match_single_solves():
    u, v = _draw((4, 7, 20), (4, 7, 20), seed=9)
    out = T.circle_ot(torch.from_numpy(u), torch.from_numpy(v), p=3.0).numpy()
    single = T.circle_ot(torch.from_numpy(u[1, 3])[None], torch.from_numpy(v[1, 3])[None],
                         p=3.0).numpy()
    np.testing.assert_allclose(out[1, 3], single[0], rtol=1e-6)


def test_batched_searchsorted_matches_numpy():
    rng = np.random.default_rng(4)
    a = np.sort(rng.integers(0, 10, size=(3, 12)), -1).astype(np.float32)
    q = rng.integers(-1, 11, size=(3, 9)).astype(np.float32)
    for side in ("left", "right"):
        got = T.batched_searchsorted(torch.from_numpy(a), torch.from_numpy(q), side).numpy()
        want = np.stack([np.searchsorted(a[i], q[i], side=side) for i in range(3)])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(J.batched_searchsorted(jnp.asarray(a), jnp.asarray(q), side)))


def test_circle_ot_values_lie_in_range_and_are_rotation_invariant():
    """W_p^p on the circle is at most (1/2)^p, and turning both clouds by
    the same angle changes nothing."""
    u, v = _draw((8, 32), (8, 32), seed=12)
    base = T.circle_ot(torch.from_numpy(u), torch.from_numpy(v), p=2).numpy()
    turned = T.circle_ot(torch.from_numpy((u + 0.3) % 1), torch.from_numpy((v + 0.3) % 1),
                         p=2).numpy()
    assert (base >= 0).all() and (base <= 0.25).all()
    np.testing.assert_allclose(turned, base, rtol=1e-4, atol=1e-6)


def test_circle_ot_p2_is_exact_at_the_1024_point_width():
    """The p = 2 branch at the N=1024 registration width on the angles of
    nearby clouds on S^2 (one item, ten frames): the exact assignment on
    the circular cost at rtol 1e-6. Its alignment scan runs in f64; in f32
    its O(n) terms round by ~1e-4, and here two of the ten slices took a
    window 0.1-1.4 % above the minimum."""
    from shwd_torch.ops.spherical import project_to_circle, stiefel_frames
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 1024, 3, generator=g)
    y = x + 0.2 * torch.randn(2, 1024, 3, generator=g)
    frames = stiefel_frames(torch.Generator().manual_seed(4), 10, 3)
    u, v = (project_to_circle(t[1] / t[1].norm(dim=-1, keepdim=True), frames)
            for t in (x, y))
    got = T.circle_ot(u, v, p=2).numpy()
    for k in range(10):
        c = _circle_cost(u[k].numpy(), v[k].numpy(), 2)
        r, s = linear_sum_assignment(c)
        np.testing.assert_allclose(got[k], c[r, s].mean(), rtol=1e-6)
