"""Port parity: spherical sliced-Wasserstein (projections, sliced costs, the
``ssw`` and ``exact`` transport solvers) vs shwd_tpu.

Frames are made in numpy (QR of Gaussians) and handed to both packages;
the port's own ``stiefel_frames`` is checked for orthonormality and its
law's invariants.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.losses.transport import TransportConfig as TTransport
from shwd_torch.losses.transport import make_transport as t_make
from shwd_torch.ops import spherical as T
import shwd_tpu.losses.transport as jt_mod
from shwd_tpu.losses.transport import TransportConfig as JTransport
from shwd_tpu.losses.transport import make_transport as j_make
from shwd_tpu.ops import spherical as J


def _frames(L, seed, batch=()):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(*batch, L, 3, 2)))
    return q.astype(np.float32)


def _sphere(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def test_project_to_circle_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 3)).astype(np.float32)
    f = _frames(7, 1)
    got = T.project_to_circle(torch.from_numpy(x), torch.from_numpy(f)).numpy()
    want = np.asarray(J.project_to_circle(jnp.asarray(x), jnp.asarray(f)))
    assert got.shape == (2, 7, 40)
    assert (got >= 0).all() and (got < 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m,p", [(32, 32, 2.0), (32, 32, 1.0), (24, 24, 3.0),
                                   (20, 28, 1.0)])
def test_sliced_cost_sphere_matches_jax(n, m, p):
    """Value and gradient wrt both clouds (rtol 1e-5 / 1e-4)."""
    x, y = _sphere(3, n, 2), _sphere(3, m, 3)
    f = _frames(16, 4)

    def jf(a, b):
        return jnp.sum(J.sliced_cost_sphere(a, b, jnp.asarray(f), p=p))
    jval = np.asarray(J.sliced_cost_sphere(jnp.asarray(x), jnp.asarray(y), jnp.asarray(f), p=p))
    jgx, jgy = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    tval = T.sliced_cost_sphere(tx, ty, torch.from_numpy(f), p=p)
    tval.sum().backward()
    np.testing.assert_allclose(tval.detach().numpy(), jval, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), rtol=1e-4, atol=1e-6)


def test_stiefel_frames_are_orthonormal_and_seeded():
    g = torch.Generator().manual_seed(5)
    f = T.stiefel_frames(g, 500, 3, batch_shape=(2,))
    assert f.shape == (2, 500, 3, 2)
    gram = f.transpose(-1, -2) @ f
    np.testing.assert_allclose(gram.numpy(), np.broadcast_to(np.eye(2), gram.shape),
                               atol=1e-6)
    again = T.stiefel_frames(torch.Generator().manual_seed(5), 500, 3, batch_shape=(2,))
    assert torch.equal(f, again)
    # the law is uniform: each column's mean is ~0 and E[q q^T] = I/3
    cols = f.reshape(-1, 3, 2).permute(0, 2, 1).reshape(-1, 3).numpy()
    assert np.abs(cols.mean(0)).max() < 0.05
    np.testing.assert_allclose(cols.T @ cols / len(cols), np.eye(3) / 3, atol=0.03)


def test_frame_column_signs_do_not_change_the_value():
    """Sign flips of a frame's columns reflect or turn the circle for both
    clouds alike: the sliced cost is unchanged."""
    x, y = _sphere(2, 24, 6), _sphere(2, 24, 7)
    f = _frames(9, 8)
    flipped = f * np.array([-1.0, 1.0], np.float32)
    both = f * np.array([-1.0, -1.0], np.float32)
    for p in (1.0, 2.0, 3.0):
        base = T.sliced_cost_sphere(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(f), p=p)
        for g in (flipped, both):
            other = T.sliced_cost_sphere(torch.from_numpy(x), torch.from_numpy(y),
                                         torch.from_numpy(g), p=p)
            np.testing.assert_allclose(other.numpy(), base.numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("p,reduce", [(2.0, "mean"), (1.0, "sum"), (3.0, "none")])
def test_ssw_transport_matches_jax_with_the_same_frames(monkeypatch, p, reduce):
    """The transport's 'ssw' solver, frames handed to both: the JAX side's
    frames replaced by patching its ``stiefel_frames``."""
    x, y = _sphere(4, 32, 10), _sphere(4, 32, 11)
    f = _frames(20, 12)
    kw = dict(cost="geodesic", p=p, solver="ssw", num_projections=20, reduce=reduce)
    monkeypatch.setattr(jt_mod, "stiefel_frames", lambda key, L, d: jnp.asarray(f))
    jw = j_make(JTransport(**kw))
    jval = np.asarray(jw(jnp.asarray(x), jnp.asarray(y)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jw(a, jnp.asarray(y))))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tval = t_make(TTransport(**kw))(tx, torch.from_numpy(y), frames=torch.from_numpy(f))
    tval.sum().backward()
    np.testing.assert_allclose(tval.detach().numpy(), jval, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jgrad, rtol=1e-4, atol=1e-6)


def test_ssw_transport_frames_come_from_the_generator():
    """No generator: the same frames every call (a generator seeded 0, as
    the JAX package's key=None); a generator: fresh frames per call."""
    x, y = _sphere(2, 16, 20), _sphere(2, 16, 21)
    w = t_make(TTransport(solver="ssw", num_projections=8))
    a, b = w(torch.from_numpy(x), torch.from_numpy(y)), w(torch.from_numpy(x),
                                                          torch.from_numpy(y))
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    c, d = w(torch.from_numpy(x), torch.from_numpy(y), g), w(torch.from_numpy(x),
                                                             torch.from_numpy(y), g)
    assert torch.equal(c, a) and not torch.equal(c, d)


def test_sliced_wasserstein_sphere_per_batch_frames():
    x, y = _sphere(3, 16, 22), _sphere(3, 16, 23)
    g = torch.Generator().manual_seed(1)
    shared = T.sliced_wasserstein_sphere(g, torch.from_numpy(x), torch.from_numpy(y), 30)
    g = torch.Generator().manual_seed(1)
    frames = T.stiefel_frames(g, 30, 3)
    want = T.sliced_cost_sphere(torch.from_numpy(x), torch.from_numpy(y), frames).mean()
    assert torch.equal(shared, want)
    g = torch.Generator().manual_seed(1)
    per = T.sliced_wasserstein_sphere(g, torch.from_numpy(x), torch.from_numpy(y), 30,
                                      per_batch_frames=True)
    g = torch.Generator().manual_seed(1)
    frames = T.stiefel_frames(g, 30, 3, batch_shape=(3,))
    want = T.sliced_cost_sphere(torch.from_numpy(x), torch.from_numpy(y), frames).mean()
    assert torch.equal(per, want) and per.shape == ()


@pytest.mark.parametrize("n,m", [(12, 12), (10, 14)])
def test_exact_transport_matches_jax(n, m):
    """The 'exact' solver: value and the plan gradient wrt the points."""
    rng = np.random.default_rng(n + m)
    x = rng.normal(size=(2, n, 3)).astype(np.float32)
    y = rng.normal(size=(2, m, 3)).astype(np.float32)
    kw = dict(cost="lp", p=2.0, solver="exact")
    jw = j_make(JTransport(**kw))
    jval, jg = jax.value_and_grad(lambda a: jw(a, jnp.asarray(y)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tval = t_make(TTransport(**kw))(tx, torch.from_numpy(y))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
