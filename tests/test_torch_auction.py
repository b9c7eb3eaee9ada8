"""Port parity: the auction's plain version and the hybrid exact solver vs
shwd_tpu and scipy. The CUDA kernel itself is held against the plain
version on the card in test_torch_kernels_gpu.py."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from shwd_torch.ops import auction as ta
from shwd_tpu.ops import auction as ja


def _costs(n, b=3, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    y = x + spread * rng.normal(size=(b, n, 3)).astype(np.float32)
    return np.sum((x[:, :, None, :] - y[:, None, :, :]) ** 2, -1).astype(np.float32)


def _lsa(c):
    out = []
    for ci in c.astype(np.float64):
        r, k = linear_sum_assignment(ci)
        out.append(ci[r, k].mean())
    return np.array(out)


def _is_perm(a):
    return all(sorted(row.tolist()) == list(range(len(row))) for row in a)


@pytest.mark.parametrize("n,spread,warm", [(16, 1.0, False), (48, 0.3, False),
                                           (48, 0.3, True)])
def test_auction_reference_matches_jax(n, spread, warm):
    """Same f32 arithmetic, same tie rules: the same assignment, and prices
    within atol 1e-5 (they agree to the bit here)."""
    c = _costs(n, spread=spread, seed=n)
    kw = {}
    if warm:
        rng = np.random.default_rng(1)
        kw = dict(prices0=rng.normal(size=(3, n)).astype(np.float32) * 0.1,
                  eps0=np.float32(1e-3))
    a1, p1, _ = ja.auction_assignment(
        jnp.asarray(c), 1e-6, **{k: jnp.asarray(v) for k, v in kw.items()})
    a2, p2, s2 = ta.auction_assignment_reference(
        torch.from_numpy(c), 1e-6,
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(a2.numpy(), np.asarray(a1))
    np.testing.assert_allclose(p2.numpy(), np.asarray(p1), atol=1e-5, rtol=0)
    assert _is_perm(a2.numpy()) and s2.shape == (3,) and (s2 > 0).all()


def test_auction_wrapper_on_cpu_is_the_reference():
    c = torch.from_numpy(_costs(12))
    before = ta.auction_assignment.launches
    got = ta.auction_assignment(c, 1e-6)
    want = ta.auction_assignment_reference(c, 1e-6)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ta.auction_assignment.launches == before


@pytest.mark.parametrize("n,spread", [(64, 2.0), (128, 0.3), (128, 0.01)])
def test_hybrid_matches_jax_and_scipy(n, spread):
    """Exact values: rtol 1e-4 against scipy and against the JAX solver."""
    c = _costs(n, spread=spread, seed=7)
    got = ta.hybrid_emd2(torch.from_numpy(c), 1e-8).numpy()
    np.testing.assert_allclose(got, _lsa(c), rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ja.hybrid_emd2(jnp.asarray(c), 1e-8)),
                               rtol=1e-4)


def test_auction_emd2_matches_scipy():
    """Cold auction, the JAX package's own test case (rtol 1e-4)."""
    c = _costs(16, spread=1.0, seed=0)
    got = ta.auction_emd2(torch.from_numpy(c), 1e-8).numpy()
    np.testing.assert_allclose(got, _lsa(c), rtol=1e-4)


@pytest.mark.parametrize("solver", ["hybrid", "auction"])
def test_gradient_is_permutation_plan(solver):
    """d<P*, C>/dC = P* / N: one 1/N entry per row and column, and
    <grad, C> is the exact value (rtol 1e-4)."""
    c = torch.from_numpy(_costs(40)).requires_grad_(True)
    fn = ta.hybrid_emd2 if solver == "hybrid" else ta.auction_emd2
    fn(c, 1e-8).sum().backward()
    g = c.grad.numpy()
    np.testing.assert_allclose(g.sum(-1), 1 / 40, rtol=1e-6)
    np.testing.assert_allclose(g.sum(-2), 1 / 40, rtol=1e-6)
    assert (np.count_nonzero(g, axis=-1) == 1).all()
    np.testing.assert_allclose((g * c.detach().numpy()).sum((-2, -1)),
                               _lsa(c.detach().numpy()), rtol=1e-4)


def test_hybrid_assignment_warm_cold_and_warm():
    """Cold (sentinel) and warm (seeded from a nearby cost) solves give the
    exact value (vs scipy, atol 5e-5 as the JAX test) and the JAX package's
    value (atol 1e-6); warm uses fewer sweeps; every row a permutation."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 48, 3)).astype(np.float32)
    y = x[:, ::-1] + 0.3 * rng.normal(size=(4, 48, 3)).astype(np.float32)
    x2 = x + 1e-4 * rng.normal(size=x.shape).astype(np.float32)

    def cost(a):
        return np.sum((a[:, :, None] - y[:, None]) ** 2, -1).astype(np.float32)

    c1, c2 = cost(x), cost(x2)
    sent = ta.hybrid_warm_sentinel(4, 48)
    _, a1, p1, _ = ta.hybrid_assignment_warm(torch.from_numpy(c1), *sent,
                                             use_warm=False)
    av_w, _, _, s_w = ta.hybrid_assignment_warm(torch.from_numpy(c2), a1, p1,
                                                use_warm=True)
    av_c, _, _, s_c = ta.hybrid_assignment_warm(torch.from_numpy(c2), *sent,
                                                use_warm=False)
    v_w = ta._assignment_cost(torch.from_numpy(c2), av_w).numpy()
    v_c = ta._assignment_cost(torch.from_numpy(c2), av_c).numpy()
    np.testing.assert_allclose(v_w, v_c, atol=1e-6, rtol=0)
    np.testing.assert_allclose(v_w, _lsa(c2), atol=5e-5, rtol=0)
    assert s_w.sum() < s_c.sum()
    assert _is_perm(av_w.numpy()) and _is_perm(av_c.numpy())

    jsent = ja.hybrid_warm_sentinel(4, 48)
    _, ja1, jp1, _ = ja.hybrid_assignment_warm(jnp.asarray(c1), *jsent)
    jav, _, _, _ = ja.hybrid_assignment_warm(jnp.asarray(c2), ja1, jp1)
    jv = np.asarray(ja._assignment_cost(jnp.asarray(c2), jav))
    np.testing.assert_allclose(v_w, jv, atol=1e-6, rtol=0)


def test_hybrid_assignment_warm_cold_ignores_seed():
    """The caller names the branch: without ``use_warm`` the call raises;
    a cold solve ignores the seed, so None and the sentinel agree."""
    c = torch.from_numpy(_costs(24, b=2, seed=4))
    sent = ta.hybrid_warm_sentinel(2, 24)
    with pytest.raises(TypeError):
        ta.hybrid_assignment_warm(c, *sent)
    cold = ta.hybrid_assignment_warm(c, *sent, use_warm=False)
    bare = ta.hybrid_assignment_warm(c, None, None, use_warm=False)
    for a, b in zip(cold, bare):
        assert torch.equal(a, b)
    assert _is_perm(cold[0].numpy())


def test_duplicate_seed_is_screened():
    """A seed that claims one object twice (and one out of range) is
    screened: the result is still an exact permutation, in the plain
    version as in the kernel (the JAX package has no such screen)."""
    c = _costs(20, b=2, seed=5)
    seed = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    seed[0, 3] = seed[0, 7]            # object claimed twice
    seed[1, 2] = 99                    # out of range
    screened = ta._screen_seed(torch.from_numpy(seed), 20).numpy()
    assert screened[0, 3] == -1 and screened[0, 7] == -1
    assert screened[1, 2] == -1 and (screened[1, 3:] == seed[1, 3:]).all()
    a, _, _ = ta.auction_assignment(torch.from_numpy(c), 1e-8,
                                    assign0=torch.from_numpy(seed),
                                    eps0=1e-3)
    assert _is_perm(a.numpy())
    np.testing.assert_allclose(ta._assignment_cost(torch.from_numpy(c), a).numpy(),
                               _lsa(c), rtol=1e-4)


@pytest.mark.parametrize("on_card,n,m,route", [
    (False, 128, 128, "plain"), (False, 7, 9, "plain"), (False, 1200, 1200, "plain"),
    (True, 128, 128, "sinkhorn_warm"), (True, 100, 120, "sinkhorn_warm"),
    (True, 7, 9, "sinkhorn_warm"), (True, 1, 1, "sinkhorn_warm"),
    (True, 128, 129, "plain"), (True, 129, 128, "plain"), (True, 129, 129, "plain"),
    (True, 511, 513, "plain"),           # N*M one short of 512^2
    (True, 512, 512, "emd2_warmup"), (True, 256, 1024, "emd2_warmup"),
    (True, 1200, 1200, "emd2_warmup"),
    (True, 1664, 1792, "emd2_warmup"),   # warmup_supported's edge ...
    (True, 1664, 1920, "plain"),         # ... and one tile of columns past it
])
def test_warm_route_by_device_and_shape(on_card, n, m, route):
    """The cold solve's warm-up is chosen by device and shape alone: K1 at
    N*M >= 512^2 within its gate (the JAX package's rule), the small-problem
    kernel at N, M <= 128, the plain emd2_approx otherwise."""
    assert ta.warm_route(on_card, n, m) == route


@pytest.mark.parametrize("shape", [(4, 128, 128), (3, 100, 120), (2, 7, 9)])
def test_warm_prices_on_the_cpu_are_the_plain_potentials(shape):
    """On a CPU tensor the warm prices are -g of emd2_approx, bit for bit,
    and the small-problem kernel's wrapper runs emd2_approx itself,
    launching nothing."""
    from shwd_torch.ops import sinkhorn_kernels as tk
    from shwd_torch.ops.sinkhorn import emd2_approx

    b, n, m = shape
    rng = np.random.default_rng(n + m)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    y = rng.normal(size=(b, m, 3)).astype(np.float32)
    c = torch.from_numpy(np.sum((x[:, :, None] - y[:, None]) ** 2, -1).astype(np.float32))
    kw = dict(eps=5e-3, num_iters=50, num_scales=4)
    _, f, g = emd2_approx(c, return_potentials=True, **kw)
    prices = ta._sinkhorn_warm_prices(c, kw["eps"], kw["num_iters"], kw["num_scales"])
    assert ta._sinkhorn_warm_prices.last_route == "plain"
    assert torch.equal(prices, -g)
    launches = tk.sinkhorn_warm.launches
    f2, g2 = tk.sinkhorn_warm(c, **kw)
    assert torch.equal(f2, f) and torch.equal(g2, g)
    assert tk.sinkhorn_warm.launches == launches
