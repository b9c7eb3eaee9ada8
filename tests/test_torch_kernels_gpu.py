"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips without a card. This file imports no JAX,
so it also runs where JAX is absent (the conftest of this directory
imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from shwd_torch.ops import auction as ta
from shwd_torch.ops import sinkhorn_kernels as tk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _costs(b, n, m, seed, spread=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    if spread is None:
        y = rng.normal(size=(b, m, 3)).astype(np.float32)
    else:
        y = x + spread * rng.normal(size=(b, n, 3)).astype(np.float32)
    return np.sum((x[:, :, None, :] - y[:, None, :, :]) ** 2, -1).astype(np.float32)


def _lsa(c):
    vals = []
    for ci in c.astype(np.float64):
        r, k = linear_sum_assignment(ci)
        vals.append(ci[r, k].mean())
    return np.array(vals)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1200, 1200), (2, 300, 333)])
def test_warmup_kernel_matches_reference(cuda, shape):
    """K1 vs its plain version: val rtol 1e-3, f/g atol 1e-4."""
    c = torch.from_numpy(_costs(*shape, seed=8)).to(cuda) / 12
    v1, f1, g1 = tk.emd2_warmup(c, eps=1e-5, num_iters=40, num_scales=8)
    v2, f2, g2 = tk.emd2_warmup_reference(c, eps=1e-5, num_iters=40,
                                          num_scales=8)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v1.cpu().numpy(), v2.cpu().numpy(), rtol=1e-3)
    np.testing.assert_allclose(f1.cpu().numpy(), f2.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(g1.cpu().numpy(), g2.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(4, 128), (1, 1200)])
def test_auction_kernel_matches_reference(cuda, b, n):
    """K2 vs its plain version from Sinkhorn-warmed prices, as the hybrid
    solver runs it: the same assignment, sweeps and prices (the same f32
    arithmetic), and the exact value (rtol 1e-4 vs scipy)."""
    c = torch.from_numpy(_costs(b, n, n, seed=9, spread=0.2)).to(cuda)
    prices0 = ta._sinkhorn_warm_prices(c, 1e-5, 40, 8).contiguous()
    kw = dict(max_sweeps=4000, prices0=prices0, eps0=ta._hybrid_eps0(c, 1e-7))
    a1, p1, s1 = ta.auction_assignment(c, 1e-7, **kw)
    a2, p2, s2 = ta.auction_assignment_reference(c, 1e-7, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(s1, s2)
    np.testing.assert_allclose(p1.cpu().numpy(), p2.cpu().numpy(), atol=1e-5)
    for row in a1.cpu().numpy():
        assert sorted(row.tolist()) == list(range(n))
    np.testing.assert_allclose(ta._assignment_cost(c, a1).cpu().numpy(),
                               _lsa(c.cpu().numpy()), rtol=1e-4)


@pytest.mark.gpu
def test_auction_kernel_screens_duplicate_seed(cuda):
    """A seed claiming one object twice still yields a permutation."""
    c = torch.from_numpy(_costs(2, 64, 64, seed=3, spread=0.3)).to(cuda)
    seed = torch.arange(64, dtype=torch.int32, device=cuda).repeat(2, 1)
    seed[0, 3] = seed[0, 7]
    a, _, _ = ta.auction_assignment(c, 1e-7, eps0=1e-3, assign0=seed,
                                    max_sweeps=4000)
    for row in a.cpu().numpy():
        assert sorted(row.tolist()) == list(range(64))
    np.testing.assert_allclose(ta._assignment_cost(c, a).cpu().numpy(),
                               _lsa(c.cpu().numpy()), rtol=1e-4)


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_input(cuda):
    c = torch.from_numpy(_costs(1, 32, 32, seed=1)).to(cuda)
    k1, k2 = tk.emd2_warmup.launches, ta.auction_assignment.launches
    tk.emd2_warmup(c, eps=1e-3, num_iters=2, num_scales=2)
    ta.auction_assignment(c, 1e-5, max_sweeps=4000)
    assert tk.emd2_warmup.launches == k1 + 1
    assert ta.auction_assignment.launches == k2 + 1
    with pytest.raises(ValueError):
        tk.emd2_warmup(c.double())
    with pytest.raises(ValueError):
        ta.auction_assignment(c.transpose(1, 2))


@pytest.mark.gpu
def test_flow_step_makes_no_host_sync(cuda):
    """A Flow_cube SHWD step (1200 points, hybrid) never waits on the card:
    CUDA's sync debug mode raises on any synchronising call."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 1200, device=cuda)
    tgt = sample_cube_surface(rng, 1200, biased=True, device=cuda)
    cfg = fd.FlowConfig(shwd_layers=5, shwd_solver="hybrid")
    init_state, step = fd._make_loss_step(cfg, cuda)
    state = init_state(torch.Generator(device=cuda).manual_seed(0))
    points = src.clone().requires_grad_(True)
    state["opt"], state["sched"] = fd._make_point_opt(cfg, points)
    step(points, tgt, state)             # first step: libraries load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            loss = step(points, tgt, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(loss))
