"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips without a card. This file imports no JAX,
so it also runs where JAX is absent (the conftest of this directory
imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from shwd_torch.ops import auction as ta
from shwd_torch.ops import sinkhorn_kernels as tk
from shwd_torch.ops import sinkhorn_fused as tp
from shwd_torch.ops.chamfer import chamfer, chamfer_tiled, chamfer_tiled_reference


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
@pytest.mark.parametrize("shape,eps", [
    ((1, 1200, 1200), 1e-5), ((2, 300, 333), 1e-5),
    ((4, 1500, 1536), 1e-5),     # more rows than the grid's shared memory holds
    ((1, 1664, 1792), 1e-5),     # the size gate's edge: the next 128 columns fail it
    ((3, 700, 800), 1e-5),       # blocks whose rows span two items
    ((1, 8, 40000), 1e-5),       # g too wide for shared memory
    # many items per block; at 16 x 24 the plan is a handful of entries, and
    # val keeps 1e-3 only at a temperature that does not sharpen it to one
    ((300, 16, 24), 1e-3),
])
def test_warmup_kernel_matches_reference(cuda, shape, eps):
    """K1 vs its plain version: val rtol 1e-3, f/g atol 1e-4; and two calls
    give the same bits (partials are merged in a fixed order)."""
    c = torch.from_numpy(_costs(*shape, seed=8)).to(cuda) / 12
    kw = dict(eps=eps, num_iters=40, num_scales=8)
    v1, f1, g1 = tk.emd2_warmup(c, **kw)
    v2, f2, g2 = tk.emd2_warmup_reference(c, **kw)
    v3, f3, g3 = tk.emd2_warmup(c, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v1.cpu().numpy(), v2.cpu().numpy(), rtol=1e-3)
    np.testing.assert_allclose(f1.cpu().numpy(), f2.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(g1.cpu().numpy(), g2.cpu().numpy(), atol=1e-4)
    assert torch.equal(v1, v3) and torch.equal(f1, f3) and torch.equal(g1, g3)


@pytest.mark.gpu
def test_warmup_kernel_layouts(cuda):
    """The flow shape is resident in shared memory; a batch that overflows
    it streams its rows from global memory; the gate's edge is admitted."""
    flow = tk.warmup_layout(torch.empty(1, 1200, 1200, device=cuda))
    assert flow["resident"] == 1 and flow["g_cached"] == 1
    assert flow["grid"] * flow["rows_per_block"] >= 1200
    big = tk.warmup_layout(torch.empty(4, 1500, 1536, device=cuda))
    assert big["resident"] == 0
    assert tk.warmup_supported(1664, 1792) and not tk.warmup_supported(1664, 1920)


@pytest.mark.gpu
def test_warmup_kernel_is_one_launch_per_call(cuda):
    """One call puts exactly one kernel on the device's timeline."""
    c = torch.from_numpy(_costs(1, 1200, 1200, seed=8)).to(cuda) / 12
    tk.emd2_warmup(c)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tk.emd2_warmup(c)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and not ev.name.startswith(("Memcpy", "Memset"))]
    assert len(names) == 1 and "warmup_kernel" in names[0], names


@pytest.mark.gpu
def test_warmup_kernel_is_captured_in_a_cuda_graph(cuda):
    """The cooperative launch records into a CUDA graph and replays: the
    replay on a new cost equals a direct call on it, bit for bit."""
    kw = dict(eps=1e-5, num_iters=40, num_scales=8)
    c1 = torch.from_numpy(_costs(1, 1200, 1200, seed=8)).to(cuda) / 12
    c2 = torch.from_numpy(_costs(1, 1200, 1200, seed=18)).to(cuda) / 12
    static = c1.clone()
    tk.emd2_warmup(static, **kw)                 # build and set up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tk.emd2_warmup(static, **kw)
    static.copy_(c2)
    graph.replay()
    torch.cuda.synchronize()
    want = tk.emd2_warmup(c2, **kw)
    for a, b in zip(out, want):
        assert torch.equal(a, b)


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


def _tie_costs(b, n, seed):
    """Small-integer entries with a duplicated row and a duplicated column:
    ties in the best value, in the bids and between persons."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=(b, n, n)).astype(np.float32)
    c[:, 1] = c[:, 0]
    c[:, :, 3] = c[:, :, 2]
    return c


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("case", ["1x1200", "4x128", "128x128", "ties_3x61", "ties_2x128"])
def test_auction_kernel_is_the_reference_at_every_cluster_size(cuda, case, cluster):
    """K2 forced to each cluster size: the assignment, the prices and the
    sweeps of the plain version, bit for bit, ties included (the 64-bit
    key's order is the tie rule, so the split of the work cannot show)."""
    if case.startswith("ties"):
        b, n = (int(v) for v in case.split("_")[1].split("x"))
        c = torch.from_numpy(_tie_costs(b, n, seed=21)).to(cuda)
        kw = dict(max_sweeps=4000)
    else:
        b, n = (int(v) for v in case.split("x"))
        c = torch.from_numpy(_costs(b, n, n, seed=9, spread=0.2)).to(cuda)
        kw = dict(max_sweeps=4000, eps0=ta._hybrid_eps0(c, 1e-7),
                  prices0=ta._sinkhorn_warm_prices(c, 1e-5, 40, 8).contiguous())
    a1, p1, s1, _ = ta._auction_launch(c, 1e-7, 6.0, kw["max_sweeps"], kw.get("prices0"),
                                       kw.get("eps0"), None, cluster=cluster)
    assert ta._auction_launch.last_cluster == cluster
    a2, p2, s2 = ta.auction_assignment_reference(c, 1e-7, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(p1, p2) and torch.equal(s1, s2)
    for row in a1.cpu().numpy():
        assert sorted(row.tolist()) == list(range(n))


@pytest.mark.gpu
def test_auction_wrapper_picks_the_cluster_from_the_batch(cuda):
    """One problem gets a cluster of 16 (one CTA where the card reports no
    room for such a cluster), 128 problems one CTA each."""
    one = torch.from_numpy(_costs(1, 96, 96, seed=2, spread=0.3)).to(cuda)
    ta.auction_assignment(one, 1e-6)
    assert ta._auction_launch.last_cluster == (16 if ta._device_fits16(cuda, 96) else 1)
    many = torch.from_numpy(_costs(128, 32, 32, seed=2, spread=0.3)).to(cuda)
    ta.auction_assignment(many, 1e-6)
    assert ta._auction_launch.last_cluster == 1
    with pytest.raises(ValueError):
        ta._auction_launch(one, 1e-6, 6.0, 2000, None, None, None, cluster=3)
    with pytest.raises(ValueError):          # more objects than shared memory holds
        ta.auction_assignment(torch.zeros(1, 9700, 9700, device=cuda), 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 16])
def test_auction_kernel_screens_duplicate_seed(cuda, cluster):
    """A seed claiming one object twice still yields a permutation, on one
    CTA and on a cluster of 16 (every CTA screens its own copy)."""
    c = torch.from_numpy(_costs(2, 64, 64, seed=3, spread=0.3)).to(cuda)
    seed = torch.arange(64, dtype=torch.int32, device=cuda).repeat(2, 1)
    seed[0, 3] = seed[0, 7]
    eps0 = torch.full((1,), 1e-3, device=cuda)
    a, p, _, _ = ta._auction_launch(c, 1e-7, 6.0, 4000, None, eps0, seed, cluster=cluster)
    a2, p2, _ = ta.auction_assignment_reference(c, 1e-7, eps0=eps0, assign0=seed,
                                                max_sweeps=4000)
    assert torch.equal(a, a2) and torch.equal(p, p2)
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


# -- the small-problem warm-up: emd2_approx's iterations in one launch ------------

WARM_KW = dict(eps=5e-3, num_iters=50, num_scales=4)     # the hybrid cells' warm-up
# the kernel's f and g against the plain emd2_approx on the card, as a share
# of the item's max |C|: the two differ by rounding only (z through the f32
# reciprocal of e in one fused multiply-add, ex2.approx, the kernel's sum
# order). Measured on an H100 at 1.6e-6 at most over these shapes and seeds
# (3.9e-6 absolute at max |C| 6.4); 1e-5 leaves 6x room and is ~2000x under
# the 2e-2 that a per-item eps0 moves f by
WARM_RTOL = 1e-5


def _warm_gap(a, b, c):
    """max |a - b| per item over the item's max |C|, the largest item's."""
    scale = c.abs().amax(dim=(1, 2))
    return float(((a - b).abs().amax(dim=1) / scale).max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 128, 128), (25, 128, 128), (3, 100, 120),
                                   (2, 7, 9)])
def test_sinkhorn_warm_kernel_matches_plain(cuda, shape):
    """sinkhorn_warm's f and g against emd2_approx's on the card (the train
    step's and the validation pass's last batch, a ragged batch and a tiny
    one), within WARM_RTOL of max |C|; two calls give the same bits (the
    column pairs merge in a fixed order)."""
    from shwd_torch.ops.sinkhorn import emd2_approx
    c = torch.from_numpy(_costs(*shape, seed=30)).to(cuda) / 12
    launches = tk.sinkhorn_warm.launches
    f1, g1 = tk.sinkhorn_warm(c, **WARM_KW)
    f2, g2 = tk.sinkhorn_warm(c, **WARM_KW)
    _, fp, gp = emd2_approx(c, return_potentials=True, **WARM_KW)
    torch.cuda.synchronize()
    assert tk.sinkhorn_warm.launches == launches + 2
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
    assert bool(torch.isfinite(f1).all() and torch.isfinite(g1).all())
    assert _warm_gap(f1, fp, c) <= WARM_RTOL and _warm_gap(g1, gp, c) <= WARM_RTOL


@pytest.mark.gpu
def test_sinkhorn_warm_kernel_follows_the_batch_eps0(cuda):
    """Items whose cost scales differ by 100x: the kernel anneals both from
    the batch's one eps0, as emd2_approx does, and so ends far from the
    potentials of the small item solved alone (its own eps0)."""
    from shwd_torch.ops.sinkhorn import emd2_approx
    c = torch.from_numpy(_costs(2, 128, 128, seed=31)).to(cuda) / 12
    c[1] *= 100
    f, g = tk.sinkhorn_warm(c, **WARM_KW)
    _, fp, gp = emd2_approx(c, return_potentials=True, **WARM_KW)
    _, f_alone, _ = emd2_approx(c[:1], return_potentials=True, **WARM_KW)
    torch.cuda.synchronize()
    assert _warm_gap(f, fp, c) <= WARM_RTOL and _warm_gap(g, gp, c) <= WARM_RTOL
    assert float((f[0] - f_alone[0]).abs().max()) > 1e-2


@pytest.mark.gpu
def test_sinkhorn_warm_kernel_is_one_node_without_host_sync(cuda):
    """A call captured in a CUDA graph adds one kernel node to those of its
    temperature schedule (torch ops); the replay on a new cost equals a
    direct call on it, bit for bit; the call and the hybrid solver's warm
    prices make no host sync; bad input raises."""
    from shwd_torch.ops.sinkhorn import eps_schedule
    from shwd_torch.utils.graphs import graph_node_types
    c1 = torch.from_numpy(_costs(128, 128, 128, seed=32)).to(cuda) / 12
    c2 = torch.from_numpy(_costs(128, 128, 128, seed=33)).to(cuda) / 12
    static = c1.clone()

    def kernel_nodes(fn):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out = fn()
        return graph, out, graph_node_types(graph).count(0)

    _, _, schedule = kernel_nodes(lambda: eps_schedule(static, 5e-3, 4))
    graph, out, nodes = kernel_nodes(lambda: tk.sinkhorn_warm(static, **WARM_KW))
    assert nodes == schedule + 1
    static.copy_(c2)
    graph.replay()
    want = tk.sinkhorn_warm(c2, **WARM_KW)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    torch.cuda.set_sync_debug_mode("error")
    try:
        tk.sinkhorn_warm(c1, **WARM_KW)
        ta._sinkhorn_warm_prices(c1, 5e-3, 50, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ta._sinkhorn_warm_prices.last_route == "sinkhorn_warm"
    for bad in (c1.double(), c1.transpose(1, 2), torch.zeros(2, 129, 64, device=cuda)):
        with pytest.raises(ValueError):
            tk.sinkhorn_warm(bad)


@pytest.mark.gpu
def test_cold_hybrid_solve_on_the_kernels_prices(cuda):
    """A cold hybrid_assignment_warm at 128 x 128 x 128 on the kernel's
    prices: every item a permutation within 1e-6 of scipy's f64 optimum,
    with sweeps within 1.5x of an auction priced by the plain emd2_approx."""
    from shwd_torch.ops.sinkhorn import emd2_approx
    c = torch.from_numpy(_costs(128, 128, 128, seed=34, spread=0.3)).to(cuda)
    launches = tk.sinkhorn_warm.launches
    av, _, _, sweeps = ta.hybrid_assignment_warm(c, None, None, use_warm=False,
                                                 sink_eps=5e-3, sink_iters=50,
                                                 sink_scales=4)
    assert tk.sinkhorn_warm.launches == launches + 1
    _, _, gp = emd2_approx(c, return_potentials=True, **WARM_KW)
    _, _, plain_sweeps = ta.auction_assignment(c, 1e-7, max_sweeps=4000,
                                               prices0=(-gp).contiguous(),
                                               eps0=ta._hybrid_eps0(c, 1e-7))
    torch.cuda.synchronize()
    assert _is_perm(av.cpu().numpy())
    gap = ta._assignment_cost(c.double(), av).cpu().numpy() - _lsa(c.cpu().numpy())
    assert gap.max() <= 1e-6, gap.max()
    ratio = float(sweeps.sum()) / float(plain_sweeps.sum())
    assert 1 / 1.5 <= ratio <= 1.5, (int(sweeps.sum()), int(plain_sweeps.sum()))


def _is_perm(a):
    return all(sorted(row.tolist()) == list(range(len(row))) for row in a)


def _clouds(b, n, m, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    y = rng.normal(size=(b, m, 3)).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,p", [
    ((128, 128, 128), "lp", 2.0), ((51, 128, 128), "lp", 2.0),
    ((3, 100, 130), "lp", 2.0),
    ((3, 100, 130), "cosine", 1.0), ((3, 100, 130), "geodesic", 2.0),
    ((2, 200, 260), "lp", 2.0),        # tiles in the global scratch
    ((2, 40, 600), "cosine", 2.0),     # more columns than threads
])
def test_sinkhorn_points_kernel_matches_reference(cuda, shape, kind, p):
    """K3 vs its plain version: val rtol 1e-3, f/g atol 1e-4 (f32 sums in
    another order over 200 dependent iterations)."""
    x, y = _clouds(*shape, seed=11, dev=cuda)
    kw = dict(eps=5e-3, num_iters=50, num_scales=4)
    v1, f1, g1 = tp._fused_forward(x, y, kind, p, **kw)
    v2, f2, g2 = tp.sinkhorn_points_reference(x, y, kind, p, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v1.cpu().numpy(), v2.cpu().numpy(), rtol=1e-3)
    np.testing.assert_allclose(f1.cpu().numpy(), f2.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(g1.cpu().numpy(), g2.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,p", [
    ((128, 128, 128), "lp", 2.0), ((51, 128, 128), "lp", 2.0),
    ((3, 100, 120), "lp", 2.0), ((3, 100, 120), "cosine", 1.0),
    ((3, 100, 120), "geodesic", 2.0),
    ((2, 100, 100), "cosine", 2.0),    # square, ragged rows and columns
    ((2, 7, 9), "lp", 2.0), ((2, 1, 5), "lp", 2.0),
])
def test_sinkhorn_points_register_route_matches_reference(cuda, shape, kind, p):
    """K3's register route vs the plain version: val rtol 1e-3, f/g atol
    1e-4; two calls give the same bits (fixed-order merges, no atomics)."""
    x, y = _clouds(*shape, seed=16, dev=cuda)
    kw = dict(eps=5e-3, num_iters=50, num_scales=4)
    v1, f1, g1 = tp._fused_forward(x, y, kind, p, **kw, route="registers")
    assert tp._fused_forward.last_route == "registers"
    again = tp._fused_forward(x, y, kind, p, **kw, route="registers")
    v2, f2, g2 = tp.sinkhorn_points_reference(x, y, kind, p, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v1.cpu().numpy(), v2.cpu().numpy(), rtol=1e-3)
    np.testing.assert_allclose(f1.cpu().numpy(), f2.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(g1.cpu().numpy(), g2.cpu().numpy(), atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip((v1, f1, g1), again))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,p", [
    ((3, 100, 130), "lp", 2.0), ((3, 100, 130), "cosine", 1.0),
    ((3, 100, 130), "geodesic", 2.0),
    ((128, 128, 128), "lp", 2.0),      # the general route at the train shape
])
def test_sinkhorn_points_general_route_matches_reference(cuda, shape, kind, p):
    """K3's general route (tiles in shared memory or a global scratch) vs
    the plain version: val rtol 1e-3, f/g atol 1e-4."""
    x, y = _clouds(*shape, seed=17, dev=cuda)
    kw = dict(eps=5e-3, num_iters=50, num_scales=4)
    v1, f1, g1 = tp._fused_forward(x, y, kind, p, **kw, route="general")
    assert tp._fused_forward.last_route == "general"
    v2, f2, g2 = tp.sinkhorn_points_reference(x, y, kind, p, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v1.cpu().numpy(), v2.cpu().numpy(), rtol=1e-3)
    np.testing.assert_allclose(f1.cpu().numpy(), f2.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(g1.cpu().numpy(), g2.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
def test_sinkhorn_points_wrapper_picks_the_route(cuda):
    """The wrapper's route is pick_route's, and a route the shape cannot
    take raises."""
    kw = dict(eps=5e-3, num_iters=2, num_scales=2)
    for shape in ((128, 128, 128), (51, 128, 128), (3, 100, 130)):
        x, y = _clouds(*shape, seed=18, dev=cuda)
        tp._fused_forward(x, y, "lp", 2.0, **kw)
        assert tp._fused_forward.last_route == tp.pick_route(*shape[1:])
    x, y = _clouds(2, 100, 130, seed=18, dev=cuda)
    with pytest.raises(ValueError):
        tp._fused_forward(x, y, "lp", 2.0, **kw, route="registers")
    with pytest.raises(ValueError):
        tp._fused_forward(x, y, "lp", 2.0, **kw, route="shared")


@pytest.mark.gpu
def test_sinkhorn_points_single_scale(cuda):
    """num_scales=1 keeps the JAX package's behaviour: the only
    temperature is eps0, the plan is formed with eps."""
    x, y = _clouds(2, 32, 48, seed=12, dev=cuda)
    kw = dict(eps=5e-2, num_iters=30, num_scales=1)
    v1, f1, _ = tp._fused_forward(x, y, "lp", 2.0, **kw)
    v2, f2, _ = tp.sinkhorn_points_reference(x, y, "lp", 2.0, **kw)
    np.testing.assert_allclose(v1.cpu().numpy(), v2.cpu().numpy(), rtol=1e-3)
    np.testing.assert_allclose(f1.cpu().numpy(), f2.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,p", [("lp", 2.0), ("cosine", 1.0)])
def test_sinkhorn_points_gradient(cuda, kind, p):
    """The autograd.Function's gradient (kernel duals, plan pulled through
    the cost) against autograd of the same envelope from the plain
    version's duals: atol 1e-5 on gradients of size ~1e-2."""
    from shwd_torch.ops.costs import cost_matrix
    x, y = _clouds(3, 100, 130, seed=13, dev=cuda)
    kw = dict(eps=5e-3, num_iters=50, num_scales=4)
    x1, y1 = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    k0 = tp.sinkhorn_points.launches
    w = torch.arange(1.0, 4.0, device=cuda)
    (tp.sinkhorn_points(x1, y1, kind, p, **kw) * w).sum().backward()
    assert tp.sinkhorn_points.launches == k0 + 1
    _, f, g = tp.sinkhorn_points_reference(x, y, kind, p, **kw)
    x2, y2 = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    c = cost_matrix(x2, y2, kind, p)
    plan = torch.exp((f[:, :, None] + g[:, None, :] - c.detach()) / kw["eps"]
                     - np.log(100) - np.log(130))
    ((plan * c).sum((1, 2)) * w).sum().backward()
    np.testing.assert_allclose(x1.grad.cpu().numpy(), x2.grad.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(y1.grad.cpu().numpy(), y2.grad.cpu().numpy(), atol=1e-5)


@pytest.mark.gpu
def test_emd2_points_picks_the_kernel_on_the_card(cuda):
    x, y = _clouds(2, 64, 64, seed=14, dev=cuda)
    k0 = tp.sinkhorn_points.launches
    tp.emd2_points(x, y)                          # gate admits lp p=2
    assert tp.sinkhorn_points.launches == k0 + 1
    tp.emd2_points(x, y, "lp", 1.0)               # p=1: the emd2_approx route
    tp.emd2_points(x, y, use_kernel=False)
    assert tp.sinkhorn_points.launches == k0 + 1
    with pytest.raises(ValueError):
        tp.sinkhorn_points(x.double(), y.double())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 128, 128), (1, 1200, 1200),
                                   (2, 5000, 4099), (1, 7, 3),
                                   (1, 40000, 8)])      # 40 slices of 1000 points
def test_chamfer_kernel_matches_reference(cuda, shape):
    """K4 vs its plain version and the dense form: rtol 1e-5 (the same
    squared differences; fused multiply-adds and the order of the mean)."""
    x, y = _clouds(*shape, seed=15, dev=cuda)
    k0 = chamfer_tiled.launches
    got = float(chamfer_tiled(x, y))
    assert chamfer_tiled.launches == k0 + 1
    np.testing.assert_allclose(got, float(chamfer_tiled_reference(x, y)), rtol=1e-5)
    np.testing.assert_allclose(got, float(chamfer(x, y)), rtol=1e-5)
    with pytest.raises(ValueError):
        chamfer_tiled(x.transpose(1, 2), y)


@pytest.mark.gpu
def test_chamfer_kernel_is_one_launch_with_the_same_bits(cuda):
    """Three calls put exactly three kernels on the device's timeline, all
    K4's (no memset), and every call gives the same bits (minima, then sums
    in a fixed order; no atomics). Profiled in a fresh process: after the
    earlier tests of this file (a CUDA graph capture among them) the
    profiler recorded no kernels in this one."""
    script = """
import json, torch
from shwd_torch.ops.chamfer import chamfer_tiled
g = torch.Generator().manual_seed(19)
x = torch.randn(1, 1200, 3, generator=g).cuda()
y = torch.randn(1, 1200, 3, generator=g).cuda()
first = chamfer_tiled(x, y)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    outs = [chamfer_tiled(x, y) for _ in range(3)]
    torch.cuda.synchronize()
names = [ev.name for ev in prof.events()
         if ev.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(ev, "is_user_annotation", False) and "#" not in ev.name]
print(json.dumps({"names": names, "same": all(torch.equal(first, o) for o in outs)}))
"""
    root = Path(__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(got["names"]) == 3 and all("chamfer_kernel" in n for n in got["names"]), got
    assert got["same"]


@pytest.mark.gpu
def test_chamfer_kernel_is_captured_in_a_cuda_graph(cuda):
    """The cooperative launch records into a CUDA graph and replays: the
    replay on new clouds equals a direct call on them, bit for bit."""
    x1, y1 = _clouds(1, 1200, 1200, seed=20, dev=cuda)
    x2, y2 = _clouds(1, 1200, 1200, seed=21, dev=cuda)
    sx, sy = x1.clone(), y1.clone()
    chamfer_tiled(sx, sy)                        # build and set up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chamfer_tiled(sx, sy)
    sx.copy_(x2)
    sy.copy_(y2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, chamfer_tiled(x2, y2))
    np.testing.assert_allclose(float(out), float(chamfer(x2, y2)), rtol=1e-5)


@pytest.mark.gpu
def test_run_flow_cd_metric_launches_the_chamfer_kernel(cuda):
    """run_flow with eval_metric="cd" records K4's Chamfer at iteration 0
    and after each interval; the last value is the dense chamfer of the
    returned cloud (rtol 1e-5)."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 300).numpy()
    tgt = sample_cube_surface(rng, 300, biased=True).numpy()
    cfg = fd.FlowConfig(num_iterations=4, eval_interval=2, shwd_layers=2,
                        shwd_solver="hybrid", eval_metric="cd")
    k0 = chamfer_tiled.launches
    res = fd.run_flow(src, tgt, cfg)
    assert chamfer_tiled.launches == k0 + 3
    want = float(chamfer(torch.from_numpy(res.clouds).to(cuda)[None],
                         torch.from_numpy(tgt).to(cuda)[None]))
    np.testing.assert_allclose(res.eval_values[-1], want, rtol=1e-5)


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


@pytest.mark.gpu
@pytest.mark.parametrize("criterion,solver", [("w_cos", "sinkhorn"),
                                              ("w_cos", "hybrid"), ("cd", "sinkhorn")])
def test_registration_train_step_makes_no_host_sync(cuda, tmp_path, criterion, solver):
    """A registration train step (B=128, N=128, full-width PCRNet) never
    waits on the card: CUDA's sync debug mode raises on any synchronising
    call. The sinkhorn step launches K3 twice."""
    from shwd_torch.data import DatasetConfig, RegistrationDataset, TransformConfig
    from shwd_torch.losses import SHWDConfig, TransportConfig
    from shwd_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        log_dir=str(tmp_path), criterion=criterion, batch_size=128,
        dataset=DatasetConfig(num_synthetic=128, synthetic_kinds=("composite",),
                              cache_dir=str(tmp_path / "mc"),
                              transform=TransformConfig(noise_sigma=0.02)),
        shwd=SHWDConfig(transport=TransportConfig(solver=solver), max_iter=1,
                        lam=1.3e-5, phi_lr=9.2e-5))
    trainer = Trainer(cfg)
    ds = RegistrationDataset(cfg.dataset, "train")
    state = trainer.init_state(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    batches = list(ds.batches(gen, np.arange(128), 128, shuffle=False)) * 3
    trainer._train_step(state, batches[0])     # first step: libraries load
    torch.cuda.synchronize()
    k0 = tp.sinkhorn_points.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in batches[1:]:
            loss = trainer._train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(loss))
    want = 4 if (criterion, solver) == ("w_cos", "sinkhorn") else 0
    assert tp.sinkhorn_points.launches == k0 + want


def _registration_trainer(tmp_path, criterion, n=128, **kw):
    """A trainer at B=128 on the 'composite' bank, its state and a batch."""
    from shwd_torch.data import DatasetConfig, RegistrationDataset, TransformConfig
    from shwd_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        log_dir=str(tmp_path), criterion=criterion, batch_size=128,
        dataset=DatasetConfig(source_point_num=n, target_point_num=n, num_synthetic=128,
                              synthetic_kinds=("composite",), cache_dir=str(tmp_path / "mc"),
                              transform=TransformConfig(noise_sigma=0.02)), **kw)
    trainer = Trainer(cfg)
    ds = RegistrationDataset(cfg.dataset, "train")
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    return trainer, state, next(ds.batches(gen, np.arange(128), 128, shuffle=False))


def _new_criteria_kw(case):
    from shwd_torch.losses import MaxSSWConfig, SHWDConfig, TransportConfig
    if case == "pseudo_w_cos":
        return "pseudo_w_cos", 128, {}
    if case == "max_ssw":
        return "max_ssw", 128, dict(max_ssw=MaxSSWConfig(
            num_projections=512, max_iter=1, phi_lr=9.213e-5, p=1.0))
    return "w_cos", 1024, dict(shwd=SHWDConfig(
        transport=TransportConfig(cost="geodesic", p=2.0, solver="ssw"), max_iter=1,
        lam=1.311e-5, phi_lr=9.213e-5, phi_weight_decay=1.41e-8))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pseudo_w_cos", "max_ssw", "w_cos_ssw_1024"])
def test_new_criteria_train_step_makes_no_host_sync(cuda, tmp_path, case):
    """One train step of pseudo_w_cos (K3 twice), max_ssw (512 projections,
    p = 1) and w_cos on the ssw solver at N=1024 (the p = 2 correlation
    branch) never waits on the card."""
    criterion, n, kw = _new_criteria_kw(case)
    trainer, state, batch = _registration_trainer(tmp_path, criterion, n, **kw)
    trainer._train_step(state, batch)            # first step: libraries load
    torch.cuda.synchronize()
    k0 = tp.sinkhorn_points.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            loss = trainer._train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(loss))
    assert tp.sinkhorn_points.launches == k0 + (4 if case == "pseudo_w_cos" else 0)


@pytest.mark.gpu
def test_pseudo_criterion_launches_k3_phi_num_times(cuda, tmp_path):
    """A pseudo_w_cos criterion call puts K3 on the card once per ensemble
    member, in train and in eval mode (the wrapper's count; the device's
    timeline in a fresh process, as the K4 test explains)."""
    script = """
import json, torch
from shwd_torch.losses import PseudoSHWDConfig, PseudoSHWDLoss, TransportConfig
from shwd_torch.flows import make_flow
from shwd_torch.ops import sinkhorn_fused as sp
crit = PseudoSHWDLoss(lambda g: make_flow("Residual", 3, generator=g),
                      PseudoSHWDConfig(transport=TransportConfig(), phi_num=3))
state = crit.init(torch.Generator(device="cuda").manual_seed(0))
g = torch.Generator(device="cuda").manual_seed(1)
x = torch.randn(128, 128, 3, generator=g, device="cuda", requires_grad=True)
y = torch.randn(128, 128, 3, generator=g, device="cuda")
crit.apply(state, x, y, True)[0][0].backward()
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
counts = []
for train in (True, False):
    k0 = sp.sinkhorn_points.launches
    with torch.profiler.profile(activities=acts) as prof:
        crit.apply(state, x, y, train)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and "sinkhorn_points" in ev.name]
    counts.append([sp.sinkhorn_points.launches - k0, len(names)])
print(json.dumps(counts))
"""
    root = Path(__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == [[3, 3], [3, 3]]


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_ssw_value_on_the_card_matches_the_cpu(cuda, p):
    """The ssw transport at N=1024 (16 pairs of clouds on S^2, 100 frames
    drawn on the CPU and handed to both): the card's value is the CPU's at
    rtol 1e-5 (p = 2 takes the correlation branch, cuFFT against the CPU's
    FFT; p = 3 the bisection)."""
    from shwd_torch.losses import TransportConfig, make_transport
    from shwd_torch.ops.spherical import stiefel_frames

    g = torch.Generator().manual_seed(3)
    x = torch.randn(16, 1024, 3, generator=g)
    y = x + 0.2 * torch.randn(16, 1024, 3, generator=g)
    x, y = (t / t.norm(dim=-1, keepdim=True) for t in (x, y))
    frames = stiefel_frames(torch.Generator().manual_seed(4), 100, 3)
    w = make_transport(TransportConfig(solver="ssw", p=p, reduce="none"))
    want = w(x, y, frames=frames)
    got = w(x.to(cuda), y.to(cuda), frames=frames.to(cuda)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.gpu
def test_refine_step_on_k3_makes_no_host_sync(cuda):
    """Pose refinement with loss "sinkhorn" at the registration batch
    (B=128, N=128): one step and the final per-object loss launch K3 twice
    and never wait on the card."""
    from shwd_torch.train.pose_refine import PoseRefineConfig, refine_poses

    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(128, 128, 3)), dtype=torch.float32, device=cuda)
    tgt = src + 0.1
    cfg = PoseRefineConfig(loss="sinkhorn", num_steps=1)
    refine_poses(src, tgt, cfg)              # first call: the library loads
    torch.cuda.synchronize()
    k0 = tp.sinkhorn_points.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = refine_poses(src, tgt, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tp.sinkhorn_points.launches == k0 + cfg.num_steps + 1
    assert bool(torch.isfinite(res.losses).all() and torch.isfinite(res.pose_7d).all())


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["SWD", "MSWD", "SSWD", "SSWD_W1", "CD", "W2",
                                    "GSWD_POLY", "GSWD_POLY3", "MGSWD_POLY", "GSWD_CIRC",
                                    "MGSWD_CIRC", "ASWD", "DSWD", "GSW_NN", "MGSW_NN"])
def test_flow_method_step_makes_no_host_sync(cuda, method):
    """A Flow_cube step (1200 points) of each method beside SHWD, its inner
    Adam loops included, never waits on the card."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 1200, device=cuda)
    tgt = sample_cube_surface(rng, 1200, biased=True, device=cuda)
    cfg = fd.FlowConfig(method=method)
    init_state, step = fd._make_loss_step(cfg, cuda)
    state = init_state(torch.Generator(device=cuda).manual_seed(0))
    points = src.clone().requires_grad_(True)
    state["opt"], state["sched"] = fd._make_point_opt(cfg, points)
    step(points, tgt, state)             # first step: constants reach the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            loss = step(points, tgt, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(points).all())


# -- fused execution: captured steps replayed -------------------------------------

def _fused_fit_pair(tmp_path, criterion, n=128, epochs=2, **kw):
    """``Trainer.fit`` at B=128 on a 640-shape 'composite' bank (448 train
    clouds: 3 train steps an epoch; 192 validation clouds: a full eval batch
    and a tail of 64) with fused_epoch True and False, from the same seed.
    Returns (fused trainer, fused result, per-step result)."""
    import dataclasses

    from shwd_torch.data import DatasetConfig, RegistrationDataset, TransformConfig
    from shwd_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        experiment="fused", log_dir=str(tmp_path), criterion=criterion, batch_size=128,
        num_epochs=epochs, seed=0, checkpoint_flush_every=0,
        dataset=DatasetConfig(source_point_num=n, target_point_num=n, num_synthetic=640,
                              synthetic_kinds=("composite",), val_split=0.3,
                              cache_dir=str(tmp_path / "mc"),
                              transform=TransformConfig(noise_sigma=0.02)), **kw)
    out = []
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_epoch=fused, experiment=f"fused_{fused}")
        trainer = Trainer(c)
        ds = RegistrationDataset(c.dataset, "train")
        out.append((trainer, trainer.fit(ds, verbose=False)))
    (trainer, fused_res), (_, step_res) = out
    return trainer, fused_res, step_res


def _history_rel_diff(a, b):
    keys = ("train_loss", "val_loss", "rot_error", "trans_error")
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
               for x, y in zip(a["history"], b["history"]) for k in keys)


def _sinkhorn_kw(solver):
    from shwd_torch.losses import SHWDConfig, TransportConfig
    return dict(shwd=SHWDConfig(
        transport=TransportConfig(cost="lp", p=2.0, solver=solver, eps=5e-3,
                                  num_iters=50, num_scales=4),
        max_iter=1, lam=1.3e-5, phi_lr=9.2e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["sinkhorn", "hybrid"])
def test_captured_train_and_eval_steps_match_the_per_step_path(cuda, tmp_path, solver):
    """w_cos on K3 ("sinkhorn") and on K2 ("hybrid"): two epochs, each 3
    replays of the captured train step and one replay each of the full and
    the tail eval graph, against fused_epoch=False from the same seed. The
    history agrees to rtol 1e-4 (cuBLAS may pick other algorithms under
    capture), the weights after it to atol 1e-5; the graphs hold the
    kernels as nodes: K3 2 per train step and 1 per eval batch, K2 2 per
    train step."""
    trainer, fused, step = _fused_fit_pair(tmp_path, "w_cos", **_sinkhorn_kw(solver))
    assert fused["path"] == "fused" and step["path"].startswith("per_step")
    assert all(r["path"] == "fused" for r in fused["history"])
    assert _history_rel_diff(fused, step) <= 1e-4
    for a, b in zip(fused["state"].model.parameters(), step["state"].model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    stats = fused["graphs"]
    train = [s for s in fused["graphs"] if s["name"].startswith("train")]
    evals = [s for s in fused["graphs"] if s["name"].startswith("eval")]
    assert len(train) == 1 and train[0]["replays"] == 6, stats
    assert sorted(s["replays"] for s in evals) == [2, 2], stats
    kernel = "sinkhorn_points" if solver == "sinkhorn" else "auction_assignment"
    assert train[0]["nodes_by_kernel"].get(kernel) == 2, train[0]
    if solver == "sinkhorn":
        assert all(s["nodes_by_kernel"].get(kernel) == 1 for s in evals), evals
    assert all(s["kernel_nodes"] and s["kernel_nodes"] > 100 for s in fused["graphs"])


@pytest.mark.gpu
def test_replays_count_kernel_launches(cuda, tmp_path):
    """The K3 counter under replay: a 1-epoch sinkhorn fit counts 2 launches
    for the train step's warm-up and 2 per replay (3 steps), 1 for each eval
    graph's warm-up and 1 per replay (a full batch and a tail): 12."""
    k0 = tp.sinkhorn_points.launches
    _, fused, _ = _fused_fit_pair(tmp_path, "w_cos", epochs=1, **_sinkhorn_kw("sinkhorn"))
    fused_launches = 2 + 2 * 3 + 2 * (1 + 1)
    per_step = 2 * 3 + 2
    assert tp.sinkhorn_points.launches - k0 == fused_launches + per_step


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cd", "pseudo_w_cos", "max_ssw", "w_cos_ssw"])
def test_captured_steps_of_the_other_criteria_match_the_per_step_path(cuda, tmp_path,
                                                                      case):
    """cd (no kernel), pseudo_w_cos (K3 twice a call) and the criteria that
    draw inside the step (max-SSW's frames, the ssw solver's frames) with
    their generator registered with the graph: two fused epochs equal the
    per-step run's to rtol 1e-4."""
    from shwd_torch.losses import MaxSSWConfig, SHWDConfig, TransportConfig
    kw = {"cd": dict(criterion="cd"), "pseudo_w_cos": dict(criterion="pseudo_w_cos"),
          "max_ssw": dict(criterion="max_ssw", max_ssw=MaxSSWConfig(
              num_projections=128, max_iter=1, phi_lr=9.213e-5, p=1.0)),
          "w_cos_ssw": dict(criterion="w_cos", shwd=SHWDConfig(
              transport=TransportConfig(cost="geodesic", p=2.0, solver="ssw",
                                        num_projections=64),
              max_iter=1, lam=1.311e-5, phi_lr=9.213e-5))}[case]
    _, fused, step = _fused_fit_pair(tmp_path, **kw)
    assert fused["path"] == "fused"
    assert _history_rel_diff(fused, step) <= 1e-4


@pytest.mark.gpu
def test_capture_with_a_host_sync_raises(cuda, tmp_path):
    """A step that reads a value on the host cannot be captured: StepGraph
    raises with the step's name, and Trainer.fit raises instead of running
    the step eagerly."""
    from shwd_torch.data import DatasetConfig, RegistrationDataset
    from shwd_torch.train import TrainConfig, Trainer
    from shwd_torch.utils.graphs import StepGraph

    x = torch.ones(4, device=cuda)
    graph = StepGraph("syncing step", lambda t: t * float(t.sum()), [x], device=cuda)
    with pytest.raises(RuntimeError, match="syncing step"):
        graph(x)
    cfg = TrainConfig(log_dir=str(tmp_path), criterion="cd", batch_size=8, num_epochs=1,
                      dataset=DatasetConfig(source_point_num=32, target_point_num=32,
                                            num_synthetic=32, cache_dir=str(tmp_path / "mc")))
    trainer = Trainer(cfg)
    inner = trainer.crit_apply

    def syncing(state, x, y, train=True):
        (loss, sx, sy), state = inner(state, x, y, train)
        return (loss * float(loss), sx, sy), state

    trainer.crit_apply = syncing
    with pytest.raises(RuntimeError, match="capturing step 'train step of cd"):
        trainer.fit(RegistrationDataset(cfg.dataset, "train"), verbose=False)


@pytest.mark.gpu
def test_step_graph_replays_the_eager_draws(cuda):
    """A registered generator: three replays of a step that draws from it
    give the three eager steps' numbers bit for bit, and leave the
    generator where the eager steps leave it."""
    from shwd_torch.utils.graphs import StepGraph

    gen = torch.Generator(device=cuda).manual_seed(5)
    twin = torch.Generator(device=cuda).manual_seed(5)
    acc = torch.zeros(3, 8, device=cuda)
    row = torch.zeros((), dtype=torch.long, device=cuda)

    def step():
        acc.index_copy_(0, row[None], torch.randn(1, 8, generator=gen, device=cuda))
        row.add_(1)

    graph = StepGraph("draw", step, (), device=cuda, generators=[gen])
    for _ in range(3):
        graph()
    want = torch.stack([torch.randn(8, generator=twin, device=cuda) for _ in range(3)])
    assert torch.equal(acc, want)
    assert torch.equal(torch.randn(8, generator=gen, device=cuda),
                       torch.randn(8, generator=twin, device=cuda))


@pytest.mark.gpu
def test_step_graph_marks_time_the_step(cuda):
    """A step captured with device marks around a product, K3 (its own
    mark ``k3``) and a sum, between two unmarked adds: after five replays
    and a sync, ``collect`` notes each label's positive ms, less than the
    whole step's in sum (the adds are outside every mark); K3's
    mark reads within 25 % of K3 timed alone between CUDA events at the
    same shapes; the product's end and K3's start share one event (no work
    was captured between them); a second collect without replays notes
    nothing."""
    from shwd_torch.utils import profiling
    from shwd_torch.utils.graphs import StepGraph

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(128, 128, 3, generator=gen, device=cuda)
    y = torch.randn(128, 128, 3, generator=gen, device=cuda)
    w = torch.eye(3, device=cuda) + 0.01 * torch.randn(3, 3, generator=gen, device=cuda)
    total = torch.zeros((), device=cuda)
    pad = torch.zeros(1 << 20, device=cuda)
    kw = dict(eps=5e-3, num_iters=50, num_scales=4)

    def step():
        pad.add_(1.0)
        with profiling.device_span("product"):
            moved = x @ w
        val = tp.sinkhorn_points(moved, y, "lp", 2.0, **kw)
        with profiling.device_span("sum"):
            total.add_(val.sum())
        pad.add_(1.0)

    # the eager warm-up loads K3's library before the capture
    graph = StepGraph("marks", step, (), device=cuda, warmup=step)
    for _ in range(5):
        graph()
    torch.cuda.synchronize()
    got = graph.collect()
    assert got["graph"] == "marks" and got["replays"] == 5
    assert set(got["ms"]) == {"product", "k3", "sum"}
    assert all(ms > 0 for ms in got["ms"].values())
    assert sum(got["ms"].values()) < got["graph_ms"]
    spans = graph._marks.spans
    assert [s[0] for s in spans] == ["product", "k3", "sum", "graph"]
    assert spans[1][1] is spans[0][2]
    moved = (x @ w).contiguous()
    for _ in range(2):
        tp.fused_forward(moved, y, "lp", 2.0, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        tp.fused_forward(moved, y, "lp", 2.0, **kw)
    end.record()
    torch.cuda.synchronize()
    alone = start.elapsed_time(end) / 20
    assert abs(got["ms"]["k3"] - alone) <= 0.25 * alone, (got, alone)
    assert graph.collect() is None
    assert profiling.records()[-1].attrs == got


# phi's residual-chain kernels in an SHWD step: the inner pass forward, its
# backward with the parameters' partials and their reduction, the power
# iteration; the final pass forward and its dL/dx
PHI_NODES = {"residual_chain_forward": 2, "residual_chain_backward": 2,
             "residual_chain_grad_reduce": 1, "residual_chain_power_iteration": 1}


@pytest.mark.gpu
def test_captured_flow_step_matches_the_per_step_loop(cuda):
    """The Flow_cube SHWD/hybrid step (1200 points, K1 once and K2 twice a
    step) captured and replayed 10 times gives the per-step loop's points
    (atol 1e-6) and W2; the graph holds K1 once, K2 twice and phi's six
    kernel nodes."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 1200).numpy()
    tgt = sample_cube_surface(rng, 1200, biased=True).numpy()
    cfg = fd.FlowConfig(num_iterations=10, eval_interval=5, shwd_solver="hybrid")
    k1, k2 = tk.emd2_warmup.launches, ta.auction_assignment.launches
    fused = fd.run_flow(src, tgt, cfg)
    # warm-up step on copies, then 10 replays
    assert tk.emd2_warmup.launches - k1 == 11 and ta.auction_assignment.launches - k2 == 22
    step = fd.run_flow(src, tgt, cfg, fused=False)
    assert fused.path == "fused" and step.path.startswith("per_step")
    assert fused.graph["nodes_by_kernel"] == {"emd2_warmup": 1, "auction_assignment": 2,
                                              **PHI_NODES}
    np.testing.assert_allclose(fused.clouds, step.clouds, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fused.eval_values, step.eval_values, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["SWD", "SSWD", "SSWD_W1", "CD", "W2", "GSWD_POLY",
                                    "GSWD_POLY3", "GSWD_CIRC", "GSW_NN"])
def test_captured_flow_methods_match_the_per_step_loop(cuda, method):
    """The sliced zoo's fused methods (300 points, 6 iterations), the random
    directions drawn inside the captured step from the registered
    generator: the points equal the per-step loop's (atol 1e-6)."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 300).numpy()
    tgt = sample_cube_surface(rng, 300, biased=True).numpy()
    cfg = fd.FlowConfig(method=method, num_iterations=6, eval_interval=3)
    fused = fd.run_flow(src, tgt, cfg)
    step = fd.run_flow(src, tgt, cfg, fused=False)
    assert fused.path == "fused"
    np.testing.assert_allclose(fused.clouds, step.clouds, rtol=0, atol=1e-6)


# -- the last per-step paths captured: refinement, the inner ascents, the mesh --------

def _refine_problem(cuda):
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(128, 128, 3)), dtype=torch.float32, device=cuda)
    tgt = src @ torch.as_tensor([[0.98, -0.2, 0.0], [0.2, 0.98, 0.0], [0.0, 0.0, 1.0]],
                                dtype=torch.float32, device=cuda) + 0.05
    return src, tgt


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["sinkhorn", "cd", "ssw"])
def test_captured_refinement_matches_the_per_step_path(cuda, loss):
    """refine_poses at the registration batch (B=128, N=128, 30 steps): the
    cached graphs replayed (a second call, under sync-debug "error": no host
    sync) give the per-step path's poses, loss trace and per-object losses
    bit for bit (ssw: the frames drawn from the registered generator, which
    ends where the per-step draws leave it); K3 counts its graph nodes per
    replay: 1 in the step graph, 1 in the final one."""
    from shwd_torch.train import pose_refine as pr

    src, tgt = _refine_problem(cuda)
    cfg = pr.PoseRefineConfig(loss=loss, num_steps=30)
    pr.clear_cache()
    gens = [torch.Generator(device=cuda).manual_seed(4) for _ in range(2)]
    pr.refine_poses(src, tgt, cfg, torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    k0 = tp.sinkhorn_points.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = pr.refine_poses(src, tgt, cfg, gens[0])
        k_fused = tp.sinkhorn_points.launches - k0
        step = pr.refine_poses(src, tgt, cfg, gens[1], fused=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(fused, step):
        assert torch.equal(a, b)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    stats = pr.cached_graphs()
    assert all(s["captured"] for s in stats) and [s["replays"] for s in stats] == [60, 2]
    want = [1, 1] if loss == "sinkhorn" else [0, 0]
    assert [s["nodes_by_kernel"].get("sinkhorn_points", 0) for s in stats] == want
    assert k_fused == want[0] * cfg.num_steps + want[1]
    assert float(fused.losses[-1]) < float(fused.losses[0])
    pr.clear_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["MSWD", "MGSWD_POLY", "MGSWD_CIRC", "ASWD", "DSWD",
                                    "MGSW_NN"])
def test_captured_inner_ascent_methods_match_the_per_step_loop(cuda, method):
    """The six methods with an inner ascent (the functional Adam, the nets
    written back in place) at the Flow_cube width (1200 points): the fused
    run's points at iteration 50 equal the per-step loop's bit for bit."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 1200).numpy()
    tgt = sample_cube_surface(rng, 1200, biased=True).numpy()
    cfg = fd.FlowConfig(method=method, num_iterations=50, eval_interval=50)
    fused = fd.run_flow(src, tgt, cfg, eval_fn=lambda p, t: 0.0)
    step = fd.run_flow(src, tgt, cfg, eval_fn=lambda p, t: 0.0, fused=False)
    assert fused.path == "fused" and fused.graph["captured"]
    assert fused.graph["replays"] == 50
    assert np.array_equal(fused.clouds, step.clouds)
    assert float(np.abs(fused.clouds - src).max()) > 0.01


@pytest.mark.gpu
def test_meshed_fused_fit_equals_the_unmeshed_fused_fit(cuda, tmp_path):
    """A world-size-1 NCCL mesh (mesh_data=1): the fused fit captures the
    step with its collectives (phi's inner gradients and the gradient
    bucket, 2 a step, counted per replay) and gives the un-meshed fused
    fit's history and weights bit for bit."""
    import dataclasses

    import torch.distributed as dist
    from shwd_torch.data import DatasetConfig, RegistrationDataset, TransformConfig
    from shwd_torch.parallel import mesh as pmesh
    from shwd_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        experiment="mesh", log_dir=str(tmp_path), criterion="w_cos", batch_size=128,
        num_epochs=2, seed=0, checkpoint_flush_every=0,
        dataset=DatasetConfig(source_point_num=128, target_point_num=128,
                              num_synthetic=640, synthetic_kinds=("composite",),
                              val_split=0.3, cache_dir=str(tmp_path / "mc"),
                              transform=TransformConfig(noise_sigma=0.02)),
        **_sinkhorn_kw("sinkhorn"))
    out = {}
    try:
        for mesh_data in (None, 1):
            c = dataclasses.replace(cfg, mesh_data=mesh_data, experiment=f"m{mesh_data}")
            trainer = Trainer(c)
            pmesh.collective_calls = 0
            res = trainer.fit(RegistrationDataset(c.dataset, "train"), verbose=False)
            out[mesh_data] = (trainer, res, pmesh.collective_calls)
        trainer, meshed, calls = out[1]
        assert dist.get_backend() == "nccl" and trainer._n_data == 1
        assert meshed["path"] == "fused"
        _, plain, _ = out[None]
        keys = ("train_loss", "val_loss", "rot_error", "trans_error")
        assert [[r[k] for k in keys] for r in meshed["history"]] == \
            [[r[k] for k in keys] for r in plain["history"]]
        for a, b in zip(meshed["state"].model.parameters(),
                        plain["state"].model.parameters()):
            assert torch.equal(a, b)
        train = [g for g in meshed["graphs"] if g["name"].startswith("train")]
        assert len(train) == 1 and train[0]["captured"] and train[0]["collectives"] == 2
        # graphs: collectives x (replays + warm-up); per epoch the loss and the
        # validation sums are reduced once outside them
        want = sum(g["collectives"] * (g["replays"] + 1) for g in meshed["graphs"])
        assert calls == want + 2 * cfg.num_epochs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def adam_step_ulps(a: torch.Tensor, b: torch.Tensor, lr: float) -> tuple[float, float]:
    """(largest |a - b| in ulps of b, largest |a - b| in ulps of max(|b|,
    lr)): the second is the rounding of an Adam update of size about lr,
    which a parameter that the update nearly cancels would inflate in the
    first."""
    diff = (a - b).abs().double()
    inf = torch.tensor(float("inf"), device=b.device)
    scale = torch.maximum(b.abs(), torch.full_like(b, lr))
    raw = diff / (torch.nextafter(b.abs(), inf) - b.abs()).double()
    scaled = diff / (torch.nextafter(scale, inf) - scale).double()
    return float(raw.max()), float(scaled.max())


@pytest.mark.gpu
def test_capturable_adam_step_against_the_eager_one(cuda):
    """Three torch_adam steps with capturable=True (step count and bias
    corrections on the card) and with capturable=False (on the host) on the
    same parameters and gradients (the flow's points, 1200 x 3, lr 0.01, and
    phi-like weights with coupled decay 0.1, lr 1e-3). The capturable Adam
    forms 1 - b2^t in f32 on the card, the host one in f64: at t = 3 that
    is 0.003 with ~1e-5 of relative error, so the updates differ by about
    that much, hundreds of ulps of their scale (printed), not by the
    last-place rounding of the arithmetic. Held: the updates agree to 1e-4
    of the largest one."""
    from shwd_torch.utils.optim import torch_adam

    rng = np.random.default_rng(0)
    worst = {}
    for name, shape, lr, wd in (("points", (1200, 3), 0.01, 0.0),
                                ("phi", (64, 64), 1e-3, 0.1)):
        w = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)
        g = torch.as_tensor(rng.normal(size=shape) * 1e-3, dtype=torch.float32,
                            device=cuda)
        out = []
        for capturable in (True, False):
            p = w.clone().requires_grad_(True)
            opt = torch_adam([p], lr, wd, capturable=capturable)
            for _ in range(3):
                p.grad = g.clone()
                opt.step()
            out.append(p.detach())
        ucap, uhost = (o.double() - w.double() for o in out)
        rel = float((ucap - uhost).abs().max() / uhost.abs().max())
        worst[name] = adam_step_ulps(out[0], out[1], lr) + (rel,)
        assert rel <= 1e-4, (name, rel)
    print("capturable vs host-side Adam after 3 steps: largest difference in ulps "
          "of the parameter, in ulps of the update's scale, relative to the "
          "largest update:", worst)


def _row_harness(name):
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_later_fits_leave_device_memory_where_it_started(cuda, tmp_path):
    """A fused w_cos fit (K3) leaves nothing allocated behind once its
    result and trainer are gone: after a first fit (which makes the
    process's cuBLAS workspaces, one per stream, kept for the process's
    life) two more fits each return memory_allocated() to the same bytes
    and peak at the same bytes, within one 2 MiB allocator block. Every
    graph captures on one side stream (utils/graphs.py::capture_stream):
    with a new stream per capture each fit left ~100 MiB of workspaces."""
    import gc

    from shwd_torch.data import DatasetConfig, RegistrationDataset, TransformConfig
    from shwd_torch.train import TrainConfig, Trainer
    cfg = TrainConfig(
        experiment="fit_memory", log_dir=str(tmp_path), criterion="w_cos", batch_size=128,
        num_epochs=2, seed=0, **_sinkhorn_kw("sinkhorn"),
        dataset=DatasetConfig(source_point_num=128, target_point_num=128, num_synthetic=320,
                              synthetic_kinds=("composite",), cache_dir=str(tmp_path / "mc"),
                              transform=TransformConfig(noise_sigma=0.02)))

    def fit():
        trainer = Trainer(cfg)
        res = trainer.fit(RegistrationDataset(cfg.dataset, "train"), verbose=False)
        assert res["path"] == "fused"
        del trainer, res
        gc.collect()
        return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()

    fit()
    start = torch.cuda.memory_allocated()
    marks = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        marks.append(fit())
    print("start", start, "after, peak", marks)
    block = 2 << 20
    assert all(abs(after - start) <= block for after, _ in marks), (start, marks)
    assert abs(marks[1][1] - marks[0][1]) <= block, marks


@pytest.mark.gpu
def test_sinkhorn_div_1024_train_step_fits(cuda, tmp_path):
    """One train step of the w_cos_1024_sinkhorn_div row (B=128, N=M=1024:
    two solves of three (128, 1024, 1024) costs, 4 x 50 plain dual
    iterations each) runs on the card with a finite loss, and its peak is
    under a tenth of what the final solve's dual iterations would hold if
    autograd recorded them (~4 (B, N, M) f32 tensors an iteration, 3 x 800
    x 512 MiB)."""
    import dataclasses

    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer
    rows = _row_harness("registration_rows_torch")
    cfg = rows.row_config("w_cos_1024_sinkhorn_div", 0, str(tmp_path), 1)
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        cfg.dataset, num_synthetic=160, cache_dir=str(tmp_path / "mc")))
    trainer = Trainer(cfg)
    ds = RegistrationDataset(cfg.dataset, "train")
    state = trainer.init_state(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = next(ds.batches(gen, np.arange(128), 128, shuffle=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = trainer._train_step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    tp_ = cfg.shwd.transport
    recorded = 3 * (4 * tp_.num_iters * tp_.num_scales) * 128 * 1024 * 1024 * 4
    print("peak bytes", peak, "recorded duals bytes", recorded)
    assert torch.isfinite(loss) and peak < recorded / 10


@pytest.mark.gpu
def test_ellipsoid_flow_fused_equals_per_step_with_the_decaying_lr(cuda):
    """The ellipsoid_2 SHWD/hybrid flow (the JAX row's 1000-point clouds,
    K1 and K2) with the cosine-decayed point lr, cut to 100 iterations
    (the schedule decays over those 100): the captured step replayed with
    the lr tensor filled between replays gives the per-step loop's points
    at iteration 50 and at the end (atol 1e-5)."""
    import dataclasses

    from shwd_torch.train import flow_driver as fd
    flows = _row_harness("flow_rows_torch")
    src, tgt = flows.clouds("ellipsoid_2")
    cfg = dataclasses.replace(flows.flow_config("ellipsoid_2", "SHWD"), num_iterations=100,
                              eval_interval=50)
    assert cfg.lr_decay_alpha == 0.1
    seen = {True: [], False: []}
    out = {}
    for fused in (True, False):
        def keep(p, t, fused=fused):
            seen[fused].append(p.copy())
            return 0.0
        out[fused] = fd.run_flow(src, tgt, cfg, eval_fn=keep, fused=fused)
    assert out[True].path == "fused" and out[False].path.startswith("per_step")
    assert out[True].graph["nodes_by_kernel"] == {"emd2_warmup": 1, "auction_assignment": 2,
                                                  **PHI_NODES}
    np.testing.assert_allclose(seen[True][1], seen[False][1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[True].clouds, out[False].clouds, rtol=0, atol=1e-5)
    assert not np.array_equal(seen[True][1], seen[True][0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pose", "w_cos", "pseudo_w_cos", "max_ssw",
                                  "w_cos_1024_ssw"])
def test_jax_initial_state_on_the_card_gives_the_jax_values(cuda, name):
    """chip_smoke.py's phase jax_init: the JAX package's seed-1234 states
    (tools/init_states_jax.npz) loaded on the card by the row harness give
    the file's JAX values on its check batch: the pose within rtol 1e-4 /
    atol 1e-5, each criterion within rtol 1e-4 (w_cos and pseudo_w_cos
    through K3, against the JAX package's fused kernel in interpret mode)."""
    rows = _row_harness("registration_rows_torch")
    checks = {n: (port, want) for n, port, want in rows.jax_init_check(cuda)}
    for key in (["est_R", "est_t"] if name == "pose" else [name]):
        port, want = checks[key]
        tol = dict(rtol=1e-4, atol=1e-5) if name == "pose" else dict(rtol=1e-4, atol=0)
        np.testing.assert_allclose(port.reshape(want.shape), want, **tol, err_msg=key)
