"""Port parity: Sinkhorn and the warm-up kernel's plain version vs shwd_tpu.

The JAX warm-up runs as its own tests run it here: the Pallas kernel in
interpret mode. The CUDA kernel itself is held against the plain version
on the card in test_torch_kernels_gpu.py.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import math

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


def _clouds(rng, b, n, m):
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, m, 3)).astype(np.float32))


def test_sinkhorn_divergence_cost_matches_jax():
    """S = W(x,y) - (W(x,x) + W(y,y)) / 2 from three costs: rtol 1e-3
    (three emd2_approx solves), and ~0 for identical clouds."""
    from shwd_torch.ops.costs import cost_matrix as t_cost
    from shwd_tpu.ops.costs import cost_matrix as j_cost
    x, y = _clouds(np.random.default_rng(6), 2, 24, 24)
    kw = dict(eps=5e-3, num_iters=30, num_scales=3)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = js.sinkhorn_divergence_cost(j_cost(jx, jy), j_cost(jx, jx), j_cost(jy, jy), **kw)
    got = ts.sinkhorn_divergence_cost(t_cost(tx, ty), t_cost(tx, tx), t_cost(ty, ty), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3)
    same = ts.sinkhorn_divergence_cost(t_cost(tx, tx), t_cost(tx, tx), t_cost(tx, tx), **kw)
    assert float(same.abs().max()) < 1e-6


@pytest.mark.parametrize("root", [False, True])
def test_sinkhorn_loss_matches_jax(root):
    """The baseline criterion's loss and its gradient (rtol 1e-3)."""
    import jax
    x, y = _clouds(np.random.default_rng(7), 3, 20, 16)
    kw = dict(eps=0.01, num_iters=40, p=2, wasserstein_root=root)
    want, gwant = jax.value_and_grad(lambda a: js.sinkhorn_loss(a, jnp.asarray(y), **kw))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ts.sinkhorn_loss(xt, torch.from_numpy(y), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-3)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("solver", ["sinkhorn", "sinkhorn_div"])
@pytest.mark.parametrize("batched", [True, False])
def test_transport_sinkhorn_solvers_match_jax(solver, batched):
    """make_transport on the CPU routes of both packages, batched (mean
    over the batch) and unbatched (a 0-dim value): rtol 1e-3."""
    from shwd_torch.losses.transport import TransportConfig as TT, make_transport as t_make
    from shwd_tpu.losses.transport import TransportConfig as JT, make_transport as j_make
    x, y = _clouds(np.random.default_rng(8), 3, 20, 20)
    if not batched:
        x, y = x[0], y[0]
    kw = dict(cost="lp", p=2.0, solver=solver, eps=5e-3, num_iters=30, num_scales=3)
    want = j_make(JT(**kw))(jnp.asarray(x), jnp.asarray(y))
    got = t_make(TT(**kw))(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)



def _recorded_plan_cost(cost, f, g, log_a, log_b, eps):
    """``_plan_cost`` as it was: the plan built with autograd on, then
    detached."""
    log_p = ((f[..., :, None] + g[..., None, :] - cost) / eps
             + log_a[..., :, None] + log_b[..., None, :])
    p = torch.exp(log_p).detach()
    return torch.sum(p * cost, dim=(-2, -1))


def _recorded_emd2_approx(cost, eps, num_iters, num_scales):
    """``emd2_approx`` as the port computed it before its dual iterations
    ran without autograd: every iteration recorded on the live cost."""
    n, m = cost.shape[-2], cost.shape[-1]
    a = torch.zeros_like(cost[..., 0]) + 1.0 / n
    b = torch.zeros_like(cost[..., 0, :]) + 1.0 / m
    log_a, log_b = torch.log(a), torch.log(b)
    eps0 = torch.clamp_min(torch.amax(torch.abs(cost)), 1e-30).detach()
    ratios = torch.linspace(0.0, 1.0, num_scales, dtype=cost.dtype)
    eps_sched = torch.exp(torch.log(eps0) * (1 - ratios) + math.log(eps) * ratios)
    f, g = torch.zeros_like(a), torch.zeros_like(b)
    for s in range(num_scales):
        e = eps_sched[s]
        for _ in range(num_iters):
            f = -e * ts._logsumexp((g[..., None, :] - cost) / e + log_b[..., None, :], -1)
            g = -e * ts._logsumexp((f[..., :, None] - cost) / e + log_a[..., :, None], -2)
    return _recorded_plan_cost(cost, f, g, log_a, log_b, eps)


def _recorded_sinkhorn_log(cost, eps, num_iters):
    """``sinkhorn_log``'s value as the recorded loop computed it."""
    n, m = cost.shape[-2], cost.shape[-1]
    log_a = torch.log(torch.zeros_like(cost[..., 0]) + 1.0 / n)
    log_b = torch.log(torch.zeros_like(cost[..., 0, :]) + 1.0 / m)
    f, g = torch.zeros_like(log_a), torch.zeros_like(log_b)
    for _ in range(num_iters):
        f = -eps * ts._logsumexp((g[..., None, :] - cost) / eps + log_b[..., None, :], -1)
        g = -eps * ts._logsumexp((f[..., :, None] - cost) / eps + log_a[..., :, None], -2)
    return _recorded_plan_cost(cost, f, g, log_a, log_b, eps)


def _saved_cost_sized(fn, costs):
    """(value, number of saved tensors as large as the smallest cost or
    larger) of ``fn(costs)`` under autograd's saved-tensor hooks."""
    saved, smallest = [], min(c.numel() for c in costs)

    def pack(t):
        if t.numel() >= smallest:
            saved.append(t.shape)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        val = fn(costs)
    return val, len(saved)


_KW = dict(eps=5e-3, num_iters=50, num_scales=4)
_SOLVES = {
    "emd2_approx": (lambda c: ts.emd2_approx(c[0], **_KW),
                    lambda c: _recorded_emd2_approx(c[0], **_KW)),
    "sinkhorn_log": (lambda c: ts.sinkhorn_log(c[0], eps=0.05, num_iters=50)[0],
                     lambda c: _recorded_sinkhorn_log(c[0], 0.05, 50)),
    "divergence": (lambda c: ts.sinkhorn_divergence_cost(*c, **_KW),
                   lambda c: torch.clamp_min(_recorded_emd2_approx(c[0], **_KW) - 0.5 * (
                       _recorded_emd2_approx(c[1], **_KW)
                       + _recorded_emd2_approx(c[2], **_KW)), 0.0)),
}


@pytest.mark.parametrize("which", list(_SOLVES))
def test_plain_sinkhorn_saves_only_the_plan(which):
    """The dual iterations record nothing for the backward pass: a solve
    saves at most 2 tensors of a cost's size (the recorded loop saved ~4
    an iteration: ~800 at 4 x 50), and its value and gradient are the
    recorded loop's bit for bit. ~1 s on one worker."""
    rng = np.random.default_rng(11)
    shapes = [(2, 24, 20), (2, 24, 24), (2, 20, 20)] if which == "divergence" else [(2, 24, 20)]
    costs = [torch.from_numpy(_cost(rng, *shape)).requires_grad_(True) for shape in shapes]
    ref_costs = [c.detach().clone().requires_grad_(True) for c in costs]
    port, recorded = _SOLVES[which]
    got, n_saved = _saved_cost_sized(port, costs)
    want, n_ref = _saved_cost_sized(recorded, ref_costs)
    assert n_saved <= 2 * len(costs), n_saved
    assert n_ref > 100 * len(costs), n_ref
    assert torch.equal(got, want)
    for a, w in zip(torch.autograd.grad(got.sum(), costs),
                    torch.autograd.grad(want.sum(), ref_costs)):
        assert torch.equal(a, w)
