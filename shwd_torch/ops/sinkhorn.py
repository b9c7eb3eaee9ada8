"""Log-domain Sinkhorn and the near-exact EMD surrogate.

Counterpart of ``shwd_tpu/ops/sinkhorn.py``: ``sinkhorn_log``,
``_plan_cost``, ``emd2_approx``, ``sinkhorn_divergence_cost`` and
``sinkhorn_loss``. Gradients treat the transport plan as
constant (envelope theorem): the plan is detached, which matches the
exact-EMD gradient. Fixed iteration counts; the loops are Python loops.

The dual iterations run without autograd, on the detached cost: the
gradient never flows through the duals (the plan is detached), so
recording them would only keep every iteration's (..., N, M) temporaries
alive until the backward pass (about 800 of them for one ``emd2_approx``
at the default 4 x 50 iterations). Only ``_plan_cost`` sees the live
cost: values and gradients are those of the recorded loop, bit for bit.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import group_max


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))


def _uniform_logs(cost: torch.Tensor, a, b):
    n, m = cost.shape[-2], cost.shape[-1]
    if a is None:
        a = torch.zeros_like(cost[..., 0]) + 1.0 / n
    if b is None:
        b = torch.zeros_like(cost[..., 0, :]) + 1.0 / m
    return a, b, torch.log(a), torch.log(b)


def sinkhorn_log(cost: torch.Tensor, eps: float = 0.01, num_iters: int = 100,
                 a: torch.Tensor | None = None, b: torch.Tensor | None = None,
                 f0: torch.Tensor | None = None, g0: torch.Tensor | None = None):
    """Entropic OT in the log domain, batched over leading dims of cost.

    cost: (..., N, M). a, b: optional (..., N)/(..., M) marginals (uniform
    by default). ``f0``/``g0`` warm-start the dual potentials. Returns
    (transport_cost, f, g): <P, C> with P the entropic plan, and the duals.
    """
    a, b, log_a, log_b = _uniform_logs(cost, a, b)
    with torch.no_grad():
        c = cost.detach()
        f = torch.zeros_like(a) if f0 is None else f0.detach()
        g = torch.zeros_like(b) if g0 is None else g0.detach()
        for _ in range(num_iters):
            # f_i = -eps * LSE_j [ (g_j - C_ij)/eps + log b_j ]
            f = -eps * _logsumexp((g[..., None, :] - c) / eps + log_b[..., None, :], -1)
            g = -eps * _logsumexp((f[..., :, None] - c) / eps + log_a[..., :, None], -2)
    return _plan_cost(cost, f, g, log_a, log_b, eps), f, g


def _plan_cost(cost, f, g, log_a, log_b, eps):
    """<P, C> with log P = (f + g - C)/eps + log a + log b, P detached
    (made without autograd: the product with the live cost is all the
    backward pass needs)."""
    with torch.no_grad():
        log_p = ((f[..., :, None] + g[..., None, :] - cost.detach()) / eps
                 + log_a[..., :, None] + log_b[..., None, :])
        p = torch.exp(log_p)
    return torch.sum(p * cost, dim=(-2, -1))


def eps_schedule(cost: torch.Tensor, eps: float, num_scales: int) -> torch.Tensor:
    """``emd2_approx``'s temperatures, (num_scales,) on ``cost``'s device:
    geometric from eps0 = max|C| over the WHOLE batch down to ``eps``. Made
    on the device without a host sync; the warm-up kernel
    (``sinkhorn_kernels.sinkhorn_warm``) reads the same tensor."""
    # under a data-parallel fit, the max over every rank's block of the batch
    eps0 = torch.clamp_min(group_max(torch.amax(torch.abs(cost.detach()))), 1e-30)
    ratios = torch.linspace(0.0, 1.0, num_scales, dtype=cost.dtype,
                            device=cost.device)
    # log(eps) as a Python number: a device tensor made from it would be a
    # synchronising host-to-device copy
    return torch.exp(torch.log(eps0) * (1 - ratios) + math.log(eps) * ratios)


def emd2_approx(cost: torch.Tensor, eps: float = 5e-3, num_iters: int = 50,
                num_scales: int = 4, a: torch.Tensor | None = None,
                b: torch.Tensor | None = None,
                return_potentials: bool = False):
    """Near-exact EMD <P*, C> via epsilon-scaled log-Sinkhorn.

    cost (..., N, M) -> (...,). The temperature anneals geometrically from
    eps0 = max|C| over the WHOLE batch (one eps0 for every item) down to
    ``eps`` over ``num_scales`` stages of ``num_iters`` iterations each,
    warm-starting the potentials without rescaling them between stages.
    With ``return_potentials`` returns (val, f, g).
    """
    a, b, log_a, log_b = _uniform_logs(cost, a, b)
    eps_sched = eps_schedule(cost, eps, num_scales)
    with torch.no_grad():
        c = cost.detach()
        f = torch.zeros_like(a)
        g = torch.zeros_like(b)
        for s in range(num_scales):
            e = eps_sched[s]
            for _ in range(num_iters):
                f = -e * _logsumexp((g[..., None, :] - c) / e + log_b[..., None, :], -1)
                g = -e * _logsumexp((f[..., :, None] - c) / e + log_a[..., :, None], -2)
    val = _plan_cost(cost, f, g, log_a, log_b, eps)
    if return_potentials:
        return val, f, g
    return val


def sinkhorn_divergence_cost(c_xy: torch.Tensor, c_xx: torch.Tensor,
                             c_yy: torch.Tensor, eps: float = 5e-3,
                             num_iters: int = 50, num_scales: int = 4
                             ) -> torch.Tensor:
    """Debiased entropic OT: S = W(x,y) - (W(x,x) + W(y,y)) / 2, clamped at 0.

    The sharp entropic cost <P, C> has an O(eps) bias floor when the two
    measures are close: the plan blurs over an eps-ball, so the surrogate
    (and its gradient) stops resolving differences below that scale. The
    divergence subtracts the same floor via the self-transport terms and is
    zero iff the measures coincide.
    """
    kw = dict(eps=eps, num_iters=num_iters, num_scales=num_scales)
    v_xy = emd2_approx(c_xy, **kw)
    v_xx = emd2_approx(c_xx, **kw)
    v_yy = emd2_approx(c_yy, **kw)
    return torch.clamp_min(v_xy - 0.5 * (v_xx + v_yy), 0.0)


def sinkhorn_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 0.01,
                  num_iters: int = 100, p: float = 2,
                  wasserstein_root: bool = False) -> torch.Tensor:
    """Sinkhorn loss between point clouds with Lp ground cost, batch-meaned.
    With ``wasserstein_root`` the per-item cost is raised to 1/p."""
    from .costs import lp_cost

    c = lp_cost(x, y, p)
    val, _, _ = sinkhorn_log(c, eps=eps, num_iters=num_iters)
    if wasserstein_root:
        val = val ** (1.0 / p)
    return torch.mean(val)
