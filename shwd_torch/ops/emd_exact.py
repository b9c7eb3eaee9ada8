"""Exact EMD oracle on the host: scipy assignment or the C++ network simplex.

Counterpart of ``shwd_tpu/ops/emd_exact.py`` (``emd2_exact``,
``emd2_exact_batch``, ``w2_exact``, and ``emd2_exact_torch`` for the JAX
package's ``emd2_exact_jax``). The flow's exact W2 eval uses the scipy
``linear_sum_assignment`` fast path (uniform marginals, n == m); other
shapes go through the port's own copy of the network simplex
(``runtime/emd/network_simplex.cpp``), built with ``g++`` at first use
into ``_build/`` and bound with ctypes. ``emd2_exact_torch`` is the
transport's ``exact`` solver: the solve runs on the host by design.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels


def _lib():
    lib = _kernels.load("network_simplex")
    fn = lib.shwd_emd_exact
    if fn.argtypes is None:
        dp = ctypes.POINTER(ctypes.c_double)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
    return fn


def emd2_exact(cost: np.ndarray, a: np.ndarray | None = None,
               b: np.ndarray | None = None, return_plan: bool = False,
               max_pivots: int = 0):
    """<P*, C> for one dense (n, m) cost matrix; uniform marginals by
    default. With ``return_plan`` returns (value, plan)."""
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    if a is None:
        a = np.full(n, 1.0 / n)
    if b is None:
        b = np.full(m, 1.0 / m)
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)

    # uniform marginals with n == m reduce to an assignment problem
    # (Birkhoff); scipy's Jonker-Volgenant solver is the fast path there
    if n == m and np.allclose(a, 1.0 / n) and np.allclose(b, 1.0 / m):
        from scipy.optimize import linear_sum_assignment
        r, c = linear_sum_assignment(cost)
        val = float(cost[r, c].mean())
        if not return_plan:
            return val
        plan = np.zeros((n, m), np.float64)
        plan[r, c] = 1.0 / n
        return val, plan

    fn = _lib()
    out = ctypes.c_double(0.0)
    plan = np.zeros((n, m), np.float64) if return_plan else None
    dptr = ctypes.POINTER(ctypes.c_double)
    rc = fn(
        n, m, a.ctypes.data_as(dptr), b.ctypes.data_as(dptr),
        cost.ctypes.data_as(dptr),
        plan.ctypes.data_as(dptr) if return_plan else None,
        ctypes.byref(out), max_pivots)
    if rc != 0:
        raise RuntimeError(f"network simplex failed with code {rc}")
    if return_plan:
        return out.value, plan
    return out.value


def emd2_exact_batch(cost: np.ndarray) -> np.ndarray:
    """(B, n, m) costs -> (B,) exact EMDs (host loop; eval-only tool)."""
    return np.array([emd2_exact(c) for c in np.asarray(cost)])


def w2_exact(x: np.ndarray, y: np.ndarray) -> float:
    """Exact W2 between two clouds: EMD on the squared-distance matrix,
    then sqrt."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    c = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(max(emd2_exact(c), 0.0)))


class _EMD2Exact(torch.autograd.Function):
    """Exact <P*, C> per batch item on the host; the gradient with
    respect to the cost is the optimal plan."""

    @staticmethod
    def forward(ctx, cost):
        host = cost.detach().to("cpu", torch.float64).numpy()
        vals = np.zeros(host.shape[0], np.float32)
        plans = np.zeros(host.shape, np.float32)
        for i, c in enumerate(host):
            vals[i], plans[i] = emd2_exact(c, return_plan=True)
        ctx.save_for_backward(torch.from_numpy(plans).to(cost.device))
        return torch.from_numpy(vals).to(cost.device)

    @staticmethod
    def backward(ctx, g):
        (plans,) = ctx.saved_tensors
        return g[:, None, None] * plans


def emd2_exact_torch(cost: torch.Tensor) -> torch.Tensor:
    """Exact <P*, C> for each (n, m) cost of a (B, n, m) batch, (B,) f32,
    differentiable with respect to the cost (the gradient is the plan, by
    the envelope theorem). The cost is copied to the host, solved there
    (scipy's assignment for uniform n == m, else the network simplex) and
    the values and plans are copied back to the cost's device: the
    solver's semantics, as ``pure_callback`` is in the JAX package."""
    return _EMD2Exact.apply(cost)
