"""Kernel probes: each hand-written kernel called directly, after the
window, at the cell's shapes on the window's last inputs, and timed
between CUDA events over many launches. A probe returns the kernel's
share of its least time (``yardstick``) in percent.

The probes call some of the program's private functions
(``_fused_forward``, ``auction._sinkhorn_warm_prices``,
``auction._hybrid_eps0``); each is looked up when its probe is made, and
a traced run in which one is gone fails (``harness.MissingReading``).
"""

from __future__ import annotations

import importlib

import torch

from . import yardstick
from .harness import MissingReading

LAUNCHES = 20


def program_function(module: str, name: str):
    """``shwd_torch.<module>.<name>``, or ``MissingReading``."""
    try:
        return getattr(importlib.import_module(f"shwd_torch.{module}"), name)
    except (ImportError, AttributeError) as err:
        raise MissingReading(f"a kernel probe found no shwd_torch.{module}.{name}: {err}")


def seconds_per_call(fn, launches: int = LAUNCHES) -> float:
    """Mean seconds of one ``fn()`` over ``launches`` back-to-back calls,
    after two warm calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / launches


def share(counts, seconds: float) -> float:
    """The least time of ``counts`` (bytes, ops, transcendentals) over the
    measured seconds, in percent."""
    return 100.0 * yardstick.bound_s(*counts) / seconds


def k3_probe(x: torch.Tensor, y: torch.Tensor, transport: dict):
    """K3 (``sinkhorn_points``) on clouds x (B, N, 3), y (B, M, 3)."""
    fused_forward = program_function("ops.sinkhorn_fused", "_fused_forward")

    def probe():
        args = (x.contiguous(), y.contiguous(), "lp", 2.0, transport["eps"],
                transport["num_iters"], transport["num_scales"])
        t = seconds_per_call(lambda: fused_forward(*args))
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        return share(yardstick.k3_counts(b, n, m, transport["num_iters"],
                                         transport["num_scales"]), t)
    return probe


def flow_probes(points: torch.Tensor, target: torch.Tensor, flow: dict) -> dict:
    """K1 (``emd2_warmup``) and K2 (``auction_assignment``, seeded from
    K1's duals as a cold hybrid solve is) on the cost between two (N, 3)
    clouds."""
    cost_matrix = program_function("ops.costs", "cost_matrix")
    emd2_warmup = program_function("ops.sinkhorn_kernels", "emd2_warmup")
    warm_prices = program_function("ops.auction", "_sinkhorn_warm_prices")
    eps0 = program_function("ops.auction", "_hybrid_eps0")
    auction_assignment = program_function("ops.auction", "auction_assignment")

    def cost():
        return cost_matrix(points[None], target[None], "lp", 2.0).contiguous()

    def k1():
        c = cost()
        kw = dict(eps=flow["shwd_eps"], num_iters=flow["hybrid_warmup_iters"],
                  num_scales=flow["hybrid_warmup_scales"])
        t = seconds_per_call(lambda: emd2_warmup(c, **kw))
        return share(yardstick.k1_counts(1, c.shape[1], c.shape[2], kw["num_iters"],
                                         kw["num_scales"]), t)

    def k2():
        c = cost()
        prices = warm_prices(c, flow["shwd_eps"], flow["hybrid_warmup_iters"],
                             flow["hybrid_warmup_scales"])
        kw = dict(max_sweeps=4000, prices0=prices.contiguous(), eps0=eps0(c, 1e-7))
        t = seconds_per_call(lambda: auction_assignment(c, 1e-7, **kw))
        return share(yardstick.k2_counts(1, c.shape[1]), t)

    return {"k1": k1, "k2": k2}
