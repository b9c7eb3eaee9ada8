"""Analytic FLOP models for the headline workloads (MFU accounting).

A copy of ``shwd_tpu/utils/flops.py`` (pure Python; the port imports
nothing of the JAX package). A counter of executed ops sees only part of
a step: ``utils.profiling.counted_flops`` counts matmul-class ops and
nothing inside the hand-written kernels, and XLA's cost analysis counts
each op inside a loop once. These hand models count the dominant dense
work with explicit loop counts instead, the way transformer MFU counts 6ND
and nothing else.

Conventions:
- 1 multiply-add = 2 FLOPs; transcendentals (exp, atan2) = 1 FLOP.
- sort compare-exchanges counted as 1 FLOP each over the bitonic stage count
  log2(n)*(log2(n)+1)/2 — sorts are real work on this workload and skipping
  them would overstate MFU.
- backward  = 2x forward for every differentiated subgraph (the standard
  model-FLOPs convention); stop-gradient regions (Sinkhorn dual warm-up,
  auction) are counted forward-only.
- auction sweep counts are data-dependent (lax.while_loop); callers pass a
  typical measured value (``auction_sweeps``). Reference anchor for what is
  being counted: the reference's per-item CPU loop at
  ``losses/s2_wasserstein.py:211-262``.
"""

from __future__ import annotations

import math

_POINTNET_WIDTHS = (3, 64, 64, 64, 128, 1024)
_PCR_HEAD_WIDTHS = (2048, 1024, 1024, 512, 512, 256, 7)


def mlp_flops(n_items: float, widths) -> float:
    """Dense chain applied per item: 2 * n * sum(c_in * c_out)."""
    return 2.0 * n_items * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def pcrnet_forward_flops(B: int, N: int, iterations: int) -> float:
    """PCRNet fwd: template encoded once, source re-encoded per iteration,
    pose head per iteration (models/pcrnet.py)."""
    enc = mlp_flops(B * N, _POINTNET_WIDTHS)
    head = mlp_flops(B, _PCR_HEAD_WIDTHS)
    return enc + iterations * (enc + head)


def residual_flow_forward_flops(B: int, N: int, layers: int,
                                hidden: int = 8, depth: int = 6,
                                d: int = 3) -> float:
    """Residual flow phi fwd on B*N points: LipschitzMLP [d, hidden x depth, d]
    per layer (flows/residual.py:85)."""
    widths = (d,) + (hidden,) * depth + (d,)
    return layers * mlp_flops(B * N, widths)


def cost_matrix_flops(B: int, N: int, M: int, d: int = 3) -> float:
    """Dense Lp/cosine/geodesic cost matrix: ~2 FLOPs per dim per entry plus
    the pointwise transform (losses/transport.py)."""
    return B * N * M * (2.0 * d + 2.0)


def sinkhorn_flops(B: int, N: int, M: int, total_iters: int) -> float:
    """Log-domain Sinkhorn: 2 logsumexp passes over (B, N, M) per iteration
    (~4 FLOPs/entry each: add f+g, exp, accumulate) (ops/sinkhorn.py)."""
    return total_iters * 8.0 * B * N * M


def auction_flops(B: int, N: int, M: int, sweeps: int) -> float:
    """Jacobi auction sweep: best/second-best scan over the (B, N, M) value
    matrix + bid scatter, ~4 FLOPs/entry (ops/auction.py:34-93)."""
    return sweeps * 4.0 * B * N * M


def sort_flops(rows: float, n: int) -> float:
    """Bitonic sort network: n * log2(n)(log2(n)+1)/2 compare-exchanges."""
    lg = math.ceil(math.log2(max(n, 2)))
    return rows * n * lg * (lg + 1) / 2.0


def ssw_cost_flops(B: int, L: int, N: int, M: int, p: float = 2.0) -> float:
    """Spherical sliced-W: projection einsum + angle + per-(B, L) circle OT
    (ops/spherical.py + ops/ot1d.py). Equal sizes assumed for the p=2 path."""
    P = B * L
    proj = 2.0 * 6.0 * B * L * (N + M)          # (3,2) frame contraction x2 clouds
    angles = 10.0 * B * L * (N + M)             # norm + atan2
    sorts = sort_flops(P, N) + sort_flops(P, M)
    if p == 1:
        # level-median closed form: pair-sort of 2n + cumsum + median sort
        solver = 2.0 * sort_flops(P, N + M) + 8.0 * P * (N + M)
    else:
        # DFT-matmul correlation: 6 (B*L, n) @ (n, n/2+1)-class matmuls,
        # window select (~2*33 FLOPs/elem), cumsums
        nf = N // 2 + 1
        solver = 12.0 * P * N * nf + 66.0 * P * N + 12.0 * P * N
    return proj + angles + sorts + solver


def shwd_loss_eval_flops(B: int, N: int, M: int, *, layers: int,
                         solver: str, num_projections: int = 100,
                         sink_iters: int = 0, sink_scales: int = 1,
                         auction_sweeps: int = 0, p: float = 2.0,
                         with_grad: bool = True) -> float:
    """One SHWD loss evaluation: phi on both clouds + transport cost.

    ``with_grad`` applies the 3x fwd+bwd multiplier to the differentiated
    subgraph (phi, cost matrix / SSW); the dual warm-up and auction run under
    stop_gradient and count forward-only.
    """
    g = 3.0 if with_grad else 1.0
    flow = (residual_flow_forward_flops(B, N, layers)
            + residual_flow_forward_flops(B, M, layers))
    if solver == "ssw":
        return g * (flow + ssw_cost_flops(B, num_projections, N, M, p=p))
    total = g * (flow + cost_matrix_flops(B, N, M))
    if solver in ("hybrid", "auction"):
        total += sinkhorn_flops(B, N, M, sink_iters * sink_scales)
        total += auction_flops(B, N, M, auction_sweeps)
    elif solver.startswith("sinkhorn"):
        # unrolled fori duals are differentiated through
        total += g * sinkhorn_flops(B, N, M, sink_iters * sink_scales)
    return total


def flow_step_flops(n_points: int, *, layers: int = 5, solver: str = "hybrid",
                    max_iter: int = 1, sink_iters: int = 40,
                    sink_scales: int = 8, auction_sweeps: int = 128,
                    num_projections: int = 100) -> float:
    """One SHWD gradient-flow step (bench.py workload): max_iter inner
    adversarial evals (grad wrt phi) + one final eval (grad wrt points)."""
    per_eval = shwd_loss_eval_flops(
        1, n_points, n_points, layers=layers, solver=solver,
        num_projections=num_projections, sink_iters=sink_iters,
        sink_scales=sink_scales, auction_sweeps=auction_sweeps)
    return (max_iter + 1) * per_eval


def wcos_train_step_flops(B: int, N: int, *, pcr_iterations: int,
                          layers: int, solver: str,
                          num_projections: int = 100,
                          sink_iters: int = 100, sink_scales: int = 8,
                          auction_sweeps: int = 128,
                          max_iter: int = 1) -> float:
    """One W_COS registration train step (throughput_1chip rows): PCRNet
    fwd+bwd + (max_iter + 1) SHWD loss evals."""
    model = 3.0 * pcrnet_forward_flops(B, N, pcr_iterations)
    loss = (max_iter + 1) * shwd_loss_eval_flops(
        B, N, N, layers=layers, solver=solver,
        num_projections=num_projections, sink_iters=sink_iters,
        sink_scales=sink_scales, auction_sweeps=auction_sweeps)
    return model + loss
