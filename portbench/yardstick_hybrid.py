"""The model FLOPs of the ``pcrnet_wcos_hybrid`` cell's steps, frozen here
beside ``yardstick.py``, whose conventions they keep: a multiply-add is 2
FLOPs, a differentiated subgraph costs 3x its forward, and the Sinkhorn
passes count forward only.

A train step of the hybrid solver differs from the ``sinkhorn`` one in its
transport: no K3; phi's inner solve is cold, so it runs the annealed
Sinkhorn warm-up (two log-sum-exp passes over the (B, N, N) cost an
iteration) before the auction; the final solve restarts warm from it and
runs no warm-up. A validation batch's solve is cold. The auction's sweeps
depend on the data and on the implementation, so, as for K2's roofline,
they are not counted.
"""

from __future__ import annotations

from .yardstick import cost_flops, pcrnet_forward_flops, phi_forward_flops, sinkhorn_flops


def hybrid_eval_flops(b: int, n: int, blocks: int, with_grad: bool) -> float:
    """phi on both clouds and the cost of one solve (3x when
    differentiated), without the transport."""
    g = 3.0 if with_grad else 1.0
    return g * (phi_forward_flops(b * 2 * n, blocks) + cost_flops(b, n, n))


def hybrid_train_step_flops(b: int, n: int, *, pose_iterations: int, blocks: int,
                            warmup_iterations: int, inner_steps: int) -> float:
    """One train step: PCRNet forward and backward, ``inner_steps``
    differentiated evaluations for phi's ascent and one for the model, and
    one warm-up of ``warmup_iterations`` Sinkhorn iterations (the first,
    cold, solve)."""
    model = 3.0 * pcrnet_forward_flops(b, n, pose_iterations)
    loss = (inner_steps + 1) * hybrid_eval_flops(b, n, blocks, True)
    return model + loss + sinkhorn_flops(b, n, n, warmup_iterations)


def hybrid_val_batch_flops(b: int, n: int, *, pose_iterations: int, blocks: int,
                           warmup_iterations: int) -> float:
    """One validation batch: PCRNet forward and one cold solve's
    evaluation with its warm-up."""
    return (pcrnet_forward_flops(b, n, pose_iterations)
            + hybrid_eval_flops(b, n, blocks, False)
            + sinkhorn_flops(b, n, n, warmup_iterations))
