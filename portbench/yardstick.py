"""The benchmark's arithmetic: the card's peaks, each kernel's least time,
and the model FLOPs of a step.

Frozen here so that a change to the program cannot move the yardstick.
Every count is a function of the cell's shapes and iteration counts
alone.

Peaks of one NVIDIA H100 SXM (data sheet, 700 W): HBM3 at 3.35 TB/s,
float32 outside the tensor cores at 67 TFLOP/s (the port computes in f32
with TF32 off, so this is the MFU denominator, not the 989 TFLOP/s of
bf16), and the special-function units at 16 results per clock per SM,
132 SMs at 1.98 GHz, for exps and logs.

FLOP conventions (as the program's ``utils/flops.py``, with two terms
fixed): a multiply-add is 2 FLOPs; a differentiated subgraph costs 3x its
forward; the Sinkhorn duals count forward only, because the port takes the
envelope gradient and never differentiates through them; auction sweeps
are a number fixed per cell in its configuration file.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

POINTNET_WIDTHS = (3, 64, 64, 64, 128, 1024)
PCR_HEAD_WIDTHS = (2048, 1024, 1024, 512, 512, 256, 7)


# -- a kernel's least time -----------------------------------------------------

def bound_s(bytes_moved: float, ops: float, transcendentals: float = 0.0) -> float:
    """The least seconds the card could take: each input byte read once and
    each output byte written once at the HBM rate, against the f32
    operations at the f32 rate and the exps and logs at the
    special-function rate; the largest of the three."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S,
               transcendentals / SFU_OPS_PER_S)


def k1_counts(b: int, n: int, m: int, iters: int, scales: int):
    """(bytes, f32 ops, transcendentals) of one ``emd2_warmup`` call:
    annealed log-Sinkhorn duals of a (b, n, m) cost. Per entry and
    half-iteration: sub, fma (2), exp, compare, add = 6 ops and one exp;
    the max|C| pass (1 op) and the value pass (6 ops, 1 exp); one log per
    row and per column each iteration. The cost is read once, the value
    and the two potentials written once."""
    entries = b * n * m
    sweeps = iters * scales
    ops = 2 * sweeps * entries * 6 + entries * 7
    transcendentals = 2 * sweeps * entries + entries + sweeps * (b * n + b * m)
    bytes_moved = entries * 4 + (b + b * n + b * m) * 4
    return bytes_moved, ops, transcendentals


def k2_counts(b: int, n: int):
    """(bytes, ops, transcendentals) of one ``auction_assignment`` solve:
    the bytes of its (b, n, n) f32 cost alone. Its sweeps depend on the
    data and on the implementation, so they are not counted: no
    implementation can move this count."""
    return b * n * n * 4, 0.0, 0.0


def k3_counts(b: int, n: int, m: int, iters: int, scales: int):
    """(bytes, ops, transcendentals) of one ``sinkhorn_points`` call: the
    cost tile built from the clouds plus annealed log-Sinkhorn. Per entry
    and half-iteration 6 ops and one exp; the cost build (8), one division
    per temperature, the value pass (7 ops, 1 exp); one log per row and per
    column each iteration. The clouds are read once, the value and the two
    potentials written once."""
    entries = b * n * m
    sweeps = iters * scales
    ops = entries * (2 * sweeps * 6 + 8 + scales + 7)
    transcendentals = entries * (2 * sweeps + 1) + sweeps * (b * n + b * m)
    bytes_moved = (b * n * 3 + b * m * 3) * 4 + (b + b * n + b * m) * 4
    return bytes_moved, ops, transcendentals


# -- model FLOPs ---------------------------------------------------------------

def mlp_flops(items: float, widths) -> float:
    """A dense chain applied per item: 2 * items * sum(c_in * c_out)."""
    return 2.0 * items * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def pcrnet_forward_flops(b: int, n: int, iterations: int) -> float:
    """PCRNet's forward: the template encoded once, the source re-encoded
    each pose iteration, the pose head each iteration."""
    enc = mlp_flops(b * n, POINTNET_WIDTHS)
    return enc + iterations * (enc + mlp_flops(b, PCR_HEAD_WIDTHS))


def phi_forward_flops(points: float, blocks: int, hidden: int = 8,
                      depth: int = 6, d: int = 3) -> float:
    """The residual flow phi on ``points`` points: ``blocks`` Lipschitz MLPs
    [d, hidden x depth, d]."""
    return blocks * mlp_flops(points, (d,) + (hidden,) * depth + (d,))


def cost_flops(b: int, n: int, m: int, d: int = 3) -> float:
    """A dense Lp (p=2) cost: 2 FLOPs per dimension per entry plus 2."""
    return b * n * m * (2.0 * d + 2.0)


def sinkhorn_flops(b: int, n: int, m: int, iterations: int) -> float:
    """Log-domain Sinkhorn: two log-sum-exp passes over (b, n, m) per
    iteration, ~4 FLOPs an entry each."""
    return iterations * 8.0 * b * n * m


def auction_flops(b: int, n: int, sweeps: int) -> float:
    """Auction sweeps: a best and second-best scan of the (b, n, n) values
    per sweep, ~4 FLOPs an entry."""
    return sweeps * 4.0 * b * n * n


def wcos_eval_flops(b: int, n: int, m: int, blocks: int, iterations: int,
                    with_grad: bool) -> float:
    """One SHWD loss evaluation on the ``sinkhorn`` solver: phi on both
    clouds and the cost (3x when differentiated), the duals forward only."""
    g = 3.0 if with_grad else 1.0
    diff = phi_forward_flops(b * (n + m), blocks) + cost_flops(b, n, m)
    return g * diff + sinkhorn_flops(b, n, m, iterations)


def wcos_train_step_flops(b: int, n: int, *, pose_iterations: int, blocks: int,
                          sinkhorn_iterations: int, inner_steps: int) -> float:
    """One train step: PCRNet forward and backward, ``inner_steps``
    differentiated evaluations for phi's ascent and one for the model."""
    model = 3.0 * pcrnet_forward_flops(b, n, pose_iterations)
    loss = (inner_steps + 1) * wcos_eval_flops(b, n, n, blocks,
                                               sinkhorn_iterations, True)
    return model + loss


def wcos_val_batch_flops(b: int, n: int, *, pose_iterations: int, blocks: int,
                         sinkhorn_iterations: int) -> float:
    """One validation batch: PCRNet forward and one loss evaluation."""
    return (pcrnet_forward_flops(b, n, pose_iterations)
            + wcos_eval_flops(b, n, n, blocks, sinkhorn_iterations, False))


def flow_step_flops(n: int, *, blocks: int, inner_steps: int, dual_iterations: int,
                    auction_sweeps: int) -> float:
    """One SHWD/hybrid flow step: each of ``inner_steps`` ascent solves and
    the final solve differentiates phi and the cost and runs an auction of
    ``auction_sweeps`` sweeps; the first solve of a step is cold and also
    computes the annealed duals (the later ones restart warm)."""
    per_solve = (3.0 * (phi_forward_flops(2 * n, blocks) + cost_flops(1, n, n))
                 + auction_flops(1, n, auction_sweeps))
    return (inner_steps + 1) * per_solve + sinkhorn_flops(1, n, n, dual_iterations)
