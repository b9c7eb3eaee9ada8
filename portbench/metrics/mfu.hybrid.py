"""mfu.hybrid: model FLOPs done in the window (``portbench.yardstick_hybrid``:
PCRNet and phi as ``yardstick`` counts them, and the cold solves' Sinkhorn
warm-up; the auction's sweeps are not counted) over the window's seconds, as
a percentage of the H100's float32 peak (67 TFLOP/s: the port computes in
f32 with TF32 off)."""

from portbench.yardstick import F32_FLOPS_PER_S

COUNT = "train_steps"


def read(run):
    if not run.counts.get(COUNT):
        return None
    return 100.0 * run.model_flops / run.window_s / F32_FLOPS_PER_S
