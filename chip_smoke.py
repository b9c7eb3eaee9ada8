#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (shwd_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: nvcc for every kernel source in shwd_torch/csrc, in parallel;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at every shape the main paths give it and a ragged/batched one,
     with timings: the Sinkhorn warm-up (K1: the flow's 1x1200x1200, with
     the time of its bare chain of exchanges between blocks), the auction
     (K2: the flow's 1x1200 from K1's prices, at cluster sizes 1 and 16,
     and the registration trainer's 128x128x128 both from the Sinkhorn
     warm-up and seeded with the previous solve's matching; the flow's
     seeded solve is checked after the flow of phase 4, on the inputs of
     its last launch), the fused point-cloud Sinkhorn with its gradient
     (K3: its register route at the train batch 128x128x128 and the eval
     batch 51x128x128, a ragged batch in every cost kind and a tiny one,
     its general route at 3x100x130 in every cost kind; the general route
     timed beside the register route), the tiled Chamfer (K4: the flow's
     eval metric, 1x1200x1200, with the launch floor of its one
     cooperative launch), phi's residual-chain kernels (the forward, the
     backward to x and to the parameters with their reduction, 1 and 200
     power-iteration rounds, against the module path at the flow's 2400
     points through 5 blocks and the train steps' 32768 and 8192 through
     3, with the forward's launch floor and the module path's eager ms),
     the small-problem warm-up (csrc/sinkhorn_warm.cu: emd2_approx's
     potentials at the registration trainer's 128x128x128, at the
     benchmark cell's last validation batch 25x128x128 and this script's
     51, and a ragged 3x100x120, against emd2_approx on the card, timed
     beside it at 128 and 25);
     K1, K3, K4, phi's kernels and the small-problem warm-up must give the
     same bits on two calls;
  4. slice 1: the Flow_cube SHWD gradient flow through
     shwd_torch.train.flow_driver.run_flow (1200 points, 5 Residual
     layers, hybrid exact-EMD solver, 400 iterations), fused: one step
     captured as a CUDA graph and replayed (K1 once and K2 twice a step,
     counted as graph nodes times replays), with the kernels' launch
     counters reset just before and read just after; final exact W2 must
     be <= 1e-3, and 50 iterations of the per-step loop from the same
     start must give the fused run's points at iteration 50; ms/iter of
     both, the graph's kernel nodes and the idle share of one replayed
     step; and the Adam isolation: three steps of the capturable and the
     host-side Adam in ulps, where the per-step trajectories of the two
     part over 50 iterations, and the final W2 of 400 per-step iterations
     with host-side Adams. It runs right after the build, before any kernel
     is loaded: its first interval shows that run_flow loads the kernels
     and warms up outside its timed window. Then a 20-iteration run of the
     same flow with eval_metric="cd", which records the tiled Chamfer (K4)
     at every eval; then the 15 other methods of run_flow (the sliced
     zoo, SSW, Chamfer, entropic W2) at the same width, 400 iterations
     each, W2 every 50, held to the JAX package's rows in
     benchmarks/results_cube.json (within 3x, and below the start where
     the row ends below it), every method fused, its points at iteration
     50 equal to 50 per-step iterations' (bit for bit for the six methods
     with an inner Adam ascent), and the Chamfer-metric twins of
     SWD, ASWD, SSWD and CD, 100 iterations each on K4; then
     flow_ellipsoid: the ellipsoid_2 row of tools/flow_rows_torch.py (SHWD
     on hybrid from the JAX row's clouds, tools/flow_clouds_jax.npz, N =
     1000, 1000 iterations, the point lr cosine-decayed to 0.1x: a device
     tensor filled between replays), fused: final W2 <= 1e-3, 50 per-step
     iterations under the same schedule giving the fused run's points at
     iteration 50, K1/K2 as graph nodes x (replays + warm-up); and the
     SWD twin with the Chamfer metric, 100 iterations on K4;
  5. slice 2: the W_COS registration trainer, shwd_torch.train.Trainer.fit
     at B=128, N=M=128, full-width PCRNet, 3 Residual layers, on the
     procedural shape bank, fused (fused_epoch, the default: the train
     step and each eval batch shape captured as CUDA graphs and replayed):
     40 epochs with solver="sinkhorn" (K3 twice per train step, once per
     eval batch, as graph nodes), then 4 epochs each with
     solver="hybrid" (K2, priced cold by the small-problem warm-up) and
     criterion="cd" (the dense differentiable Chamfer, no kernel); counters
     reset before and read after each run,
     where each graph's nodes times its replays and its warm-up run must
     account for every launch;
     losses and errors must be finite, the best checkpoints must load
     back, and over the sinkhorn run the train loss and the validation
     loss must fall and the validation rotation error must end on the
     plateau of about 40 deg that the JAX trainer reaches on this bank;
  5a. registration_learns: the w_cos row of tools/registration_rows_torch.py
     (the JAX package's 2048-shape bank, 12 train steps an epoch, its exact
     knobs), seed 0, 150 epochs, fused: the best validation rotation error
     must reach 10 deg (the JAX row's curve is at 6.6 deg by epoch 100),
     the last quarter's translation error stay under 0.02, and evaluate on
     the test split at best_rot_error_snap be finite and below epoch 1's
     error; K3 counted as graph nodes x replays plus the warm-ups; the
     curve every 10 epochs, ms per train step, s per epoch, peak memory;
  5b. registration_outliers: the robust_outliers_10 row (10 points of
     every source replaced by N(0, 1) draws), seed 0, 20 epochs, fused:
     finite, the validation rotation error below epoch 1's, K3 counted;
  5c. jax_init: the JAX package's seed-1234 initial states
     (tools/init_states_jax.npz) loaded on the card through the row
     harness's loader: PCRNet's pose on the file's check batch within
     rtol 1e-4 / atol 1e-5 of the JAX package's, each criterion's value
     within rtol 1e-4 (w_cos and pseudo_w_cos through K3, against the JAX
     package's fused kernel in interpret mode on the CPU, K3 counted:
     once for w_cos, once per frozen flow of pseudo_w_cos; max_ssw and
     w_cos on ssw with the JAX call's frames); then 2 epochs of w_cos
     fitted from that state (an epoch-0 checkpoint) on the 256-shape bank,
     fused: every metric finite, K3 counted;
  5d. replay: the w_cos row's config on the 256-shape bank, seed 0, 2
     epochs on the per-step path, recorded by the row harness's
     FitRecorder (the start state, every batch and draw of epochs 0-1),
     beside the same fit unrecorded: both histories equal bit for bit;
     then the port's replay of the record on the card (replay_port, the
     recorded batches handed in): its history equal bit for bit; K3 twice
     per train step and once per eval batch in each of the three;
  6. evaluate: shwd_torch.train.evaluate.evaluate on the sinkhorn run's
     best-rotation checkpoint, the test split, on the card by default;
     both success curves non-decreasing to 1.0, five thresholds recounted
     one full pass each equal to the one-pass curve, and the final state
     giving the same per-sample errors, bit for bit, from memory and from
     a checkpoint reloaded into a fresh state;
  6a. the parallel layer at world size 1 over NCCL (data_parallel): the
     sinkhorn run's config with mesh_data=1 for 4 epochs, fused (the
     step's NCCL collectives captured with it), whose history must equal
     that run's first 4 epochs bit for bit, K3 and the collectives counted
     as graph nodes x replays; ms per train step of fused fits with and
     without the mesh, in turns; the collectives of one eager train step;
     the sharded SSW, transport and distributed SSW
     against their unsharded values, sharded refinement (sinkhorn, K3)
     against refine_poses, and the scaling harness at one card; then the
     sweep runner (sweep: a zip matrix of two 2-epoch experiments in
     process, sinkhorn on K3 and hybrid on K2, one in a child process
     pinned with CUDA_VISIBLE_DEVICES=0, and run_eval_sweep over the
     three, every eval_summary.json finite) and the HPO study (hpo: three
     2-epoch cd trials stored in jsonl, replayed by a re-created study
     that runs a fourth; the cd criterion launches no kernel);
  6b. pose refinement: the sinkhorn run's best-rotation PCRNet on the
     first train batch, polished by refine_model_output with the
     "sinkhorn" loss (K3 once per step and once for the final loss), "cd"
     and "ssw", 100 steps each, fused (the step and the final objective
     captured at the first call and replayed from the cache), then
     per-step and fused calls in turns, all bit for bit the same, K3
     counted exactly on each: the objective falls, the median rotation
     error does not rise;
  7. the criteria of the SSW family, each a Trainer.fit at full width with
     the counts reset before and read after: pseudo_w_cos (two frozen
     Residual flows, max, TrainConfig's default transport: K3 once per
     flow per criterion call, checked on the count and on the profiled
     step's timeline), max_ssw (mlp chart, 512 projections, one ascent
     step, p = 1; its clouds must lie on S^2), 10 epochs each, whose
     validation rotation error must end below epoch 1's; and w_cos on the
     ssw solver (geodesic, p = 2, 100 projections) at N=M=1024, 3 epochs;
     each with its ms per step, device launches and busy ms of one
     profiled step, and peak memory; then sinkhorn_div_1024: 2 epochs of
     the w_cos_1024_sinkhorn_div row's config (B=128, N=M=1024, the plain
     Sinkhorn divergence) on a 256-shape bank, whose peak memory must be
     under a tenth of what its dual iterations would hold if autograd
     recorded them; and fit_memory: two short w_cos fits in one process,
     whose allocated bytes (held and after del) and peaks must agree
     within 2 MiB;
  7a. fused against per-step (fused_vs_per_step): for w_cos/sinkhorn,
     w_cos/hybrid, cd and pseudo_w_cos, 5-epoch fits with fused_epoch
     False and True in turns, each held to the fused run's first 4 epochs
     (rtol 1e-4), ms per train step of each path with quartiles, the
     train graph's kernel nodes and the idle share of one replayed step;
  7b. the metric sweeps on the 64 test shapes: rotation 0-90 deg (W
     rises with the angle) and translation 0-1 (W rises, within 10 % of
     the magnitude);
  8. launches per call: one call of each wrapper captured in a CUDA graph,
     whose nodes must be exactly one kernel (K1-K4, phi's forward), and for
     the small-problem warm-up one kernel besides its temperatures' nodes;
then the kernel table ({"kernels": [...]}; "launches" counts the kernel's
launches on the main path, each wrapper call once and, on a fused path, each
graph replay once per node of that kernel; "launches_pseudo" and
"launches_refine" K3's on
the pseudo_w_cos run and the sinkhorn refinement, "launches_learns" K3's
in phase registration_learns, "launches_data_parallel"
K3's in phase data_parallel, "launches_sweep" K3's and K2's in the sweep,
"launches_cd_twins" K4's
on the twins, "launches_ellipsoid" K1's and K2's and "launches_ellipsoid_cd"
K4's in phase flow_ellipsoid, "launches_outliers" K3's in phase
registration_outliers, "launches_jax_init" K3's in phase jax_init's fit,
"launches_replay" K3's in phase replay's replay of the record, the
small-problem warm-up's "launches" its own in the hybrid run of phase 5,
"launches_per_call" is phase 8's count), a
"phase_seconds" line after each phase added in slice 11, the
nvidia-smi line, and a last line {"ok": true, "device": {...}}. Any failure raises: the script
exits non-zero and prints no result. Without CUDA, or without the
shwd_torch package beside it, it exits non-zero before printing anything.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12        # f32 outside the tensor cores
# special-function units (exp2, log2): 16 results per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs, 1980 MHz boost (H100 SXM data sheet)
H100_SFU_OPS_PER_S = 16 * 132 * 1.98e9
FLOW_N = 1200
EPS_FINAL = 1e-7
REG_B, REG_N = 128, 128
REG_SHAPES, REG_VAL = 256, 51     # the bank, and its 20 % validation split
REG_SINK = dict(eps=5e-3, num_iters=50, num_scales=4)
CELL_VAL_TAIL = 25                # the benchmark's hybrid cell: 409 validation shapes, 3 x 128 + 25
REG_EPOCHS = {"sinkhorn": 40, "hybrid": 4, "cd": 4, "pseudo": 10, "max_ssw": 10,
              "ssw_1024": 3, "data_parallel": 4, "data_parallel_ab": 9, "sweep": 2,
              "hpo": 2, "turns": 5, "outliers": 20, "sinkhorn_div": 2, "fit_memory": 2,
              "replay": 2}
HELD_EPOCHS = 4                   # the per-step fits are held to the fused runs' first 4
SSW_N = 1024                      # the w_cos_1024_ssw row's clouds
# Of the seeds 0, 1, 2 and 1234 on an H100, the first three bring the model
# within 40 epochs to the plateau the JAX trainer reaches on the same bank
# (tests/compare_registration_curves.py): it has learnt to leave the source
# where it is, so the rotation error is the mean pose angle, about 40 deg,
# and the translation error falls below 0.01. Seed 1234 settles in a state
# turned by about 160 deg, at a higher loss.
REG_SEED = 0
REG_PLATEAU_DEG = 50.0
# Phase registration_learns: the w_cos row of tools/registration_rows_torch.py
# (the JAX package's 2048-shape bank, 12 train steps an epoch), seed
# REG_SEED, cut to LEARN_EPOCHS; the JAX row's curve is at 6.6 deg by
# epoch 100.
LEARN_EPOCHS = 150
LEARN_ROT_DEG = 10.0              # best validation rotation error
LEARN_TRANS = 0.02                # last-quarter mean validation translation error
# Phase jax_init: the card against the JAX package's values on the CPU
# (f32 products in another order; K3 against the kernel's interpret mode)
JAX_INIT_POSE_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_INIT_VALUE_TOL = dict(rtol=1e-4, atol=0.0)
JAX_INIT_EPOCHS = 2
# phi's residual-chain kernels in an SHWD step graph: the inner pass forward,
# its backward with the parameters' partials and their reduction, the power
# iteration; the final pass forward and its dL/dx
PHI_NODES = {"residual_chain_forward": 2, "residual_chain_backward": 2,
             "residual_chain_grad_reduce": 1, "residual_chain_power_iteration": 1}
# phi at the cells' shapes: the flow's 2 x 1200 points through 5 blocks, the
# train steps' pass over both clouds of 128 and 32 items of 128 points
# through 3
PHI_SHAPES = {"flow_2400x3_5_blocks": (2400, 5), "train_b128_32768x3_3_blocks": (32768, 3),
              "train_b32_8192x3_3_blocks": (8192, 3)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 1, ahead: bool = False) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events). ``ahead``
    keeps the card busy for about 2 ms before the first event, so the host
    has queued all of ``fn`` by then and the time is the device's alone
    (for kernels shorter than the host's own work per call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn) -> list[tuple[str, float]]:
    """(name, device ms) of each CUDA kernel one call of ``fn`` launches,
    read from the device's timeline (torch.profiler); plain copies and
    fills are left out. ``fn`` runs once before, so nothing is built
    inside."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(ev.name, ev.time_range.elapsed_us() / 1e3) for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and "#" not in ev.name
            and not ev.name.startswith(("Memcpy", "Memset"))]


def quartiles(values) -> list[float]:
    return [float(q) for q in np.percentile(np.asarray(values, dtype=float), [25, 50, 75])]


def graph_launches(graphs: list[dict], kernel: str) -> int:
    """The launches of ``kernel`` that a fit's or a flow's step graphs made:
    its nodes in each graph times (replays + the one eager warm-up run)."""
    return sum(g["nodes_by_kernel"].get(kernel, 0) * (g["replays"] + 1) for g in graphs)


def replay_profile(graph, args=(), reps: int = 20) -> dict:
    """One captured step replayed: host ms per replay (issued and waited
    for, the median of ``reps``), the device's ms per replay between two
    CUDA events (the graph's span on the stream, gaps between its nodes
    included), and the kernels torch.profiler records for one replay with
    their summed device ms (on the card the profiler at times records
    none after a capture: then ``traced_kernels`` is 0 and the events'
    span stands in for the busy time, which makes the idle share a lower
    bound)."""
    graph(*args)
    torch.cuda.synchronize()
    walls, spans = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        graph(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph(*args)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    kernels = device_kernels(lambda: graph(*args))
    traced = sum(ms for _, ms in kernels)
    wall, span = statistics.median(walls), statistics.median(spans)
    busy = traced if kernels else span
    return {"host_ms_per_replay": wall, "device_span_ms_per_replay": span,
            "traced_kernels": len(kernels), "traced_busy_ms": traced,
            "kernel_nodes": graph.kernel_nodes, "idle_share_of_replay": 1 - busy / wall,
            "busy_ms": busy}


def bound_ms(bytes_moved: float, ops: float, transcendentals: float = 0.0):
    """The least time the card could take: each input byte read once and
    each output byte written once at the HBM rate, against the f32
    operations at the f32 rate and the transcendentals at the
    special-function rate. Returns (ms, "bytes" or "operations", terms)."""
    terms = {"bytes_ms": bytes_moved / H100_BYTES_PER_S * 1e3,
             "f32_ops_ms": ops / H100_F32_OPS_PER_S * 1e3,
             "transcendentals_ms": transcendentals / H100_SFU_OPS_PER_S * 1e3}
    t_ops = max(terms["f32_ops_ms"], terms["transcendentals_ms"])
    by = "bytes" if terms["bytes_ms"] >= t_ops else "operations"
    return max(terms["bytes_ms"], t_ops), by, terms


def timed(phase, *args):
    """``phase(*args)``, then a line with the seconds it took."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase_seconds": phase.__name__[len("phase_"):],
          "seconds": time.perf_counter() - t0})
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def flow_clouds(device):
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, FLOW_N, device=device)
    tgt = sample_cube_surface(rng, FLOW_N, biased=True, device=device)
    return src, tgt


def lsa_value(c: np.ndarray) -> float:
    from scipy.optimize import linear_sum_assignment
    c = c.astype(np.float64)
    r, k = linear_sum_assignment(c)
    return float(c[r, k].mean())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from shwd_torch import _kernels
    t0 = time.perf_counter()
    _kernels.build_all()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs,
          "libraries": [_kernels.lib_path(n).name for n in _kernels.SOURCES]})


def check_warmup(dev):
    """K1 vs emd2_warmup_reference at the flow shape and a ragged batch."""
    from shwd_torch.ops import sinkhorn_kernels as sk
    from shwd_torch.ops.costs import cost_matrix
    src, tgt = flow_clouds(dev)
    flow_cost = cost_matrix(src[None], tgt[None], "lp", 2.0).contiguous()
    rng = np.random.default_rng(1)
    ragged = cost_matrix(
        torch.as_tensor(rng.normal(size=(2, 300, 3)), dtype=torch.float32, device=dev),
        torch.as_tensor(rng.normal(size=(2, 333, 3)), dtype=torch.float32, device=dev),
        "lp", 2.0).contiguous()
    kw = dict(eps=1e-5, num_iters=40, num_scales=8)
    report = {}
    for name, c in (("flow_1x1200x1200", flow_cost), ("ragged_2x300x333", ragged)):
        v1, f1, g1 = sk.emd2_warmup(c, **kw)
        v2, f2, g2 = sk.emd2_warmup_reference(c, **kw)
        again = sk.emd2_warmup(c, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((v1, f1, g1), again)),
              f"K1 {name}: two calls differ")
        for t in (v1, f1, g1):
            check(bool(torch.isfinite(t).all()), f"K1 {name}: non-finite output")
        val_rel = float(((v1 - v2).abs() / v2.abs()).max())
        f_err = float((f1 - f2).abs().max())
        g_err = float((g1 - g2).abs().max())
        check(val_rel <= 1e-3, f"K1 {name}: val rel err {val_rel}")
        check(f_err <= 1e-4 and g_err <= 1e-4, f"K1 {name}: f/g err {f_err} {g_err}")
        report[name] = {"val_rel_err": val_rel, "f_abs_err": f_err,
                        "g_abs_err": g_err, "layout": sk.warmup_layout(c)}
    ms = time_ms(lambda: sk.emd2_warmup(flow_cost, **kw), ahead=True)
    plain_ms = time_ms(lambda: sk.emd2_warmup_reference(flow_cost, **kw))
    # the chain floor: an iteration is two exchanges across the grid, so a
    # call cannot beat 2 * iterations * scales bare exchanges
    exchanges = 2 * kw["num_iters"] * kw["num_scales"]
    chain_ms = time_ms(lambda: sk.warmup_exchanges(flow_cost, exchanges), ahead=True)
    b, n, m = flow_cost.shape
    entries = b * n * m
    sweeps = kw["num_iters"] * kw["num_scales"]
    # per entry per half-iteration: sub, fma (2), exp, compare, add = 6 ops;
    # plus the max|C| pass (1) and the value pass (sub, add, fma, exp, fma = 6)
    ops = 2 * sweeps * entries * 6 + entries * 7
    # one exp per entry per half-iteration and in the value pass, one log
    # per row and per column each iteration
    transcendentals = 2 * sweeps * entries + entries + sweeps * (b * n + b * m)
    bytes_moved = entries * 4 + (b + b * n + b * m) * 4
    bnd, by, terms = bound_ms(bytes_moved, ops, transcendentals)
    emit({"phase": "kernel_check", "kernel": "emd2_warmup", "checks": report,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
          "bound_terms": terms, "chain_floor_ms": chain_ms, "grid_exchanges": exchanges,
          "us_per_exchange": chain_ms / exchanges * 1e3})
    err = max(max(r["f_abs_err"], r["g_abs_err"]) for r in report.values())
    return flow_cost, {"name": "emd2_warmup", "route": "cuda",
                       "source": "shwd_torch/csrc/emd2_warmup.cu",
                       "replaces": "shwd_tpu/ops/sinkhorn_pallas.py:402",
                       "chain_floor_ms": chain_ms,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bnd, "bound_by": by, "library_ms": None}


def auction_case(name, c, kw):
    """One K2 solve held against auction_assignment_reference (the same
    assignment and prices, bit for bit) and the exact scipy assignment
    (rtol 1e-4). Returns (report, assignment, prices)."""
    from shwd_torch.ops import auction as au
    a1, p1, s1 = au.auction_assignment(c, EPS_FINAL, **kw)
    cluster = au._auction_launch.last_cluster
    a2, p2, s2 = au.auction_assignment_reference(c, EPS_FINAL, **kw)
    # the rows this solve scanned, for the bound (same inputs, so the same
    # deterministic run)
    rows = au._auction_launch(c, EPS_FINAL, 6.0, kw["max_sweeps"], kw.get("prices0"),
                              kw.get("eps0"), kw.get("assign0"))[3]
    torch.cuda.synchronize()
    n = c.shape[-1]
    for row in a1.cpu().numpy():
        check(sorted(row.tolist()) == list(range(n)), f"K2 {name}: not a permutation")
    v1 = au._assignment_cost(c, a1).double().cpu().numpy()
    v2 = au._assignment_cost(c, a2).double().cpu().numpy()
    lsa = np.array([lsa_value(ci) for ci in c.cpu().numpy()])
    check(bool(torch.equal(a1, a2)), f"K2 {name}: assignment differs from the plain version")
    check(bool(torch.equal(p1, p2)), f"K2 {name}: prices differ from the plain version "
          f"by {float((p1 - p2).abs().max())}")
    check(bool(np.allclose(v1, lsa, rtol=1e-4)), f"K2 {name}: {v1} vs exact {lsa}")
    report = {"cluster_size": cluster, "same_assignment": True, "same_prices": True,
              "value_abs_err": float(np.abs(v1 - v2).max()),
              "exact_rel_err": float(np.abs(v1 / lsa - 1).max()),
              "sweeps_kernel_max": int(s1.max()), "sweeps_plain_max": int(s2.max()),
              "rows_scanned": int(rows.sum())}
    return report, a1, p1


def auction_timing(c, kw, rows_scanned):
    """K2's time, the plain version's and the bound of one solve."""
    from shwd_torch.ops import auction as au
    n, b = c.shape[-1], c.shape[0]
    # bytes: the cost, prices and eps0 read once, assignment, prices,
    # sweeps and rows written once (a row scanned again comes from L2);
    # ops: one pass of (negate, subtract, compare, max) over every entry of
    # the rows this run's sweeps and screens scanned
    bytes_moved = b * (n * n * 4 + n * 4 + 2 * n * 4 + 8) + 4
    bnd, by, terms = bound_ms(bytes_moved, rows_scanned * n * 4)
    return {"ms": time_ms(lambda: au.auction_assignment(c, EPS_FINAL, **kw), ahead=True),
            "plain_ms": time_ms(lambda: au.auction_assignment_reference(
                c, EPS_FINAL, **kw), reps=3 if b > 1 else 5),
            "bound_ms": bnd, "bound_by": by, "bound_terms": terms}


def check_auction(dev, flow_cost):
    """K2 vs auction_assignment_reference and the exact scipy assignment:
    the flow shape from K1's warm prices (as the hybrid solver calls it on
    the start cost; also forced to cluster sizes 1 and 16, which must agree
    to the bit), a cold batch of four, and the registration trainer's two
    solves of a step at 128x128x128: the first priced by the plain Sinkhorn
    warm-up, the second seeded with the first's matching and prices on a
    nearby cost (as SHWDLoss calls hybrid_assignment_warm)."""
    from shwd_torch.ops import auction as au
    from shwd_torch.ops import sinkhorn_kernels as sk
    from shwd_torch.ops.costs import cost_matrix
    _, _, g = sk.emd2_warmup(flow_cost, eps=1e-5, num_iters=40, num_scales=8)
    warm = dict(max_sweeps=4000, prices0=(-g).contiguous(),
                eps0=au._hybrid_eps0(flow_cost, EPS_FINAL))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 128, 3)).astype(np.float32)
    y = x + 0.05 * rng.normal(size=(4, 128, 3)).astype(np.float32)
    xs, ys = (torch.as_tensor(a, device=dev) for a in (x, y))
    cold_cost = ((xs[:, :, None] - ys[:, None]) ** 2).sum(-1).contiguous()
    cold = dict(max_sweeps=4000)
    reg_x, reg_y = registration_clouds(dev)
    reg_cost = cost_matrix(reg_x, reg_y, "lp", 2.0).contiguous()
    reg = dict(max_sweeps=4000, eps0=au._hybrid_eps0(reg_cost, EPS_FINAL),
               prices0=au._sinkhorn_warm_prices(
                   reg_cost, REG_SINK["eps"], REG_SINK["num_iters"],
                   REG_SINK["num_scales"]).contiguous())
    # the second solve of a step sees the same clouds through phi one Adam
    # step later: a cost that moved a little
    moved = reg_y + 1e-3 * torch.as_tensor(
        rng.normal(size=tuple(reg_y.shape)), dtype=torch.float32, device=dev)
    seeded_cost = cost_matrix(reg_x, moved, "lp", 2.0).contiguous()
    report, timing = {}, {}
    report["flow_1x1200_warm"], flow_a, flow_p = auction_case(
        "flow_1x1200_warm", flow_cost, warm)
    report["cold_4x128"], _, _ = auction_case("cold_4x128", cold_cost, cold)
    name = "registration_128x128x128_warm"
    report[name], a1, p1 = auction_case(name, reg_cost, reg)
    seeded = dict(max_sweeps=4000, prices0=p1.contiguous(),
                  eps0=au._hybrid_eps0(seeded_cost, EPS_FINAL), assign0=a1.contiguous())
    report["registration_128x128x128_seeded"], _, _ = auction_case(
        "registration_128x128x128_seeded", seeded_cost, seeded)
    # one problem on one CTA and on a cluster of 16: the split of the work
    # must not show in the result
    by_cluster = {}
    for size in (1, 16):
        a, p, _, _ = au._auction_launch(flow_cost, EPS_FINAL, 6.0, 4000, warm["prices0"],
                                        warm["eps0"], None, cluster=size)
        torch.cuda.synchronize()
        check(bool(torch.equal(a, flow_a) and torch.equal(p, flow_p)),
              f"K2 flow_1x1200_warm: cluster size {size} changes the result")
        by_cluster[str(size)] = time_ms(lambda: au._auction_launch(
            flow_cost, EPS_FINAL, 6.0, 4000, warm["prices0"], warm["eps0"], None,
            cluster=size), reps=3, ahead=True)
    report["flow_1x1200_warm"]["ms_by_cluster_size"] = by_cluster
    for name, c, kw in (("flow_1x1200_warm", flow_cost, warm),
                        ("registration_128x128x128_warm", reg_cost, reg),
                        ("registration_128x128x128_seeded", seeded_cost, seeded)):
        timing[name] = auction_timing(c, kw, report[name]["rows_scanned"])
    emit({"phase": "kernel_check", "kernel": "auction_assignment", "checks": report,
          "timing": timing})
    return {"name": "auction_assignment", "route": "cuda",
            "source": "shwd_torch/csrc/auction.cu",
            "replaces": "shwd_tpu/ops/auction.py:43",
            "max_abs_err": max(r["value_abs_err"] for r in report.values()),
            "library_ms": None, "start_cost": timing["flow_1x1200_warm"],
            "cluster_size": {k: r["cluster_size"] for k, r in report.items()},
            "registration": {k: timing[f"registration_128x128x128_{k}"]
                             for k in ("warm", "seeded")}}


def check_auction_seeded(k2, captured):
    """K2 on the inputs of the flow's last launch: the seeded solve that
    ends a step (the first solve's matching and prices, on the cost one phi
    step later). All but the first of the flow's launches look like it, so
    its time is the K2 row's; the start cost's stands beside it."""
    cost, eps_final, scale, max_sweeps, prices0, eps0, assign0 = captured
    check(assign0 is not None and tuple(cost.shape) == (1, FLOW_N, FLOW_N),
          "flow: the last auction launch was not the seeded 1x1200 solve")
    check(eps_final == EPS_FINAL and scale == 6.0, "flow: unexpected auction settings")
    kw = dict(max_sweeps=max_sweeps, prices0=prices0, eps0=eps0, assign0=assign0)
    report, _, _ = auction_case("flow_1x1200_seeded", cost, kw)
    timing = auction_timing(cost, kw, report["rows_scanned"])
    emit({"phase": "kernel_check", "kernel": "auction_assignment",
          "checks": {"flow_1x1200_seeded": report},
          "timing": {"flow_1x1200_seeded": timing}})
    k2["cluster_size"]["flow_1x1200_seeded"] = report["cluster_size"]
    k2["max_abs_err"] = max(k2["max_abs_err"], report["value_abs_err"])
    k2.update({k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    k2["seeded"] = timing


def rand_clouds(b, n, m, seed, dev):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(b, n, 3)), dtype=torch.float32, device=dev)
    y = torch.as_tensor(rng.normal(size=(b, m, 3)), dtype=torch.float32, device=dev)
    return x, y


def registration_clouds(dev):
    """A batch as the registration trainer hands it to the criterion:
    centred shape-bank clouds, the source noisy and rigidly moved."""
    from shwd_torch.data import (DatasetConfig, RegistrationDataset,
                                 TransformConfig)
    cfg = DatasetConfig(source_point_num=REG_N, target_point_num=REG_N,
                        num_synthetic=REG_B, synthetic_kinds=("composite",),
                        cache_dir="modelnet_cache",
                        transform=TransformConfig(noise_sigma=0.02))
    ds = RegistrationDataset(cfg, "train", device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = next(ds.batches(gen, np.arange(REG_B), REG_B, shuffle=False))
    x = batch.target - batch.target.mean(1, keepdim=True)
    y = batch.source - batch.source.mean(1, keepdim=True)
    return x.contiguous(), y.contiguous()


def k3_bound(b, n, m):
    """K3's least time for B items of N x M at REG_SINK (the largest of the
    bytes, f32 and transcendental terms)."""
    entries = b * n * m
    sweeps = REG_SINK["num_iters"] * REG_SINK["num_scales"]
    # per entry per half-iteration: 2 sub, compare/max, sub, add, exp ~ 6
    # ops; plus the cost build (8), one division per temperature, the value
    # pass (7)
    ops = entries * (2 * sweeps * 6 + 8 + REG_SINK["num_scales"] + 7)
    # one exp per entry per half-iteration and in the value pass, one log
    # per row and per column each iteration
    transcendentals = entries * (2 * sweeps + 1) + sweeps * (b * n + b * m)
    bytes_moved = (b * n * 3 + b * m * 3) * 4 + (b + b * n + b * m) * 4
    return bound_ms(bytes_moved, ops, transcendentals)


def check_sinkhorn_points(dev):
    """K3 vs sinkhorn_points_reference on both routes: the register route
    at the registration trainer's train batch (128) and eval batch (the 51
    validation shapes), a ragged batch in every cost kind and a tiny one
    (masking); the general route at a ragged batch wider than 128 in every
    cost kind. Two calls must give the same bits. Then the gradient, and
    the timings of the train and eval batches, each with the general route
    (the kernel before the register route) timed beside it."""
    from shwd_torch.ops import sinkhorn_fused as sp
    from shwd_torch.ops.costs import cost_matrix
    reg_x, reg_y = registration_clouds(dev)
    rag_x, rag_y = rand_clouds(3, 100, 130, 4, dev)
    r120_x, r120_y = rand_clouds(3, 100, 120, 6, dev)
    tiny_x, tiny_y = rand_clouds(2, 7, 9, 7, dev)
    val_x, val_y = reg_x[:REG_VAL].contiguous(), reg_y[:REG_VAL].contiguous()
    cases = [("registration_128x128x128_lp", reg_x, reg_y, "lp", 2.0),
             (f"registration_eval_{REG_VAL}x128x128_lp", val_x, val_y, "lp", 2.0),
             ("tiny_2x7x9_lp", tiny_x, tiny_y, "lp", 2.0)]
    for kind, p in (("lp", 2.0), ("cosine", 1.0), ("geodesic", 2.0)):
        cases += [(f"ragged_3x100x120_{kind}", r120_x, r120_y, kind, p),
                  (f"ragged_3x100x130_{kind}", rag_x, rag_y, kind, p)]
    report = {}
    for name, x, y, kind, p in cases:
        v1, f1, g1 = sp._fused_forward(x, y, kind, p, **REG_SINK)
        route = sp._fused_forward.last_route
        again = sp._fused_forward(x, y, kind, p, **REG_SINK)
        v2, f2, g2 = sp.sinkhorn_points_reference(x, y, kind, p, **REG_SINK)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((v1, f1, g1), again)),
              f"K3 {name}: two calls differ")
        for t in (v1, f1, g1):
            check(bool(torch.isfinite(t).all()), f"K3 {name}: non-finite output")
        val_rel = float(((v1 - v2).abs() / v2.abs()).max())
        f_err = float((f1 - f2).abs().max())
        g_err = float((g1 - g2).abs().max())
        check(val_rel <= 1e-3, f"K3 {name}: val rel err {val_rel}")
        check(f_err <= 1e-4 and g_err <= 1e-4, f"K3 {name}: f/g err {f_err} {g_err}")
        report[name] = {"route": route, "val_rel_err": val_rel,
                        "f_abs_err": f_err, "g_abs_err": g_err}
        check(route == sp.pick_route(x.shape[1], y.shape[1]),
              f"K3 {name}: took the {route} route")
    # the gradient through the autograd.Function against autograd through
    # the plain version's envelope (its duals, the same differentiable cost)
    weights = torch.arange(1.0, 4.0, device=dev)
    x1, y1 = rag_x.clone().requires_grad_(True), rag_y.clone().requires_grad_(True)
    (sp.sinkhorn_points(x1, y1, "lp", 2.0, **REG_SINK) * weights).sum().backward()
    _, f, g = sp.sinkhorn_points_reference(rag_x, rag_y, "lp", 2.0, **REG_SINK)
    x2, y2 = rag_x.clone().requires_grad_(True), rag_y.clone().requires_grad_(True)
    c = cost_matrix(x2, y2, "lp", 2.0)
    plan = torch.exp((f[:, :, None] + g[:, None, :] - c.detach()) / REG_SINK["eps"]
                     - np.log(100) - np.log(130))
    ((plan * c).sum((1, 2)) * weights).sum().backward()
    grad_err = max(float((x1.grad - x2.grad).abs().max()),
                   float((y1.grad - y2.grad).abs().max()))
    grad_size = float(x2.grad.abs().max())
    check(grad_err <= 1e-5, f"K3 gradient: abs err {grad_err} (size {grad_size})")
    report["gradient_3x100x130_lp"] = {"abs_err": grad_err, "max_abs_grad": grad_size}

    def run(x, y, **kw):
        return lambda: sp._fused_forward(x, y, "lp", 2.0, **REG_SINK, **kw)

    timing = {}
    for name, x, y in (("train_128x128x128", reg_x, reg_y),
                       (f"eval_{REG_VAL}x128x128", val_x, val_y)):
        bnd, by, terms = k3_bound(x.shape[0], x.shape[1], y.shape[1])
        run(x, y)()
        timing[name] = {
            "route": sp._fused_forward.last_route,
            "ms": time_ms(run(x, y), reps=9, ahead=True),
            "plain_ms": time_ms(lambda: sp.sinkhorn_points_reference(
                x, y, "lp", 2.0, **REG_SINK), reps=3),
            "general_route_ms": time_ms(run(x, y, route="general"), reps=5, ahead=True),
            "bound_ms": bnd, "bound_by": by, "bound_terms": terms}
    emit({"phase": "kernel_check", "kernel": "sinkhorn_points", "checks": report,
          "timing": timing})
    t = timing["train_128x128x128"]
    err = max(max(r["f_abs_err"], r["g_abs_err"])
              for k, r in report.items() if "f_abs_err" in r)
    return {"name": "sinkhorn_points", "route": "cuda",
            "source": "shwd_torch/csrc/sinkhorn_points.cu",
            "replaces": "shwd_tpu/ops/sinkhorn_pallas.py:202",
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "kernel_route": t["route"],
            "general_route_ms": t["general_route_ms"],
            "eval": timing[f"eval_{REG_VAL}x128x128"]}


def sinkhorn_warm_bound(b, n, m):
    """The small-problem warm-up's least time for B items of N x M at
    REG_SINK (the largest of the bytes, f32 and transcendental terms)."""
    entries = b * n * m
    sweeps = REG_SINK["num_iters"] * REG_SINK["num_scales"]
    # per entry per half-iteration: subtract, multiply-add, max, subtract,
    # scale, add = 6 ops
    ops = 2 * sweeps * entries * 6
    # one exp per entry per half-iteration, one log per row and per column
    # each iteration
    transcendentals = 2 * sweeps * entries + sweeps * (b * n + b * m)
    bytes_moved = entries * 4 + (b * n + b * m + REG_SINK["num_scales"]) * 4
    return bound_ms(bytes_moved, ops, transcendentals)


def check_sinkhorn_warm(dev):
    """The small-problem warm-up (csrc/sinkhorn_warm.cu) against the plain
    emd2_approx on the card, at the hybrid solver's cold solves of the
    registration trainer: the train batch 128x128x128, the benchmark
    cell's last validation batch (25) and this script's (REG_VAL), and a
    ragged batch; f and g within 1e-5 of the item's max |C|, two calls the
    same bits. Then the ms of the kernel's wrapper, of the plain path and
    the bound, at the train batch and the cell's last validation batch."""
    from shwd_torch.ops import sinkhorn_kernels as sk
    from shwd_torch.ops.costs import cost_matrix
    from shwd_torch.ops.sinkhorn import emd2_approx
    reg_x, reg_y = registration_clouds(dev)
    costs = {f"registration_{REG_B}x128x128": cost_matrix(reg_x, reg_y, "lp", 2.0)}
    for v in (CELL_VAL_TAIL, REG_VAL):
        costs[f"registration_eval_{v}x128x128"] = costs[
            f"registration_{REG_B}x128x128"][:v]
    rag_x, rag_y = rand_clouds(3, 100, 120, 6, dev)
    costs["ragged_3x100x120"] = cost_matrix(rag_x, rag_y, "lp", 2.0)
    report = {}
    for name, c in costs.items():
        c = costs[name] = c.contiguous()
        f1, g1 = sk.sinkhorn_warm(c, **REG_SINK)
        again = sk.sinkhorn_warm(c, **REG_SINK)
        _, f2, g2 = emd2_approx(c, return_potentials=True, **REG_SINK)
        torch.cuda.synchronize()
        check(torch.equal(f1, again[0]) and torch.equal(g1, again[1]),
              f"sinkhorn_warm {name}: two calls differ")
        check(bool(torch.isfinite(f1).all() and torch.isfinite(g1).all()),
              f"sinkhorn_warm {name}: non-finite output")
        scale = float(c.abs().max())
        f_err = float((f1 - f2).abs().max())
        g_err = float((g1 - g2).abs().max())
        check(max(f_err, g_err) <= 1e-5 * scale,
              f"sinkhorn_warm {name}: f/g err {f_err} {g_err} (max |C| {scale})")
        report[name] = {"f_abs_err": f_err, "g_abs_err": g_err, "max_abs_cost": scale}
    timing = {}
    for v in (REG_B, CELL_VAL_TAIL):
        name = f"registration_{v}x128x128" if v == REG_B else f"registration_eval_{v}x128x128"
        c = costs[name]
        bnd, by, terms = sinkhorn_warm_bound(*c.shape)
        timing[name] = {
            "ms": time_ms(lambda: sk.sinkhorn_warm(c, **REG_SINK), reps=9, ahead=True),
            "plain_ms": time_ms(lambda: emd2_approx(c, return_potentials=True, **REG_SINK),
                                reps=3),
            "bound_ms": bnd, "bound_by": by, "bound_terms": terms}
    emit({"phase": "kernel_check", "kernel": "sinkhorn_warm", "checks": report,
          "timing": timing})
    t = timing[f"registration_{REG_B}x128x128"]
    return {"name": "sinkhorn_warm", "route": "cuda",
            "source": "shwd_torch/csrc/sinkhorn_warm.cu",
            "replaces": "none (shwd_tpu/ops/sinkhorn.py::emd2_approx is plain jnp)",
            "max_abs_err": max(max(r["f_abs_err"], r["g_abs_err"]) for r in report.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "eval": timing[f"registration_eval_{CELL_VAL_TAIL}x128x128"]}


def check_chamfer(dev):
    """K4 vs chamfer_tiled_reference and the dense chamfer: the flow's eval
    metric (one pair of 1200-point clouds), a batch of registration clouds
    and a ragged large shape; two calls must give the same bits. Timed with
    its launch floor: the same cooperative launch with an empty body."""
    from shwd_torch.ops.chamfer import (chamfer, chamfer_chunks, chamfer_launch_floor,
                                        chamfer_tiled, chamfer_tiled_reference)
    src, tgt = flow_clouds(dev)
    reg_x, reg_y = registration_clouds(dev)
    big_x, big_y = rand_clouds(2, 5000, 4099, 5, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report, timing = {}, {}
    for name, x, y in (("flow_eval_1x1200x1200", src[None].contiguous(),
                        tgt[None].contiguous()),
                       ("batched_128x128x128", reg_x, reg_y),
                       ("ragged_2x5000x4099", big_x, big_y)):
        got = chamfer_tiled(x, y)
        again = chamfer_tiled(x, y)
        ref = chamfer_tiled_reference(x, y)
        dense = chamfer(x, y)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got)), f"K4 {name}: non-finite output")
        check(bool(torch.equal(got, again)), f"K4 {name}: two calls differ")
        err_ref = abs(float(got) - float(ref))
        err_dense = abs(float(got) - float(dense))
        # rtol 1e-5: the same squared differences, fused multiply-adds in
        # the kernel and another order of the mean
        check(err_ref <= 1e-5 * abs(float(ref)), f"K4 {name}: vs plain {err_ref}")
        check(err_dense <= 1e-5 * abs(float(dense)), f"K4 {name}: vs dense {err_dense}")
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        # 8 f32 operations per pair and side; the clouds in, one scalar out
        bnd, by, terms = bound_ms(12 * b * (n + m) + 4, 16 * b * n * m)
        timing[name] = {"ms": time_ms(lambda: chamfer_tiled(x, y), reps=9, ahead=True),
                        "launch_floor_ms": time_ms(lambda: chamfer_launch_floor(x, y),
                                                   reps=9, ahead=True),
                        "plain_ms": time_ms(lambda: chamfer_tiled_reference(x, y)),
                        "dense_ms": time_ms(lambda: chamfer(x, y)),
                        "chunks": chamfer_chunks(b, n, m, sms),
                        "bound_ms": bnd, "bound_by": by, "bound_terms": terms}
        report[name] = {"abs_err_vs_plain": err_ref, "abs_err_vs_dense": err_dense,
                        "same_bits": True, "value": float(got)}
    emit({"phase": "kernel_check", "kernel": "chamfer_tiled", "checks": report,
          "timing": timing})
    t = timing["flow_eval_1x1200x1200"]
    return {"name": "chamfer_tiled", "route": "cuda",
            "source": "shwd_torch/csrc/chamfer.cu",
            "replaces": "shwd_tpu/ops/chamfer.py:100",
            "max_abs_err": max(r["abs_err_vs_plain"] for r in report.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "launch_floor_ms": t["launch_floor_ms"],
            "large": timing["ragged_2x5000x4099"]}


def phi_counts(points: int, blocks: int) -> dict:
    """(f32 operations, transcendentals) of each of phi's passes over
    ``points``. A layer of in -> out widths: the swish (4 operations and an
    exp an input), the product and bias (2 in out + out); the backward adds
    dL/da (2 in out) and the swish's backward (8 an input) to the forward it
    recomputes; the parameters' partials add the outer product and bias (2
    in out + out) and the softplus term (2 an input)."""
    widths = (3, 8, 8, 8, 8, 8, 8, 3)
    fwd = bwd = par = trans = 0
    for inp, out in zip(widths[:-1], widths[1:]):
        fwd += 4 * inp + 2 * inp * out + out
        bwd += 2 * inp * out + 8 * inp
        par += 2 * inp * out + out + 2 * inp
        trans += inp
    n = points * blocks
    return {"forward": (n * (fwd + 3), n * trans),
            "backward_x": (n * (2 * fwd + bwd + 3), 2 * n * trans),
            "backward_params": (n * (2 * fwd + bwd + par + 3), 2 * n * trans)}


def check_residual_chain(dev):
    """phi's residual-chain kernels against the module path at the cells'
    shapes (PHI_SHAPES; the last layer of each block undone from its /1000
    init, so the blocks' nonlinear parts show): the forward, dL/dx and the
    parameters' gradients of sum(phi(x) * r), and 1 and 200 power-iteration
    rounds; two calls give the same bits. Timed per pass (CUDA events, the
    card kept busy ahead), with the forward's launch floor (its launch with
    an empty body) and the module path's eager ms."""
    from shwd_torch.flows import make_flow
    from shwd_torch.flows.residual import kernel_layers
    from shwd_torch.ops import residual_chain as rc

    def module_forward(chain, x):
        for f in chain.flows:
            x = f(x)
        return x

    def module_grads(chain, x, r):
        x = x.clone().requires_grad_(True)
        chain.zero_grad(set_to_none=True)
        torch.sum(module_forward(chain, x) * r).backward()
        return x.grad, torch.cat([getattr(m, f).grad.reshape(-1) for fl in chain.flows
                                  for m in fl.net.layers for f in ("w", "b", "beta")])

    def chain_of(blocks, seed):
        chain = make_flow("Residual", blocks,
                          generator=torch.Generator(device=dev).manual_seed(seed))
        with torch.no_grad():
            for f in chain.flows:
                f.net.layers[-1].w.mul_(1000.0)
        return chain

    report, timing = {}, {}
    for name, (n, blocks) in PHI_SHAPES.items():
        chain = chain_of(blocks, 0)
        layers = kernel_layers(chain)
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(n, 3, device=dev, generator=gen)
        r = torch.randn(n, 3, device=dev, generator=gen)
        y, saved = rc.chain_forward(x, layers, save=True)
        gx, partials = rc.chain_backward(saved, r, layers)
        grads = rc.chain_grad_reduce(partials, layers)
        again = (rc.chain_forward(x, layers, save=True)[0],
                 *rc.chain_backward(saved, r, layers))
        same = all(torch.equal(a, b) for a, b in zip((y, gx, partials), again))
        same = same and torch.equal(grads, rc.chain_grad_reduce(again[2], layers))
        wx, wgrads = module_grads(chain, x, r)
        with torch.no_grad():
            wy = module_forward(chain, x)
        err_y = float((y - wy).abs().max())
        err_gx = float((gx - wx).abs().max() / wx.abs().max())
        err_gp = float((grads - wgrads).abs().max() / wgrads.abs().max())
        power = {}
        for rounds in (1, 200):
            a, b = chain_of(blocks, 2), chain_of(blocks, 2)
            a.update_state(rounds)
            for f in b.flows:
                f.update_state(rounds)
            power[rounds] = max(float((u - v).abs().max()) for u, v in
                                zip(a.state_dict().values(), b.state_dict().values()))
        torch.cuda.synchronize()
        check(same, f"residual chain {name}: two calls differ")
        # rounding of f32 products in another order (module: cuBLAS)
        check(err_y <= 1e-5 * float(wy.abs().max()), f"residual chain {name}: y off by {err_y}")
        check(err_gx <= 1e-5, f"residual chain {name}: dL/dx off by {err_gx} of its largest")
        check(err_gp <= 1e-4, f"residual chain {name}: parameters' gradients off by {err_gp}")
        check(power[1] <= 1e-5 and power[200] <= 1e-4,
              f"residual chain {name}: power iteration off by {power}")
        counts = phi_counts(n, blocks)
        bound = {k: bound_ms(12 * n * (2 + (blocks if k == "forward" else 0)), *c)
                 for k, c in counts.items()}
        probe = chain_of(blocks, 3)
        probe_layers = kernel_layers(probe)
        timing[name] = {
            "forward_ms": time_ms(lambda: rc.chain_forward(x, layers, save=True), reps=9,
                                  ahead=True),
            "backward_x_ms": time_ms(lambda: rc.chain_backward(saved, r, layers, True, False),
                                     reps=9, ahead=True),
            "backward_params_ms": time_ms(
                lambda: rc.chain_backward(saved, r, layers, False, True), reps=9, ahead=True),
            "grad_reduce_ms": time_ms(lambda: rc.chain_grad_reduce(partials, layers), reps=9,
                                      ahead=True),
            "power_iteration_1_ms": time_ms(lambda: rc.chain_power_iteration(probe_layers, 1),
                                            reps=9, ahead=True),
            "power_iteration_200_ms": time_ms(
                lambda: rc.chain_power_iteration(probe_layers, 200), reps=5, ahead=True),
            "launch_floor_ms": time_ms(lambda: rc.chain_launch_floor(x), reps=9, ahead=True),
            "plain_forward_ms": time_ms(lambda: module_forward(chain, x)),
            "plain_forward_backward_ms": time_ms(lambda: module_grads(chain, x, r)),
            "plain_power_iteration_1_ms": time_ms(lambda: [f.update_state(1)
                                                           for f in probe.flows]),
            "backward_grid": int(partials.shape[0]),
            "bound_ms": {k: v[0] for k, v in bound.items()},
            "bound_by": {k: v[1] for k, v in bound.items()},
            "ops": {k: c[0] for k, c in counts.items()}}
        report[name] = {"max_abs_err_y": err_y, "rel_err_gx": err_gx, "rel_err_grads": err_gp,
                        "power_iteration_max_abs_err": power, "same_bits": same}
    emit({"phase": "kernel_check", "kernel": "residual_chain", "checks": report,
          "timing": timing, "launches_per_pass": {
              "forward": 1, "backward_x": 1, "backward_params": 2, "power_iteration": 1},
          "nodes_per_shwd_step": PHI_NODES})
    t = timing["flow_2400x3_5_blocks"]
    return {"name": "residual_chain_forward", "route": "cuda",
            "source": "shwd_torch/csrc/residual_chain.cu",
            "replaces": "none (shwd_tpu/flows/lipschitz.py is plain jnp)",
            "max_abs_err": max(c["max_abs_err_y"] for c in report.values()),
            "ms": t["forward_ms"], "plain_ms": t["plain_forward_ms"],
            "bound_ms": t["bound_ms"]["forward"], "bound_by": t["bound_by"]["forward"],
            "launch_floor_ms": t["launch_floor_ms"], "library_ms": None,
            "timing": timing}


def flow_config():
    from shwd_torch.train.flow_driver import FlowConfig
    return FlowConfig(method="SHWD", num_iterations=400, eval_interval=50,
                      num_projections=100, shwd_layers=5, shwd_lam=0.1,
                      shwd_max_iter=1, shwd_phi_lr=0.001, shwd_phi_wd=0.1,
                      shwd_solver="hybrid", seed=0)


def phase_flow(dev):
    """Slice 1: run_flow at the Flow_cube benchmark config, fused (one step
    captured as a CUDA graph, replayed 400 times); then 50 iterations of
    the per-step loop from the same start, whose points must equal the
    fused run's at iteration 50; the idle share of one replayed step."""
    from shwd_torch.ops import auction as au
    from shwd_torch.ops import sinkhorn_kernels as sk
    from shwd_torch.ops.emd_exact import w2_exact
    from shwd_torch.train import flow_driver as fd
    src, tgt = flow_clouds(dev)
    cfg = flow_config()
    # keep the inputs of the flow's last auction launch, the seeded solve
    # that ends a step, for check_auction_seeded. The step is captured, so
    # the wrapper runs only at the warm-up and the capture: the captured
    # call's tensors are buffers that every replay rewrites, and after the
    # run they hold the last replay's inputs
    inner, seen, last = au._auction_launch, [0], []
    steps = cfg.num_iterations + 1

    def recording(*args):
        seen[0] += 1
        if seen[0] % 2 == 0:
            last[:] = list(args)
        return inner(*args)

    at_50 = []

    def eval_w2(p, t):
        if len(at_50) < 2:
            at_50.append(p.copy())
        return w2_exact(p, t)

    au._auction_launch = recording
    sk.emd2_warmup.launches = 0
    au.auction_assignment.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        res = fd.run_flow(src.cpu().numpy(), tgt.cpu().numpy(), cfg, eval_fn=eval_w2,
                          device=dev)
    finally:
        au._auction_launch = inner
    wall = time.perf_counter() - t0
    launches = {"emd2_warmup": sk.emd2_warmup.launches,
                "auction_assignment": au.auction_assignment.launches}
    captured = [a.clone() if torch.is_tensor(a) else a for a in last]
    del last
    ms_per_iter = float(np.mean(res.interval_seconds)) / cfg.eval_interval * 1e3
    final_w2 = float(res.eval_values[-1])
    per_iter = res.interval_seconds / cfg.eval_interval * 1e3
    # the per-step loop, 50 iterations from the same start
    step_cfg = dataclasses.replace(cfg, num_iterations=cfg.eval_interval)
    step_res = fd.run_flow(src.cpu().numpy(), tgt.cpu().numpy(), step_cfg, device=dev,
                           fused=False)
    diff_50 = float(np.abs(step_res.clouds - at_50[1]).max())
    step_ms = float(np.mean(step_res.interval_seconds)) / cfg.eval_interval * 1e3
    adam = adam_isolation(dev, cfg, src, tgt, final_w2)
    # one replayed step on a fresh state: its idle share
    init_state, step = fd._make_loss_step(cfg, dev)
    state = init_state(torch.Generator(device=dev).manual_seed(cfg.seed))
    points = src.clone().requires_grad_(True)
    state["opt"], state["sched"] = fd._make_point_opt(cfg, points)
    graph, _ = fd._step_graph(cfg, step, state, points, tgt, dev)
    replay = replay_profile(graph)
    replay["idle_share_of_step"] = 1 - replay["busy_ms"] / ms_per_iter
    emit({"phase": "flow", "path": res.path, "ms_per_iter": ms_per_iter,
          "per_step_ms_per_iter_50": step_ms,
          "interval_ms_per_iter": per_iter.tolist(),
          "interval0_ms_per_iter": float(per_iter[0]),
          "other_intervals_ms_per_iter_range": [float(per_iter[1:].min()),
                                                float(per_iter[1:].max())],
          "graph": res.graph, "replayed_step": replay,
          "points_at_50_max_abs_diff_vs_per_step": diff_50,
          "points_at_50_bitwise_equal": diff_50 == 0.0, "adam_isolation": adam,
          "flops_per_step": res.flops_per_step,
          "final_w2": final_w2, "best_w2": float(np.min(res.eval_values)),
          "w2_curve": res.eval_values.tolist(), "wall_seconds": wall,
          "launches": launches, "iterations": cfg.num_iterations,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    check(res.path == "fused" and res.graph["captured"], f"flow: path {res.path}")
    check(res.graph["nodes_by_kernel"] == {"emd2_warmup": 1, "auction_assignment": 2,
                                          **PHI_NODES},
          f"flow: graph kernel nodes {res.graph['nodes_by_kernel']}")
    check(np.isfinite(res.clouds).all() and res.clouds.shape == (FLOW_N, 3),
          "flow: malformed clouds")
    check(all(v > 0 for v in launches.values()), f"flow: a kernel never ran {launches}")
    check(final_w2 <= 1e-3, f"flow: final W2 {final_w2} > 1e-3")
    check(diff_50 <= 1e-5, f"flow: the per-step loop's points at iteration 50 are "
          f"{diff_50} off the fused run's")
    # the warm-up step's two solves on copies, the capture's two
    check(seen[0] == 4, f"flow: {seen[0]} auction wrapper calls, expected 4")
    check(launches["emd2_warmup"] == steps and launches["auction_assignment"] == 2 * steps,
          f"flow: launches {launches}, expected {steps} and {2 * steps}")
    return launches, captured


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


def eager_adam(opt):
    """The same Adam with its step count and bias corrections on the host
    (capturable=False), as the optimizers of the port were before its steps
    were captured."""
    g = opt.param_groups[0]
    return torch.optim.Adam(g["params"], lr=g["lr"], betas=g["betas"], eps=g["eps"],
                            weight_decay=g["weight_decay"], capturable=False)


def flow_per_step(dev, cfg, src, tgt, iterations, capturable, keep):
    """The flow's per-step loop from a fresh state (run_flow(fused=False)'s
    trajectory), its Adams capturable or not: the points after each of the
    first ``keep`` iterations, and the final points."""
    from shwd_torch.train import flow_driver as fd
    init_state, step = fd._make_loss_step(cfg, dev)
    state = init_state(torch.Generator(device=dev).manual_seed(cfg.seed))
    points = src.clone().requires_grad_(True)
    state["opt"], state["sched"] = fd._make_point_opt(cfg, points)
    if not capturable:
        state["opt"] = eager_adam(state["opt"])
        state["crit"].opt = eager_adam(state["crit"].opt)
    traj = []
    for i in range(iterations):
        step(points, tgt, state)
        if i < keep:
            traj.append(points.detach().clone())
    return traj, points.detach()


def adam_isolation(dev, cfg, src, tgt, fused_w2):
    """Whether the capturable Adam alone moved the flow's final W2 (5.0077e-4
    on the H100 with the host-side Adam, 5.6649e-4 since the optimizers are
    capturable): three steps of each Adam on the same parameters and
    gradients (the capturable one forms its bias corrections in f32 on the
    card), in ulps and relative to the largest update; where the per-step
    trajectories of the two part over the first 50 iterations; and the final
    W2 of 400 per-step iterations with the host-side Adams."""
    from shwd_torch.ops.emd_exact import w2_exact
    from shwd_torch.utils.optim import torch_adam
    rng = np.random.default_rng(0)
    ulps = {}
    for name, shape, lr, wd in (("points", (FLOW_N, 3), cfg.lr, 0.0),
                                ("phi", (64, 64), cfg.shwd_phi_lr, cfg.shwd_phi_wd)):
        w = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)
        g = torch.as_tensor(rng.normal(size=shape) * 1e-3, dtype=torch.float32, device=dev)
        out = []
        for capturable in (True, False):
            p = w.clone().requires_grad_(True)
            opt = torch_adam([p], lr, wd, capturable=capturable)
            for _ in range(3):
                p.grad = g.clone()
                opt.step()
            out.append(p.detach())
        ucap, uhost = (o.double() - w.double() for o in out)
        ulps[name] = adam_step_ulps(out[0], out[1], lr) + (
            float((ucap - uhost).abs().max() / uhost.abs().max()),)
    keep = cfg.eval_interval
    cap, _ = flow_per_step(dev, cfg, src, tgt, keep, True, keep)
    t0 = time.perf_counter()
    host, final = flow_per_step(dev, cfg, src, tgt, cfg.num_iterations, False, keep)
    host_s = time.perf_counter() - t0
    diffs = [float((a - b).abs().max()) for a, b in zip(cap, host)]
    parted = next((i + 1 for i, d in enumerate(diffs) if d > 0), None)
    w2 = w2_exact(final.cpu().numpy(), tgt.cpu().numpy())
    check(np.isfinite(w2), f"flow: the host-side Adam run's W2 is {w2}")
    return {"three_steps_ulps_of_parameter_and_of_update_and_relative_update": ulps,
            "trajectories_part_at_iteration": parted,
            "max_abs_diff_by_iteration": diffs,
            "host_adam_w2_at_400": w2, "capturable_adam_fused_w2_at_400": fused_w2,
            "host_adam_run_seconds": host_s}


def phase_flow_cd(dev):
    """The same flow config for 20 iterations with eval_metric="cd": run_flow
    records the tiled Chamfer (K4) at iteration 0 and after every
    interval."""
    from shwd_torch.ops.chamfer import chamfer, chamfer_tiled
    from shwd_torch.train.flow_driver import run_flow
    src, tgt = flow_clouds(dev)
    cfg = dataclasses.replace(flow_config(), num_iterations=20, eval_interval=5,
                              eval_metric="cd")
    chamfer_tiled.launches = 0
    res = run_flow(src.cpu().numpy(), tgt.cpu().numpy(), cfg, device=dev)
    launches = chamfer_tiled.launches
    dense = float(chamfer(torch.as_tensor(res.clouds, device=dev)[None], tgt[None]))
    emit({"phase": "flow_cd", "iterations": cfg.num_iterations,
          "cd_curve": res.eval_values.tolist(), "dense_chamfer_of_result": dense,
          "launches": {"chamfer_tiled": launches}})
    want = cfg.num_iterations // cfg.eval_interval + 1
    check(launches == want, f"flow_cd: K4 launched {launches} times, expected {want}")
    check(bool(np.isfinite(res.eval_values).all()), "flow_cd: non-finite metric")
    check(abs(res.eval_values[-1] - dense) <= 1e-5 * dense,
          f"flow_cd: last metric {res.eval_values[-1]} vs dense chamfer {dense}")
    check(res.eval_values[-1] < res.eval_values[0], "flow_cd: the metric did not fall")
    return launches


def registration_config(log_dir, label, criterion="w_cos", solver="sinkhorn",
                        points=REG_N, **overrides):
    """The registration config (B=128 on the 256-shape composite bank,
    noise 0.02, seed 0, full-width PCRNet, 3 Residual layers, the SHWD knobs
    of TrainConfig) for the run ``label``; ``overrides`` replace fields."""
    from shwd_torch.data import DatasetConfig, TransformConfig
    from shwd_torch.losses import SHWDConfig, TransportConfig
    from shwd_torch.train import TrainConfig
    fields = dict(
        experiment=label, log_dir=str(log_dir), criterion=criterion, batch_size=REG_B,
        seed=REG_SEED, num_epochs=REG_EPOCHS[label],
        dataset=DatasetConfig(
            source_point_num=points, target_point_num=points,
            num_synthetic=REG_SHAPES, synthetic_kinds=("composite",), cache_dir="modelnet_cache",
            transform=TransformConfig(noise_sigma=0.02)),
        pcr_iteration_num=3,
        shwd=SHWDConfig(
            transport=TransportConfig(cost="lp", p=2.0, solver=solver, **REG_SINK),
            max_iter=1, lam=1.3e-5, phi_lr=9.2e-5),
        phi_num_flow_layer=3)
    fields.update(overrides)
    return TrainConfig(**fields)


def kernel_wrappers():
    from shwd_torch.utils.graphs import kernel_wrappers as wrappers
    return wrappers()


def run_registration(dev, cfg, n_val_expected=REG_VAL):
    """``Trainer.fit`` on the card with the kernels' counts set to 0 just
    before and read just after; every metric must be finite and every best
    checkpoint must load back. Returns (summary, trainer, fit result,
    dataset)."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer
    from shwd_torch.utils import load_checkpoint
    label = cfg.experiment
    trainer = Trainer(cfg)                    # the card by default
    ds = RegistrationDataset(cfg.dataset, "train")
    check(trainer.device.type == "cuda" and ds.sources.is_cuda,
          f"registration {label}: the trainer did not take the card")
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = trainer.fit(ds, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    hist = res["history"]
    steps = sum(r["train_steps"] for r in hist)
    n_val = int(len(ds) * cfg.dataset.val_split)
    check(n_val == n_val_expected, f"registration {label}: {n_val} validation shapes, "
          f"the kernel checks assume {n_val_expected}")
    eval_batches = len(hist) * -(-n_val // cfg.batch_size)
    step_ms = [r["train_seconds"] / r["train_steps"] * 1e3 for r in hist[1:]]
    q = max(len(hist) // 4, 1)
    losses = [r["train_loss"] for r in hist]
    for r in hist:
        check(all(np.isfinite(r[k]) for k in
                  ("train_loss", "val_loss", "rot_error", "trans_error")),
              f"registration {label}: non-finite metric in {r}")
    models = f"{cfg.log_dir}/{cfg.experiment}/models"
    for snap in ("best_model_snap", "best_rot_error_snap", "best_trans_error_snap"):
        fresh = trainer.init_state(torch.Generator(device=dev).manual_seed(1))
        _, epoch = load_checkpoint(f"{models}/{snap}", fresh)
        check(1 <= epoch <= cfg.num_epochs, f"{label}: {snap} epoch {epoch}")
        check(all(bool(torch.isfinite(p).all()) for p in fresh.model.parameters()),
              f"{label}: {snap} holds non-finite weights")
    summary = {
        "criterion": cfg.criterion, "solver": cfg.shwd.transport.solver,
        "points": cfg.dataset.source_point_num,
        "epochs": len(hist), "train_steps": steps, "eval_batches": eval_batches,
        "ms_per_train_step": float(np.mean(step_ms)),
        "ms_per_train_step_by_epoch": step_ms,
        "clouds_per_second": cfg.batch_size / float(np.mean(step_ms)) * 1e3,
        "ms_per_epoch": float(np.mean([r["seconds"] for r in hist[1:]])) * 1e3,
        "train_loss_first": losses[0], "train_loss_last": losses[-1],
        "train_loss_curve": losses,
        "val_loss_first_quarter": float(np.mean([r["val_loss"] for r in hist[:q]])),
        "val_loss_last_quarter": float(np.mean([r["val_loss"] for r in hist[-q:]])),
        "val_rot_error_last_quarter": float(np.mean([r["rot_error"] for r in hist[-q:]])),
        "val_rot_error_curve": [r["rot_error"] for r in hist],
        "val_rot_error_first": hist[0]["rot_error"],
        "val_rot_error_last": hist[-1]["rot_error"],
        "val_trans_error_first": hist[0]["trans_error"],
        "val_trans_error_last": hist[-1]["trans_error"],
        "best": {k: v for k, v in res["best"].items() if np.isfinite(v)},
        "wall_seconds": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": launches, "path": res["path"], "graphs": res["graphs"],
        "history": [{k: r[k] for k in HISTORY_KEYS} for r in hist]}
    return summary, trainer, res, ds


HISTORY_KEYS = ("train_loss", "val_loss", "rot_error", "trans_error")


def history_diff(hist, ref):
    """(largest relative difference, bitwise equal) of two histories over
    the loss and error keys."""
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(hist, ref) for k in HISTORY_KEYS)
    return worst, all(a[k] == b[k] for a, b in zip(hist, ref) for k in HISTORY_KEYS)


def check_fused_launches(label, run, kernel, train_nodes, eval_nodes):
    """A fused fit: it took the fused path; its train graph holds
    ``train_nodes`` nodes of ``kernel`` and each eval graph ``eval_nodes``;
    the wrapper's count is those nodes times the replays plus each graph's
    eager warm-up run, which is 2 per train step and 1 per eval batch for
    K3 on w_cos/sinkhorn."""
    check(run["path"] == "fused", f"registration {label}: path {run['path']}")
    for g in run["graphs"]:
        want = train_nodes if g["name"].startswith("train") else eval_nodes
        check(g["captured"] and g["nodes_by_kernel"].get(kernel, 0) == want,
              f"registration {label}: graph {g['name']} holds "
              f"{g['nodes_by_kernel']}, expected {want} {kernel}")
    want = graph_launches(run["graphs"], kernel)
    check(run["launches"][kernel] == want,
          f"registration {label}: {kernel} launched {run['launches'][kernel]} times, "
          f"the graphs account for {want}")
    replays = sum(g["replays"] for g in run["graphs"] if g["name"].startswith("train"))
    check(replays == run["train_steps"],
          f"registration {label}: {replays} train replays for {run['train_steps']} steps")


def profile_train_step(trainer, state, ds):
    """One more train step under torch.profiler: the CUDA kernels it puts
    on the card, K3's among them, and their device time."""
    gen = torch.Generator(device=trainer.device).manual_seed(7)
    batch = next(ds.batches(gen, np.arange(REG_B), REG_B, shuffle=False))
    kernels = device_kernels(lambda: trainer._train_step(state, batch))
    k3 = [ms for name, ms in kernels if "sinkhorn_points" in name]
    return {"device_launches_per_step": len(kernels),
            "device_busy_ms_per_step": sum(ms for _, ms in kernels),
            "k3_launches_per_step": len(k3), "k3_ms_per_step": sum(k3)}


def phase_registration(dev, log_dir):
    """Slice 2: Trainer.fit at the registration config, three criteria.
    Returns the sinkhorn run's (config, fit result) for phase evaluate."""
    runs, sink_run = {}, None
    for label, solver, criterion in (("sinkhorn", "sinkhorn", "w_cos"),
                                     ("hybrid", "hybrid", "w_cos"),
                                     ("cd", "sinkhorn", "cd")):
        cfg = registration_config(log_dir, label, criterion, solver)
        runs[label], _, res, _ = run_registration(dev, cfg)
        if label == "sinkhorn":
            sink_run = (cfg, res)
    emit({"phase": "registration", "batch": REG_B, "points": REG_N, "runs": runs})
    sink, hyb, cd = runs["sinkhorn"], runs["hybrid"], runs["cd"]
    # K3 twice per train step and once per eval batch, as graph nodes
    check_fused_launches("sinkhorn", sink, "sinkhorn_points", 2, 1)
    n_graphs = len(sink["graphs"])
    want = 2 * sink["train_steps"] + sink["eval_batches"] + 2 + (n_graphs - 1)
    check(sink["launches"]["sinkhorn_points"] == want,
          f"registration: K3 launched {sink['launches']['sinkhorn_points']} "
          f"times, expected {want}")
    check_fused_launches("hybrid", hyb, "auction_assignment", 2, 1)
    # one cold solve a train step (phi's inner solve) and a validation batch
    check_fused_launches("hybrid", hyb, "sinkhorn_warm", 1, 1)
    check(hyb["launches"]["sinkhorn_points"] == 0,
          f"registration hybrid: launches {hyb['launches']}")
    # the cd criterion is the dense differentiable Chamfer in both passes
    check(cd["path"] == "fused" and not any(cd["launches"].values()),
          f"registration cd: path {cd['path']}, launches {cd['launches']}")
    curve = sink["train_loss_curve"]
    q = max(len(curve) // 4, 1)
    first, last = float(np.mean(curve[:q])), float(np.mean(curve[-q:]))
    check(last < first, f"registration: train loss did not fall ({first} -> {last})")
    check(sink["val_loss_last_quarter"] < sink["val_loss_first_quarter"],
          f"registration: val loss did not fall ({sink['val_loss_first_quarter']}"
          f" -> {sink['val_loss_last_quarter']})")
    check(sink["val_rot_error_last_quarter"] <= REG_PLATEAU_DEG,
          f"registration: val rotation error {sink['val_rot_error_last_quarter']}"
          f" deg over the last quarter, above the {REG_PLATEAU_DEG} deg plateau")
    check(sink["val_trans_error_last"] < sink["val_trans_error_first"],
          "registration: val translation error did not fall")
    return ({"sinkhorn_points": sink["launches"]["sinkhorn_points"],
             "auction_assignment": hyb["launches"]["auction_assignment"],
             "sinkhorn_warm": hyb["launches"]["sinkhorn_warm"]}, sink_run, runs)


def tool(name):
    """The module tools/<name>.py (the row harnesses: their configs)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_registration_learns(dev, log_dir):
    """The w_cos row's config (the 2048-shape bank: 1639 train shapes, 12
    steps an epoch; 409 val shapes, 3 x 128 + 25; 512 test), seed
    REG_SEED, LEARN_EPOCHS epochs, fused: the best validation rotation
    error must reach LEARN_ROT_DEG, the last quarter's translation error
    stay under LEARN_TRANS, and evaluate on the test split at
    best_rot_error_snap be finite and below the first epoch's error. K3
    twice per train step and once per eval batch, as graph nodes x replays
    plus each graph's warm-up. Returns K3's launches."""
    from shwd_torch.train.evaluate import evaluate
    rows = tool("registration_rows_torch")
    cfg = rows.row_config("w_cos", REG_SEED, str(log_dir), LEARN_EPOCHS)
    cfg = dataclasses.replace(cfg, experiment="registration_learns")
    n_val = int(cfg.dataset.num_synthetic * cfg.dataset.val_split)
    run, _, res, _ = run_registration(dev, cfg, n_val_expected=n_val)
    hist = res["history"]
    check_fused_launches("registration_learns", run, "sinkhorn_points", 2, 1)
    want = 2 * run["train_steps"] + run["eval_batches"] + 2 + (len(run["graphs"]) - 1)
    check(run["launches"]["sinkhorn_points"] == want,
          f"registration_learns: K3 launched {run['launches']['sinkhorn_points']} "
          f"times, expected {want}")
    t0 = time.perf_counter()
    ev = evaluate(cfg, checkpoint=f"{log_dir}/{cfg.experiment}/models/best_rot_error_snap",
                  split="test")
    eval_s = time.perf_counter() - t0
    q = max(len(hist) // 4, 1)
    trans_last_quarter = float(np.mean([r["trans_error"] for r in hist[-q:]]))
    emit({"phase": "registration_learns", "row": "w_cos", "seed": cfg.seed,
          "epochs": len(hist), "train_steps_per_epoch": hist[0]["train_steps"],
          "val_shapes": n_val, "best_rot_error": run["best"]["rot"],
          "best_rot_epoch": hist[int(np.argmin([r["rot_error"] for r in hist]))]["epoch"],
          "best_trans_error": run["best"]["trans"],
          "rot_curve_every10": [r["rot_error"] for r in hist[::10]],
          "trans_curve_every10": [r["trans_error"] for r in hist[::10]],
          "val_trans_error_last_quarter": trans_last_quarter,
          "ms_per_train_step": run["ms_per_train_step"],
          "s_per_epoch": run["wall_seconds"] / len(hist),
          "peak_mem_bytes": run["peak_mem_bytes"],
          "k3_launches": run["launches"]["sinkhorn_points"],
          "k3_launches_expected": want,
          "graphs": [{k: g[k] for k in ("name", "replays")} for g in run["graphs"]],
          "test_mean_rot_error": ev.mean_rot_error,
          "test_mean_trans_error": ev.mean_trans_error, "evaluate_seconds": eval_s})
    check(run["best"]["rot"] <= LEARN_ROT_DEG,
          f"registration_learns: best val rotation error {run['best']['rot']} deg "
          f"in {len(hist)} epochs, above {LEARN_ROT_DEG}")
    check(trans_last_quarter <= LEARN_TRANS,
          f"registration_learns: last-quarter translation error {trans_last_quarter}")
    check(np.isfinite(ev.mean_rot_error) and np.isfinite(ev.mean_trans_error)
          and ev.mean_rot_error < hist[0]["rot_error"],
          f"registration_learns: held-out rotation error {ev.mean_rot_error} against "
          f"{hist[0]['rot_error']} at epoch 1")
    return run["launches"]["sinkhorn_points"]


def phase_evaluate(dev, cfg, res, log_dir):
    """train/evaluate.py on the sinkhorn run's best-rotation checkpoint,
    the test split: on the card by default; both curves non-decreasing to
    1.0; five thresholds recounted one full pass each (the original
    harness's definition) equal the one-pass curve; the final state gives
    the same per-sample errors, bit for bit, from memory and from a
    checkpoint reloaded into a fresh state."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer
    from shwd_torch.train.evaluate import errors_step, evaluate
    from shwd_torch.utils import load_checkpoint, save_checkpoint
    models = f"{log_dir}/{cfg.experiment}/models"
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    t0 = time.perf_counter()
    out = evaluate(cfg, checkpoint=f"{models}/best_rot_error_snap",
                   save_clouds_to=f"{log_dir}/evaluate")
    secs = time.perf_counter() - t0
    check(torch.cuda.memory_stats(dev)["allocation.all.allocated"] > allocs,
          "evaluate: nothing ran on the card")
    for name, curve in (("rotation", out.rot_success_ratio),
                        ("translation", out.trans_success_ratio)):
        check(bool((np.diff(curve) >= 0).all()) and curve[-1] == 1.0,
              f"evaluate: the {name} curve is not non-decreasing to 1.0")
    # the original harness's definition: a full pass over the split per
    # threshold
    state = res["state"]
    ds = RegistrationDataset(cfg.dataset, "test")
    best = Trainer(cfg).init_state(torch.Generator(device=dev).manual_seed(0))
    load_checkpoint(f"{models}/best_rot_error_snap", best)
    rot_idx, trans_idx = (0, 10, 30, 90, 180), (1, 5, 10, 30, 100)
    recount = {}
    for which, idx, thresholds, curve in (
            (0, rot_idx, out.rot_thresholds, out.rot_success_ratio),
            (1, trans_idx, out.trans_thresholds, out.trans_success_ratio)):
        for i in idx:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed + 999)
            hits = total = 0
            for batch in ds.batches(gen, np.arange(len(ds)), cfg.batch_size,
                                    shuffle=False, drop_remainder=False):
                err = errors_step(best.model, batch, cfg.pcr_iteration_num)[which]
                hits += int((err.double() <= float(thresholds[i])).sum())
                total += err.shape[0]
            recount[f"{'rot' if which == 0 else 'trans'}_{thresholds[i]:g}"] = hits / total
            check(hits / total == curve[i],
                  f"evaluate: threshold {thresholds[i]}: one pass {curve[i]}, "
                  f"recount {hits / total}")
    mem = evaluate(cfg, state=state)
    save_checkpoint(f"{models}/final_state", state, cfg.num_epochs)
    disk = evaluate(cfg, checkpoint=f"{models}/final_state")
    check(np.array_equal(mem.per_sample_rot, disk.per_sample_rot)
          and np.array_equal(mem.per_sample_trans, disk.per_sample_trans),
          "evaluate: the reloaded checkpoint gives other per-sample errors")
    last = res["history"][-1]
    emit({"phase": "evaluate", "checkpoint": "best_rot_error_snap", "split": "test",
          "samples": int(out.per_sample_rot.shape[0]), "seconds": secs,
          "mean_rot_error": out.mean_rot_error, "mean_trans_error": out.mean_trans_error,
          "trainer_last_val_rot_error": last["rot_error"],
          "trainer_last_val_trans_error": last["trans_error"],
          "final_state_mean_rot_error": mem.mean_rot_error,
          "rot_success_at": {f"{out.rot_thresholds[i]:g}": out.rot_success_ratio[i]
                             for i in rot_idx},
          "trans_success_at": {f"{out.trans_thresholds[i]:g}": out.trans_success_ratio[i]
                               for i in trans_idx},
          "recount": recount, "reload_bitwise_equal": True})


def phase_data_parallel(dev, log_dir, sink_cfg, sink_res):
    """The parallel layer at world size 1 over NCCL (one card): Trainer.fit
    with mesh_data=1 for the first 4 epochs of phase registration's sinkhorn
    run (K3), fused (the train step captured with its 2 collectives), whose
    history must equal that run's bit for bit, K3 and the collectives
    counted as graph nodes x replays; ms per train step of fused fits with
    and without the mesh and of meshed per-step fits (held to the fused run
    at rtol 1e-4), two 9-epoch fits each, in turns; one eager train
    step's collectives (2); the sharded SSW, transport and distributed SSW
    against their unsharded port functions on the registration batch;
    sharded refinement (sinkhorn, K3, its own captured graphs) against
    refine_poses; the scaling harness at D = 1."""
    import torch.distributed as dist
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.ops import sinkhorn_fused as sp
    from shwd_torch.ops.costs import cost_matrix
    from shwd_torch.ops.sinkhorn import emd2_approx
    from shwd_torch.ops.spherical import sliced_cost_sphere, stiefel_frames
    from shwd_torch.parallel import (make_dist_ssw, make_mesh, make_points_mesh,
                                     make_sharded_ssw, make_sharded_transport,
                                     measure_scaling, sharded_refine_poses)
    from shwd_torch.parallel import mesh as pmesh
    from shwd_torch.train import pose_refine as pr
    from shwd_torch.train.pose_refine import PoseRefineConfig, refine_poses
    from shwd_torch.train.trainer import _mean_subtract
    rank_dev = pmesh.initialize_distributed()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_backend() == backend and dist.get_world_size() == 1
          and rank_dev == dev, f"data_parallel: group {dist.get_backend()}, "
          f"world {dist.get_world_size()}, device {rank_dev}")
    epochs = REG_EPOCHS["data_parallel"]
    cfg = dataclasses.replace(sink_cfg, experiment="data_parallel", num_epochs=epochs,
                              mesh_data=1)
    pmesh.collective_calls = 0
    run, trainer, res, ds = run_registration(dev, cfg)
    fit_collectives = pmesh.collective_calls
    check(trainer.mesh is not None and trainer._n_data == 1,
          "data_parallel: the trainer built no mesh")
    # fused under the mesh: K3 2 per train step and 1 per eval batch as
    # graph nodes, the step's 2 collectives recorded into the train graph
    check_fused_launches("data_parallel", run, "sinkhorn_points", 2, 1)
    train_graph = next(g for g in run["graphs"] if g["name"].startswith("train"))
    check(train_graph["collectives"] == 2,
          f"data_parallel: the train graph holds {train_graph['collectives']} collectives")
    # the graphs' collectives x (replays + warm-up run), and per epoch the
    # loss and the validation sums reduced once outside them
    want = (sum(g["collectives"] * (g["replays"] + 1) for g in run["graphs"])
            + 2 * len(run["history"]))
    check(fit_collectives == want, f"data_parallel: {fit_collectives} collectives in "
          f"the fit, the graphs and the epochs account for {want}")
    worst, bitwise = history_diff(res["history"], sink_res["history"][:epochs])
    check(bitwise, f"data_parallel: the meshed fused history is {worst} off the "
          "un-meshed fused run's")
    # ms per train step of fused fits without and with the mesh and of the
    # meshed per-step fit, in turns in this process (phase registration's
    # early epochs ran on a colder host); the per-step fit held to the
    # fused run's first 4 epochs
    turns = {"unmeshed": [], "meshed": [], "meshed_per_step": []}
    held = []
    for label in ("unmeshed", "meshed", "meshed_per_step") * 2:
        ab_cfg = dataclasses.replace(cfg, experiment=f"data_parallel_{label}",
                                     num_epochs=REG_EPOCHS["data_parallel_ab"],
                                     mesh_data=None if label == "unmeshed" else 1,
                                     fused_epoch=label != "meshed_per_step")
        ab, *_ = run_registration(dev, ab_cfg)
        turns[label] += ab["ms_per_train_step_by_epoch"]
        if label == "meshed_per_step":
            check(ab["path"] == "per_step: fused_epoch=False",
                  f"data_parallel: the per-step fit took {ab['path']}")
            diff, same = history_diff(ab["history"][:epochs], res["history"])
            held.append({"max_rel_diff": diff, "bitwise": same})
            check(diff <= 1e-4, f"data_parallel: the meshed per-step fit is {diff} off "
                  "the meshed fused run")
    ms = {k: statistics.median(v) for k, v in turns.items()}
    # one train step's collectives (the gradient bucket and phi's, 2 here)
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = next(ds.batches(gen, np.arange(REG_B), REG_B, shuffle=False))
    pmesh.collective_calls = 0
    with pmesh.data_parallel(trainer._data_group):
        trainer._train_step(res["state"], trainer._rows(batch))
    step_collectives = pmesh.collective_calls
    check(step_collectives == 2,
          f"data_parallel: an eager train step issued {step_collectives} collectives")

    # the sharded losses against their unsharded port functions
    mesh = make_mesh(data=1, slices=1, device=dev)
    source, target, _ = _mean_subtract(batch)
    frames = stiefel_frames(torch.Generator(device=dev).manual_seed(3), 100, device=dev)
    checks = {}
    ssw = make_sharded_ssw(mesh, p=2)(source, target, frames)
    want = torch.mean(sliced_cost_sphere(source, target, frames, p=2))
    checks["sharded_ssw"] = abs(float(ssw) - float(want)) / abs(float(want))
    tr = make_sharded_transport(mesh, cost="lp", p=2.0)(source, target)
    want = torch.mean(torch.clamp_min(emd2_approx(cost_matrix(source, target, "lp", 2.0)),
                                      1e-30) ** 0.5)
    checks["sharded_transport"] = abs(float(tr) - float(want)) / abs(float(want))
    dssw = make_dist_ssw(make_points_mesh(points=1, data=1, device=dev))(source, target,
                                                                         frames)
    want = torch.mean(sliced_cost_sphere(source, target, frames, p=1))
    checks["dist_ssw"] = abs(float(dssw) - float(want)) / abs(float(want))
    for name, err in checks.items():
        check(err <= 1e-5, f"data_parallel: {name} off its unsharded value by {err}")
    rcfg = PoseRefineConfig(loss="sinkhorn")
    pr.clear_cache()
    sp.sinkhorn_points.launches = 0
    t0 = time.perf_counter()
    sharded = sharded_refine_poses(mesh, source, target, rcfg)
    torch.cuda.synchronize(dev)
    refine_s = time.perf_counter() - t0
    refine_k3 = sp.sinkhorn_points.launches
    graphs = pr.cached_graphs()
    want = graph_launches(graphs, "sinkhorn_points")
    check(refine_k3 == want == rcfg.num_steps + 3,
          f"data_parallel: sharded refinement launched K3 {refine_k3} times, its "
          f"graphs account for {want}")
    whole = refine_poses(source, target, rcfg)
    pr.clear_cache()
    refine_err = float((sharded.pose_7d - whole.pose_7d).abs().max())
    check(torch.allclose(sharded.pose_7d, whole.pose_7d, rtol=1e-4, atol=1e-5),
          f"data_parallel: sharded refinement off refine_poses by {refine_err}")
    t0 = time.perf_counter()
    (point,) = measure_scaling([1], per_device_batch=REG_B, n_points=REG_N,
                               verbose=False, device=dev)
    scaling_s = time.perf_counter() - t0
    check(point.clouds_per_second > 0 and point.efficiency == 1.0,
          f"data_parallel: scaling point {point}")
    emit({"phase": "data_parallel", "backend": dist.get_backend(),
          "world_size": dist.get_world_size(), "mesh": "data=1, slices=1",
          "run": run, "history_max_rel_diff_vs_unmeshed": worst,
          "history_bitwise_equal": bitwise,
          "ms_per_train_step_in_turns": {"median": ms,
                                         "quartiles": {k: quartiles(v)
                                                       for k, v in turns.items()},
                                         "epochs": turns},
          "meshed_per_step_held_to_fused": held,
          "collectives_in_fit": fit_collectives,
          "collectives_per_train_step": step_collectives,
          "sharded_rel_err": checks, "refine_k3_launches": refine_k3,
          "refine_graphs": graphs,
          "refine_seconds": refine_s, "refine_max_abs_diff": refine_err,
          "scaling": dataclasses.asdict(point), "scaling_seconds": scaling_s})
    dist.destroy_process_group()
    return run["launches"]["sinkhorn_points"] + refine_k3


def phase_sweep(dev, log_dir):
    """The sweep runner: a zip matrix of two 2-epoch experiments in this
    process (w_cos on sinkhorn, K3, and on hybrid, K2), one experiment in a
    child process pinned with CUDA_VISIBLE_DEVICES=0, then run_eval_sweep
    over all three; every eval_summary.json must be finite."""
    import json
    from shwd_torch.train.runner import matrix_to_configs, run_eval_sweep, run_sweep
    base = registration_config(log_dir, "sinkhorn", num_epochs=REG_EPOCHS["sweep"])
    matrix = {"experiment": ["sweep_sinkhorn", "sweep_hybrid"],
              "shwd.transport.solver": ["sinkhorn", "hybrid"]}
    configs = matrix_to_configs(matrix, base=base)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    results = run_sweep(configs, verbose=False)
    torch.cuda.synchronize(dev)
    inprocess_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    check(launches["sinkhorn_points"] > 0 and launches["auction_assignment"] > 0,
          f"sweep: launches {launches}")
    check(all(len(r["history"]) == REG_EPOCHS["sweep"] for r in results),
          "sweep: an in-process experiment did not run its epochs")
    child = registration_config(log_dir, "sinkhorn", num_epochs=REG_EPOCHS["sweep"],
                                experiment="sweep_subprocess")
    t0 = time.perf_counter()
    (child_res,) = run_sweep([child], mode="subprocess",
                             device_env=[{"CUDA_VISIBLE_DEVICES": "0"}], verbose=False)
    subprocess_s = time.perf_counter() - t0
    check(child_res.get("epochs") == REG_EPOCHS["sweep"],
          f"sweep: the child process returned {child_res}")
    names = [c.experiment for c in configs] + [child.experiment]
    t0 = time.perf_counter()
    evals = run_eval_sweep(names, log_dir=str(log_dir))
    eval_s = time.perf_counter() - t0
    for name in names:
        summary = json.loads((Path(log_dir) / name / "eval_summary.json").read_text())
        check(summary == evals[name] and all(np.isfinite(v) for v in summary.values()),
              f"sweep: eval_summary.json of {name}: {summary}")
    emit({"phase": "sweep", "experiments": names, "inprocess_seconds": inprocess_s,
          "subprocess_seconds": subprocess_s, "eval_seconds": eval_s,
          "launches": launches, "child_epochs": child_res["epochs"],
          "child_best_rot": child_res["best"]["rot"], "eval": evals})
    return launches


def phase_hpo(dev, log_dir):
    """The HPO study: 3 trials of registration_hpo_objective (cd, 2 epochs
    each, the reference's Chamfer study) with jsonl storage; the study
    re-created from its file replays the 3 trials and runs a 4th. The cd
    criterion is the dense differentiable Chamfer in both passes, as in the
    JAX package: no kernel may launch."""
    from shwd_torch.train.hpo import create_study, registration_hpo_objective
    storage = Path(log_dir) / "hpo" / "study.jsonl"
    base = registration_config(log_dir, "cd", "cd", experiment="hpo")
    objective = registration_hpo_objective(base, num_epochs=REG_EPOCHS["hpo"])
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    study = create_study("hpo", storage=storage, seed=0)
    study.optimize(objective, n_trials=3, verbose=False)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    resumed = create_study("hpo", storage=storage, seed=0)
    check([t["params"] for t in resumed.trials] == [t["params"] for t in study.trials]
          and len(resumed.trials) == 3, "hpo: the resumed study did not replay 3 trials")
    t0 = time.perf_counter()
    resumed.optimize(objective, n_trials=4, verbose=False)
    fourth_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    values = [t["value"] for t in resumed.trials]
    check(len(resumed.trials) == 4 and all(t["state"] == "complete" for t in resumed.trials)
          and all(np.isfinite(values)), f"hpo: trials {resumed.trials}")
    check(not any(launches.values()), f"hpo: launches {launches}")
    emit({"phase": "hpo", "trials": len(resumed.trials), "values": values,
          "params": [t["params"] for t in resumed.trials],
          "best_value": resumed.best_value, "seconds_first_three": first_s,
          "seconds_fourth": fourth_s, "launches": launches})


def check_falling_rotation(label, run):
    check(run["val_rot_error_last"] < run["val_rot_error_first"],
          f"registration {label}: val rotation error did not fall "
          f"({run['val_rot_error_first']} -> {run['val_rot_error_last']})")


def phase_registration_pseudo(dev, log_dir):
    """pseudo_w_cos (two frozen Residual flows, max) on TrainConfig's
    default transport: K3 once per ensemble member per criterion call."""
    cfg = registration_config(log_dir, "pseudo", "pseudo_w_cos", pseudo_phi_num=2,
                              pseudo_combine="max")
    run, trainer, res, ds = run_registration(dev, cfg)
    run.update(profile_train_step(trainer, res["state"], ds))
    emit({"phase": "registration_pseudo", "batch": REG_B, "points": REG_N, "run": run})
    # K3 once per flow per criterion call: 2 per train step, 2 per eval
    # batch, as graph nodes (the profiled eager step's count is printed;
    # torch.profiler at times records no kernel once graphs were captured)
    check_fused_launches("pseudo", run, "sinkhorn_points", 2, 2)
    n_graphs = len(run["graphs"])
    want = 2 * run["train_steps"] + 2 * run["eval_batches"] + 2 * n_graphs
    check(run["launches"]["sinkhorn_points"] == want,
          f"registration_pseudo: K3 launched {run['launches']['sinkhorn_points']} "
          f"times, expected {want}")
    check_falling_rotation("pseudo", run)
    return run["launches"]["sinkhorn_points"], run


def phase_registration_max_ssw(dev, log_dir):
    """max_ssw with the mlp chart and variant P's knobs (512 projections,
    one ascent step, p = 1); the chart's clouds must lie on S^2."""
    from shwd_torch.losses import MaxSSWConfig
    from shwd_torch.train.trainer import _mean_subtract
    cfg = registration_config(log_dir, "max_ssw", "max_ssw", max_ssw_chart="mlp",
                              max_ssw=MaxSSWConfig(num_projections=512, max_iter=1,
                                                   phi_lr=9.213e-5, p=1.0))
    run, trainer, res, ds = run_registration(dev, cfg)
    run.update(profile_train_step(trainer, res["state"], ds))
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = next(ds.batches(gen, np.arange(REG_B), REG_B, shuffle=False))
    source, target, _ = _mean_subtract(batch)
    with torch.no_grad():
        (_, sx, sy), _ = trainer.crit_apply(res["state"].crit_state, target, source, False)
    off = max(float((torch.linalg.vector_norm(s, dim=-1) - 1).abs().max()) for s in (sx, sy))
    run["max_abs_norm_minus_1"] = off
    emit({"phase": "registration_max_ssw", "batch": REG_B, "points": REG_N, "run": run})
    check(off <= 1e-5, f"registration_max_ssw: chart output off S^2 by {off}")
    # the frames drawn inside the captured step, from the registered generator
    check(run["path"] == "fused", f"registration_max_ssw: path {run['path']}")
    check(not any(run["launches"].values()),
          f"registration_max_ssw: launches {run['launches']}")
    check_falling_rotation("max_ssw", run)


def phase_registration_ssw_1024(dev, log_dir):
    """w_cos on the ssw solver (geodesic, p = 2, 100 projections) at
    N = M = 1024: the p = 2 correlation branch of circle_ot on 12 800
    problems per solve; no transport kernel launches, phi's do."""
    from shwd_torch.losses import SHWDConfig, TransportConfig
    cfg = registration_config(
        log_dir, "ssw_1024", points=SSW_N,
        shwd=SHWDConfig(transport=TransportConfig(cost="geodesic", p=2.0, solver="ssw",
                                                  num_projections=100),
                        max_iter=1, lam=1.311e-5, phi_lr=9.213e-5,
                        phi_weight_decay=1.410e-8))
    run, trainer, res, ds = run_registration(dev, cfg)
    run.update(profile_train_step(trainer, res["state"], ds))
    emit({"phase": "registration_ssw_1024", "batch": REG_B, "points": SSW_N, "run": run})
    # no transport kernel; phi's kernels as its graphs' nodes times (replays +
    # warm-up), and its construction's power iteration
    for kernel, n in run["launches"].items():
        want = (graph_launches(run["graphs"], kernel)
                + (kernel == "residual_chain_power_iteration")
                if kernel.startswith("residual_chain") else 0)
        check(n == want, f"registration_ssw_1024: {kernel} launched {n} times, "
              f"expected {want}: launches {run['launches']}")
    check(run["path"] == "fused", f"registration_ssw_1024: path {run['path']}")


def phase_flow_ellipsoid(dev):
    """The ellipsoid_2 row of tools/flow_rows_torch.py: SHWD on the hybrid
    solver from the JAX row's own clouds (tools/flow_clouds_jax.npz, N =
    1000), the point lr cosine-decayed to 0.1x over 1000 iterations (a
    device tensor the scheduler fills between replays), W2 every 25,
    fused: final W2 <= 1e-3 (flow_parity.py's bar); 50 iterations of the
    per-step loop under the same schedule must give the fused run's points
    at iteration 50; K1 once and K2 twice a step, counted as graph nodes x
    (replays + the warm-up). Then the Chamfer-metric twin of SWD on the
    same clouds, 100 iterations, K4 every 25. Returns the launches."""
    from shwd_torch.ops.chamfer import chamfer_tiled
    from shwd_torch.ops.emd_exact import w2_exact
    from shwd_torch.train.flow_driver import run_flow
    flows = tool("flow_rows_torch")
    cfg = flows.flow_config("ellipsoid_2", "SHWD")
    src, tgt = flows.clouds("ellipsoid_2")
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    seen = []

    def eval_w2(p, t):
        if len(seen) < 3:
            seen.append(p.copy())
        return w2_exact(p, t)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_flow(src, tgt, cfg, eval_fn=eval_w2, device=dev)
    wall = time.perf_counter() - t0
    launches = {k: wrappers[k].launches for k in ("emd2_warmup", "auction_assignment")}
    at_50 = seen[2]
    tgt_dev = torch.as_tensor(tgt, device=dev)
    _, per_step = flow_per_step(dev, cfg, torch.as_tensor(src, device=dev), tgt_dev,
                                2 * cfg.eval_interval, True, 0)
    diff_50 = float(np.abs(per_step.cpu().numpy() - at_50).max())
    final = float(res.eval_values[-1])
    jax = flows.jax_row("ellipsoid_2", "SHWD", "w2")
    twin_cfg = dataclasses.replace(flows.flow_config("ellipsoid_2", "SWD", "cd"),
                                   num_iterations=100)
    chamfer_tiled.launches = 0
    twin = run_flow(src, tgt, twin_cfg, device=dev)
    k4 = chamfer_tiled.launches
    twin_jax = flows.jax_row("ellipsoid_2", "SWD", "cd")["final_cd"]
    emit({"phase": "flow_ellipsoid", "experiment": "ellipsoid_2", "points": len(src),
          "iterations": cfg.num_iterations, "lr_decay_alpha": cfg.lr_decay_alpha,
          "ms_per_iter": float(np.mean(res.interval_seconds)) / cfg.eval_interval * 1e3,
          "final_w2": final, "best_w2": float(np.min(res.eval_values)),
          "w2_curve": res.eval_values.tolist(), "jax_final_w2": jax["final_w2"],
          "points_at_50_max_abs_diff_vs_per_step": diff_50, "graph": res.graph,
          "launches": launches, "wall_seconds": wall,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
          "cd_twin": {"method": "SWD", "iterations": twin_cfg.num_iterations,
                      "cd_curve": twin.eval_values.tolist(), "launches": k4,
                      "jax_final_cd_at_1000": twin_jax}})
    check(res.path == "fused" and res.graph["captured"], f"flow_ellipsoid: path {res.path}")
    check(res.graph["nodes_by_kernel"] == {"emd2_warmup": 1, "auction_assignment": 2,
                                          **PHI_NODES},
          f"flow_ellipsoid: graph kernel nodes {res.graph['nodes_by_kernel']}")
    check(bool(np.isfinite(res.eval_values).all()) and np.isfinite(res.clouds).all(),
          "flow_ellipsoid: non-finite W2 or clouds")
    check(final <= 1e-3, f"flow_ellipsoid: final W2 {final} > 1e-3")
    check(diff_50 <= 1e-5, f"flow_ellipsoid: the per-step loop's points at iteration 50 "
          f"are {diff_50} off the fused run's")
    for k, v in launches.items():
        want = graph_launches([res.graph], k)
        check(v == want and v > 0, f"flow_ellipsoid: {k} launched {v} times, the graph "
              f"accounts for {want}")
    want = twin_cfg.num_iterations // twin_cfg.eval_interval + 1
    check(k4 == want, f"flow_ellipsoid: K4 launched {k4} times on the twin, expected {want}")
    check(bool(np.isfinite(twin.eval_values).all())
          and twin.eval_values[-1] < twin.eval_values[0],
          f"flow_ellipsoid: the twin's Chamfer metric did not fall {twin.eval_values}")
    return launches, k4


def phase_registration_outliers(dev, log_dir):
    """The robust_outliers_10 row of tools/registration_rows_torch.py (10
    source points of every cloud replaced by N(0, 1) draws, noise 0.02,
    w_cos on K3, the 2048-shape bank), seed REG_SEED, 20 epochs, fused:
    losses and errors finite, the validation rotation error below epoch
    1's, K3 twice per train step and once per eval batch as graph nodes x
    replays plus the warm-ups. Returns K3's launches."""
    rows = tool("registration_rows_torch")
    cfg = rows.row_config("robust_outliers_10", REG_SEED, str(log_dir), REG_EPOCHS["outliers"])
    check(cfg.dataset.transform.outlier_num == 10, "registration_outliers: no outliers")
    n_val = int(cfg.dataset.num_synthetic * cfg.dataset.val_split)
    run, _, _, _ = run_registration(dev, cfg, n_val_expected=n_val)
    check_fused_launches("outliers", run, "sinkhorn_points", 2, 1)
    want = 2 * run["train_steps"] + run["eval_batches"] + 2 + (len(run["graphs"]) - 1)
    emit({"phase": "registration_outliers", "row": "robust_outliers_10", "seed": cfg.seed,
          "epochs": run["epochs"], "val_rot_error_curve": run["val_rot_error_curve"],
          "best": run["best"], "ms_per_train_step": run["ms_per_train_step"],
          "peak_mem_bytes": run["peak_mem_bytes"],
          "k3_launches": run["launches"]["sinkhorn_points"], "k3_launches_expected": want})
    check(run["launches"]["sinkhorn_points"] == want,
          f"registration_outliers: K3 launched {run['launches']['sinkhorn_points']} "
          f"times, expected {want}")
    check(min(run["val_rot_error_curve"][1:]) < run["val_rot_error_first"],
          "registration_outliers: the validation rotation error never fell below epoch 1's")
    return run["launches"]["sinkhorn_points"]


def phase_jax_init(dev, log_dir):
    """The JAX package's seed-1234 initial states, loaded on the card by
    the row harness (``jax_init_state``): PCRNet's pose and each stored
    criterion's value on the file's check batch against the JAX package's
    (``jax_init_check``; JAX_INIT_POSE_TOL, JAX_INIT_VALUE_TOL); then
    JAX_INIT_EPOCHS epochs of w_cos from that state, written as an epoch-0
    checkpoint and loaded by the fit, on the 256-shape bank, fused: every
    metric finite, K3 twice per train step and once per eval batch as
    graph nodes x replays plus the warm-ups. The check's w_cos and
    pseudo_w_cos values must take K3: once for w_cos and once per frozen
    flow. Returns K3's launches in the fit."""
    from shwd_torch.ops import sinkhorn_fused as sp
    rows = tool("registration_rows_torch")
    checks = []
    sp.sinkhorn_points.launches = 0
    values = rows.jax_init_check(dev)
    check_k3 = sp.sinkhorn_points.launches
    check_k3_want = 1 + rows.row_config("pseudo_w_cos", 1234).pseudo_phi_num
    for name, port, want in values:
        port = port.reshape(want.shape)
        tol = JAX_INIT_POSE_TOL if name in ("est_R", "est_t") else JAX_INIT_VALUE_TOL
        checks.append({"name": name, "max_abs_err": float(np.max(np.abs(port - want))),
                       "max_rel_err": float(np.max(np.abs(port - want)
                                                   / np.maximum(np.abs(want), 1e-30))),
                       "ok": bool(np.allclose(port, want, **tol)), "tol": tol})
    emit({"phase": "jax_init", "checks": checks, "k3_launches": check_k3,
          "k3_launches_expected": check_k3_want})
    for c in checks:
        check(c["ok"], f"jax_init: {c['name']} off the JAX package's by {c['max_abs_err']}")
    check(check_k3 == check_k3_want,
          f"jax_init: the check launched K3 {check_k3} times, expected {check_k3_want}")
    cfg = rows.row_config("w_cos", 1234, str(log_dir), JAX_INIT_EPOCHS)
    cfg = dataclasses.replace(cfg, experiment="jax_init", dataset=dataclasses.replace(
        cfg.dataset, num_synthetic=REG_SHAPES))
    cfg = rows.jax_init_config(cfg, "w_cos", dev)
    run, _, res, _ = run_registration(dev, cfg)
    check_fused_launches("jax_init", run, "sinkhorn_points", 2, 1)
    want = 2 * run["train_steps"] + run["eval_batches"] + 2 + (len(run["graphs"]) - 1)
    emit({"phase": "jax_init_fit", "row": "w_cos", "seed": cfg.seed, "init": "jax",
          "epochs": run["epochs"], "first_epoch": res["history"][0]["epoch"],
          "history": run["history"], "ms_per_train_step": run["ms_per_train_step"],
          "k3_launches": run["launches"]["sinkhorn_points"], "k3_launches_expected": want})
    check(res["history"][0]["epoch"] == 1 and run["epochs"] == JAX_INIT_EPOCHS,
          f"jax_init: the fit ran epochs {[r['epoch'] for r in res['history']]}")
    check(run["launches"]["sinkhorn_points"] == want,
          f"jax_init: K3 launched {run['launches']['sinkhorn_points']} times, expected {want}")
    return run["launches"]["sinkhorn_points"]


def phase_replay(dev, log_dir):
    """The w_cos row's config (tools/registration_rows_torch.py) on the
    256-shape bank, seed REG_SEED, REG_EPOCHS["replay"] epochs on the
    per-step path (the path a record runs; bit for bit the fused one,
    phase fused_vs_per_step): recorded (``FitRecorder``: the start state
    and every batch and draw) beside the same fit unrecorded, whose
    histories must be equal bit for bit; then ``replay_port`` of the
    record on the card, equal bit for bit too. K3 (counted from 0 before
    each of the three) twice per train step and once per eval batch.
    Returns K3's launches in the replay."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.ops import sinkhorn_fused as sp
    from shwd_torch.train import Trainer
    rows = tool("registration_rows_torch")
    cfg = rows.row_config("w_cos", REG_SEED, str(log_dir), REG_EPOCHS["replay"])
    cfg = dataclasses.replace(cfg, experiment="replay", fused_epoch=False,
                              dataset=dataclasses.replace(cfg.dataset, num_synthetic=REG_SHAPES))
    root = Path(log_dir) / "replay_record"
    ds = RegistrationDataset(cfg.dataset, "train")
    runs, launches = {}, {}
    for label in ("recorded", "unrecorded"):
        trainer = Trainer(cfg)
        recorder = None
        if label == "recorded":
            recorder = rows.FitRecorder(root, (0, cfg.num_epochs), start=True)
            recorder.attach(trainer)
        sp.sinkhorn_points.launches = 0
        res = trainer.fit(ds, verbose=False)
        torch.cuda.synchronize()
        launches[label] = sp.sinkhorn_points.launches
        runs[label] = res["history"]
        if recorder is not None:
            recorder.finish(res["history"], {"row": "w_cos", "seed": cfg.seed})
    record = rows.Record(root)
    sp.sinkhorn_points.launches = 0
    t0 = time.perf_counter()
    runs["replayed"], _, _ = rows.replay_port(record, dev)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches["replayed"] = sp.sinkhorn_points.launches
    hist = runs["recorded"]
    steps = sum(r["train_steps"] for r in hist)
    n_val = int(cfg.dataset.num_synthetic * cfg.dataset.val_split)
    want = 2 * steps + len(hist) * -(-n_val // cfg.batch_size)
    emit({"phase": "replay", "row": "w_cos", "seed": cfg.seed, "epochs": len(hist),
          "path": hist[0]["path"], "record_files": record.meta["files"],
          "record_bytes": sum(f.stat().st_size for f in root.iterdir()),
          "history": [{k: r[k] for k in HISTORY_KEYS} for r in hist],
          "unrecorded_equal": history_diff(runs["unrecorded"], hist)[1],
          "replayed_equal": history_diff(runs["replayed"], hist)[1],
          "replay_seconds": replay_s, "k3_launches": launches, "k3_launches_expected": want})
    check(hist[0]["path"].startswith("per_step"), f"replay: the recorded fit ran {hist[0]['path']}")
    check(all(np.isfinite(r[k]) for r in hist for k in HISTORY_KEYS),
          "replay: a non-finite metric in the recorded fit")
    for label in ("unrecorded", "replayed"):
        worst, same = history_diff(runs[label], hist)
        check(len(runs[label]) == len(hist) and same,
              f"replay: the {label} history is not the recorded one bit for bit "
              f"(largest relative difference {worst})")
    for label, n in launches.items():
        check(n == want, f"replay: K3 launched {n} times in the {label} run, expected {want}")
    return launches["replayed"]


def phase_sinkhorn_div_1024(dev, log_dir):
    """The w_cos_1024_sinkhorn_div row's config (the debiased Sinkhorn
    divergence, plain PyTorch in both packages: three (128, 1024, 1024)
    costs, 4 x 50 dual iterations each, two solves a train step) for
    REG_EPOCHS["sinkhorn_div"] epochs, fused, on a 256-shape bank (one
    train step and one 51-shape eval batch an epoch; the batch and the
    clouds are the row's). Losses finite; the peak device memory must be
    under a tenth of what the final solve's dual iterations would hold if
    autograd recorded them (~4 (B, N, M) tensors an iteration)."""
    rows = tool("registration_rows_torch")
    cfg = rows.row_config("w_cos_1024_sinkhorn_div", REG_SEED, str(log_dir),
                          REG_EPOCHS["sinkhorn_div"])
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset,
                                                               num_synthetic=REG_SHAPES))
    tp = cfg.shwd.transport
    b, n = cfg.batch_size, cfg.dataset.source_point_num
    recorded = 3 * (4 * tp.num_iters * tp.num_scales) * b * n * n * 4
    run, _, _, _ = run_registration(dev, cfg)
    emit({"phase": "sinkhorn_div_1024", "batch": b, "points": n, "epochs": run["epochs"],
          "ms_per_train_step": run["ms_per_train_step"],
          "ms_per_epoch": run["ms_per_epoch"], "wall_seconds": run["wall_seconds"],
          "peak_mem_bytes": run["peak_mem_bytes"],
          "recorded_duals_bytes": recorded, "history": run["history"],
          "launches": run["launches"], "path": run["path"]})
    check(run["path"] == "fused", f"sinkhorn_div_1024: path {run['path']}")
    check(run["peak_mem_bytes"] < recorded / 10,
          f"sinkhorn_div_1024: peak {run['peak_mem_bytes']} bytes, not under a tenth of "
          f"the recorded duals' {recorded}")


def phase_fit_memory(dev, log_dir):
    """Two short w_cos fits (K3) in one process: after the second, with its
    result held and after ``del``, torch.cuda.memory_allocated() is what
    it was after the first, and the second fit peaks at the first's, each
    within one allocator block (2 MiB)."""
    import gc
    block = 2 << 20
    cfg = registration_config(log_dir, "sinkhorn", num_epochs=REG_EPOCHS["fit_memory"],
                              experiment="fit_memory")
    marks = {"before": torch.cuda.memory_allocated(dev)}
    for i in (1, 2):
        run, trainer, res, ds = run_registration(dev, cfg)
        marks[f"fit{i}_held"] = torch.cuda.memory_allocated(dev)
        marks[f"fit{i}_peak"] = run["peak_mem_bytes"]
        del run, trainer, res, ds
        gc.collect()
        marks[f"fit{i}_after_del"] = torch.cuda.memory_allocated(dev)
    emit({"phase": "fit_memory", "epochs": cfg.num_epochs, "bytes": marks})
    for what in ("held", "peak", "after_del"):
        a, b = marks[f"fit1_{what}"], marks[f"fit2_{what}"]
        check(abs(b - a) <= block, f"fit_memory: {what} {b} bytes after the second fit, "
              f"{a} after the first")


def phase_fused_vs_per_step(dev, refs):
    """For w_cos/sinkhorn, w_cos/hybrid, cd and pseudo_w_cos: fits of 5
    epochs with fused_epoch False and True in turns (per-step, fused,
    per-step, fused), each fit's first 4 epochs held to the fused run of
    phase registration or registration_pseudo (rtol 1e-4; bitwise
    reported); ms per train step of each path over the turns' epochs after
    the first, with quartiles; the graph's kernel nodes per step and the
    idle share of one replayed train step on a fresh state."""
    from shwd_torch.data.transforms import RegistrationBatch
    out = {}
    for label, (cfg_ref, run_ref) in refs.items():
        ref = run_ref["history"][:HELD_EPOCHS]
        turns = {"per_step": [], "fused": []}
        held = []
        for i, path in enumerate(("per_step", "fused", "per_step", "fused")):
            cfg = dataclasses.replace(cfg_ref, experiment=f"turn_{label}_{i}",
                                      num_epochs=REG_EPOCHS["turns"],
                                      fused_epoch=path == "fused")
            run, trainer, res, ds = run_registration(dev, cfg)
            check(run["path"].startswith(path), f"turns {label}: path {run['path']}")
            worst, bitwise = history_diff(run["history"][:HELD_EPOCHS], ref)
            held.append({"path": path, "max_rel_diff": worst, "bitwise": bitwise})
            check(worst <= 1e-4, f"turns {label} {path}: the first {HELD_EPOCHS} epochs "
                  f"are {worst} off the fused run")
            turns[path] += run["ms_per_train_step_by_epoch"]
        # one replayed train step on a fresh state (the last fit's trainer)
        state = trainer.init_state(torch.Generator(device=dev).manual_seed(7))
        gen = torch.Generator(device=dev).manual_seed(7)
        batch = next(ds.batches(gen, np.arange(REG_B), REG_B, shuffle=False))
        fused = trainer._graphs_for(state)

        def step(*inputs):
            fused["loss_sum"].add_(trainer._train_step(state, RegistrationBatch(*inputs)))

        graph = trainer._step_graph(state, ("train", True), step, batch)
        replay = replay_profile(graph, tuple(batch))
        trainer._fused = {}
        fused_ms = statistics.median(turns["fused"])
        replay["idle_share_of_step"] = 1 - replay["busy_ms"] / fused_ms
        train_graph = next(g for g in run_ref["graphs"] if g["name"].startswith("train"))
        out[label] = {"ms_per_train_step": {k: statistics.median(v) for k, v in turns.items()},
                      "quartiles": {k: quartiles(v) for k, v in turns.items()},
                      "epochs": turns, "held_to_fused_run": held,
                      "train_graph": train_graph, "replayed_step": replay,
                      "eval_graphs": [g for g in run_ref["graphs"]
                                      if g["name"].startswith("eval")]}
    emit({"phase": "fused_vs_per_step", "batch": REG_B, "points": REG_N,
          "criteria": out})
    return out


FLOW_METHODS = ("SWD", "MSWD", "SSWD", "SSWD_W1", "CD", "W2", "GSWD_POLY", "GSWD_POLY3",
                "MGSWD_POLY", "GSWD_CIRC", "MGSWD_CIRC", "ASWD", "DSWD", "GSW_NN",
                "MGSW_NN")
# the methods whose step runs an inner Adam ascent (captured since it is a
# functional Adam): held bit for bit to the per-step loop
INNER_ASCENT = ("MSWD", "MGSWD_POLY", "MGSWD_CIRC", "ASWD", "DSWD", "MGSW_NN")
# the JAX package's flow rows (a TPU run, other random streams): the port's
# W2 must end within 3x of the row at the same iteration
JAX_FLOW_ROWS = "benchmarks/results_cube.json"
JAX_ROW_NAME = {"W2": "W2-direct"}
JAX_FLOW_W2_START = 0.35358       # the JAX rows' W2 at iteration 0


def jax_flow_rows():
    from pathlib import Path
    rows = json.loads((Path(__file__).resolve().parent / JAX_FLOW_ROWS).read_text())
    return {r["method"]: r for r in rows}


def jax_w2_at(row, iteration):
    """The JAX row's W2 at ``iteration`` (its curve, or its final value at
    its last iteration, 400)."""
    if row.get("eval_iters"):
        return row["eval_curve"][row["eval_iters"].index(iteration)]
    return row["final_w2"] if iteration == 400 else None


def profiled_flow_step(cfg, dev, clouds, tgt):
    """Device kernels of one step of ``cfg``'s method from ``clouds``, on a
    fresh state: the longest of three traced steps (torch.profiler on the
    card at times drops kernel records; PERF.md section 7)."""
    from shwd_torch.train.flow_driver import _make_loss_step, _make_point_opt
    init_state, step = _make_loss_step(cfg, dev)
    state = init_state(torch.Generator(device=dev).manual_seed(cfg.seed))
    points = torch.as_tensor(clouds, device=dev).clone().requires_grad_(True)
    state["opt"], state["sched"] = _make_point_opt(cfg, points)
    return max((device_kernels(lambda: step(points, tgt, state)) for _ in range(3)), key=len)


def phase_flow_methods(dev):
    """The 15 methods of run_flow beside SHWD at the Flow_cube width with
    the notebooks' settings (1200 points, lr 0.01, 100 projections, seed 0,
    400 iterations), exact W2 every 50: ms per iteration, launches and
    device busy ms of one profiled step, peak memory. Every W2 finite; the
    final W2 within 3x of the JAX row at iteration 400; below the start
    value for every method whose JAX row ends below it. Every method runs
    fused (its directions drawn inside the captured step from the
    registered generator; the six with an inner Adam ascent through its
    functional Adam) and must give, at iteration 50, the points of 50
    iterations of the per-step loop from the same start: within 1e-5, and
    bit for bit for the six inner-ascent methods."""
    from shwd_torch.ops.emd_exact import w2_exact
    from shwd_torch.train.flow_driver import run_flow
    src, tgt = flow_clouds(dev)
    rows = jax_flow_rows()
    out = {}
    for method in FLOW_METHODS:
        cfg = dataclasses.replace(flow_config(), method=method)
        at_50 = []

        def eval_w2(p, t):
            if len(at_50) < 2:
                at_50.append(p.copy())
            return w2_exact(p, t)

        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_flow(src.cpu().numpy(), tgt.cpu().numpy(), cfg, eval_fn=eval_w2,
                       device=dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        twin = None
        if res.path == "fused":
            step_res = run_flow(src.cpu().numpy(), tgt.cpu().numpy(),
                                dataclasses.replace(cfg, num_iterations=cfg.eval_interval),
                                device=dev, fused=False)
            diff = float(np.abs(step_res.clouds - at_50[1]).max())
            twin = {"points_at_50_max_abs_diff": diff,
                    "per_step_ms_per_iter": float(np.mean(step_res.interval_seconds))
                    / cfg.eval_interval * 1e3}
            check(diff <= 1e-5, f"flow {method}: the per-step loop's points at "
                  f"iteration 50 are {diff} off the fused run's")
            check(diff == 0.0 or method not in INNER_ASCENT,
                  f"flow {method}: the per-step loop's points at iteration 50 are "
                  f"{diff} off the fused run's, not bit for bit")
        kernels = profiled_flow_step(cfg, dev, res.clouds, tgt)
        per_iter = res.interval_seconds / cfg.eval_interval * 1e3
        row = rows.get(JAX_ROW_NAME.get(method, method))
        want = jax_w2_at(row, cfg.num_iterations) if row else None
        final = float(res.eval_values[-1])
        out[method] = {
            "path": res.path, "graph": res.graph, "per_step_twin": twin,
            "ms_per_iter": float(np.mean(per_iter)),
            "interval_ms_per_iter": per_iter.tolist(),
            "device_launches_per_step": len(kernels),
            "device_busy_ms_per_step": sum(ms for _, ms in kernels),
            "peak_mem_bytes": peak, "flops_per_step": res.flops_per_step,
            "w2_curve": res.eval_values.tolist(), "final_w2": final,
            "jax_row_w2_at_400": want, "wall_seconds": wall}
        check(res.path == "fused" and res.graph["captured"], f"flow {method}: path {res.path}")
        check(bool(np.isfinite(res.eval_values).all()), f"flow {method}: non-finite W2")
        check(np.isfinite(res.clouds).all(), f"flow {method}: non-finite clouds")
        if want is not None:
            check(final <= 3.0 * want,
                  f"flow {method}: final W2 {final} above 3x the JAX row's {want}")
            if want < JAX_FLOW_W2_START:
                check(final < float(res.eval_values[0]),
                      f"flow {method}: final W2 {final} not below the start")
    emit({"phase": "flow_methods", "points": FLOW_N, "iterations": 400,
          "eval_interval": 50, "methods": out})
    return out


def phase_flow_cd_twins(dev):
    """The Chamfer-metric twins (benchmarks/results_cube_cd.json's methods
    beside SHWD), 100 iterations each with eval_metric="cd": K4 records the
    metric at iteration 0 and every 25; it must be finite, and fall where
    the JAX row ends below this run's start (SSWD, blind to the radius,
    ends above it in the JAX rows too)."""
    from pathlib import Path

    from shwd_torch.ops.chamfer import chamfer_tiled
    from shwd_torch.train.flow_driver import run_flow
    src, tgt = flow_clouds(dev)
    rows = {r["method"]: r for r in json.loads(
        (Path(__file__).resolve().parent / "benchmarks/results_cube_cd.json").read_text())}
    out, total = {}, 0
    for method in ("SWD", "ASWD", "SSWD", "CD"):
        cfg = dataclasses.replace(flow_config(), method=method, num_iterations=100,
                                  eval_interval=25, eval_metric="cd")
        chamfer_tiled.launches = 0
        res = run_flow(src.cpu().numpy(), tgt.cpu().numpy(), cfg, device=dev)
        launches = chamfer_tiled.launches
        total += launches
        out[method] = {"cd_curve": res.eval_values.tolist(), "launches": launches,
                       "jax_row_final_cd_at_400": rows[method]["final_cd"],
                       "ms_per_iter": float(np.mean(res.interval_seconds))
                       / cfg.eval_interval * 1e3}
    emit({"phase": "flow_cd_twins", "iterations": 100, "methods": out})
    for method, r in out.items():
        curve = r["cd_curve"]
        check(r["launches"] == 100 // 25 + 1,
              f"flow_cd_twins {method}: K4 launched {r['launches']}")
        check(bool(np.isfinite(curve).all()), f"flow_cd_twins {method}: non-finite")
        if r["jax_row_final_cd_at_400"] < curve[0]:
            check(curve[-1] < curve[0], f"flow_cd_twins {method}: the Chamfer metric did not fall")
    return total


def phase_pose_refine(dev, cfg, log_dir):
    """Coarse to fine: the sinkhorn run's best-rotation PCRNet on the first
    train batch (B=128, N=128), then refine_model_output with loss
    "sinkhorn" (K3 and its envelope gradient), "cd" and "ssw", 100 steps at
    lr 0.01 each. Fused (the default): the refine step and the final
    objective captured once (the first call) and replayed from the cache;
    then per-step and fused calls in turns (per-step, fused, per-step,
    fused), every one giving the first per-step call's poses, loss trace and
    per-object losses bit for bit. K3 counted exactly on every call: graph
    nodes x replays, plus each graph's warm-up run on the capturing call;
    num_steps + 1 on a per-step call. The objective must fall, the batch's
    median rotation error must not rise, every value is finite."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.ops import sinkhorn_fused as sp
    from shwd_torch.ops.quaternion import rotation_error_deg
    from shwd_torch.train import Trainer
    from shwd_torch.train import pose_refine as pr
    from shwd_torch.train.trainer import _mean_subtract
    from shwd_torch.utils import load_checkpoint
    state = Trainer(cfg).init_state(torch.Generator(device=dev).manual_seed(0))
    load_checkpoint(f"{log_dir}/{cfg.experiment}/models/best_rot_error_snap", state)
    ds = RegistrationDataset(cfg.dataset, "train")
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    batch = next(ds.batches(gen, np.arange(REG_B), REG_B, shuffle=False))
    source, target, _ = _mean_subtract(batch)
    with torch.no_grad():
        est = state.model(target, source, cfg.pcr_iteration_num)
    before = rotation_error_deg(batch.igt_rotation, est.est_R)

    def call(rcfg, fused):
        sp.sinkhorn_points.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = pr.refine_model_output(source, target, est.est_R, est.est_t, rcfg, fused=fused)
        torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0, sp.sinkhorn_points.launches

    runs, k3 = {}, 0
    for loss in ("sinkhorn", "cd", "ssw"):
        rcfg = pr.PoseRefineConfig(loss=loss)
        steps = rcfg.num_steps
        pr.clear_cache()
        res, capture_s, first = call(rcfg, True)
        graphs = pr.cached_graphs()
        nodes = [g["nodes_by_kernel"].get("sinkhorn_points", 0) for g in graphs]
        check([g["name"].split(" of")[0] for g in graphs] == ["refine step", "refine final"]
              and all(g["captured"] for g in graphs), f"pose_refine {loss}: graphs {graphs}")
        check(nodes == ([1, 1] if loss == "sinkhorn" else [0, 0]),
              f"pose_refine {loss}: K3 nodes {nodes}")
        want = nodes[0] * (steps + 1) + nodes[1] * 2        # replays + warm-ups
        check(first == want, f"pose_refine {loss}: K3 launched {first} on the capturing "
              f"call, the graphs account for {want}")
        ref, times = None, {"per_step": [], "fused": []}
        for path in ("per_step", "fused", "per_step", "fused"):
            out, secs, launches = call(rcfg, path == "fused")
            want = (steps + 1) if loss == "sinkhorn" else 0
            check(launches == want, f"pose_refine {loss} {path}: K3 launched {launches}, "
                  f"expected {want}")
            ref = out if ref is None else ref
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  f"pose_refine {loss} {path}: not the per-step call's numbers")
            times[path].append(secs / steps * 1e3)
        check(all(torch.equal(a, b) for a, b in zip(res, ref)),
              f"pose_refine {loss}: the capturing call is not the per-step call's numbers")
        # the replayed refine step: from a fresh start, so that the ~45
        # replays of the profile stay inside the loss trace
        (refinement,) = pr._CACHE.values()
        refinement.load(source, target, None, None)
        replay = replay_profile(refinement.captured()[0])
        replay["idle_share_of_step"] = 1 - replay["busy_ms"] / statistics.median(
            times["fused"])
        after = rotation_error_deg(batch.igt_rotation, res.est_R)
        losses = res.losses.cpu().numpy()
        runs[loss] = {
            "ms_per_step": times, "capturing_call_seconds": capture_s,
            "graphs": graphs, "k3_launches_capturing_call": first,
            "replayed_step": replay,
            "fused_bitwise_equal_to_per_step": True, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]),
            "median_rot_error_before": float(before.median()),
            "median_rot_error_after": float(after.median()),
            "mean_rot_error_before": float(before.mean()),
            "mean_rot_error_after": float(after.mean())}
        check(bool(np.isfinite(losses).all() and torch.isfinite(res.pose_7d).all()
                   and torch.isfinite(res.per_object_loss).all()),
              f"pose_refine {loss}: non-finite values")
        check(losses[-1] < losses[0], f"pose_refine {loss}: the objective did not fall")
        check(float(after.median()) <= float(before.median()),
              f"pose_refine {loss}: median rotation error rose "
              f"{float(before.median())} -> {float(after.median())}")
        k3 += first if loss == "sinkhorn" else 0
    pr.clear_cache()
    emit({"phase": "pose_refine", "batch": REG_B, "points": REG_N,
          "checkpoint": "best_rot_error_snap", "runs": runs})
    return k3


def phase_comparison(dev):
    """The metric sweeps on the 64 test shapes: rotation about x at 0-90
    deg in steps of 10 (W must rise with the angle), and translation at
    0-1 in steps of 0.25 (W must rise and stay within 10 % of the
    magnitude)."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train.comparison import rotation_sweep, translation_sweep
    cfg = registration_config("unused", "sinkhorn")
    clouds = RegistrationDataset(cfg.dataset, "test").targets.cpu().numpy()
    t0 = time.perf_counter()
    rot = rotation_sweep(clouds, np.arange(0.0, 91.0, 10.0))
    rot_s = time.perf_counter() - t0
    mags = np.arange(0.0, 1.01, 0.25)
    tr = translation_sweep(clouds, mags)
    emit({"phase": "comparison", "shapes": int(clouds.shape[0]), "rotation_seconds": rot_s,
          "rotation": {k: getattr(rot, k).tolist()
                       for k in ("grid", "chamfer", "sinkhorn", "wasserstein")},
          "translation": {k: getattr(tr, k).tolist()
                          for k in ("grid", "chamfer", "sinkhorn", "wasserstein")}})
    for r in (rot, tr):
        check(all(np.isfinite(getattr(r, k)).all()
                  for k in ("chamfer", "sinkhorn", "wasserstein")), "comparison: non-finite")
    check(bool((np.diff(rot.wasserstein) > 0).all()),
          f"comparison: W does not rise with the angle {rot.wasserstein.tolist()}")
    check(bool((np.diff(tr.wasserstein) > 0).all()
               and np.allclose(tr.wasserstein[1:], mags[1:], rtol=0.1)),
          f"comparison: W of a translation {tr.wasserstein.tolist()}")


def graph_nodes(fn) -> list[int]:
    """The node types (CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, ...)
    of a CUDA graph captured around one call of ``fn``, read with the
    driver's cuGraphGetNodes. ``fn`` runs once before, so nothing is built
    or first set up inside the capture."""
    from shwd_torch.utils.graphs import graph_node_types
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kinds = graph_node_types(graph)
    check(kinds is not None, "cuGraphGetNodes failed")
    del graph
    return kinds


def phase_launches_per_call(dev, kernels):
    """How many CUDA kernels one call of each wrapper launches, at its main
    path's shape: the kernel nodes of a CUDA graph captured around the
    call, which must be 1 and the graph's only node, for the warm-up, the
    auction (prices and eps0 given, as every main path gives them), the
    fused Sinkhorn, the Chamfer and phi's forward; the small-problem
    warm-up's graph holds its temperatures' torch ops besides (captured
    alone for the comparison). Runs after the main paths. (It read
    torch.profiler's timeline until PR 6; on the card that timeline at
    times held no kernel of these libraries at all, up to ten traces
    running, while it held PyTorch's own kernels.)"""
    from shwd_torch.flows import make_flow
    from shwd_torch.flows.residual import kernel_layers
    from shwd_torch.ops import auction as au
    from shwd_torch.ops import residual_chain as rc
    from shwd_torch.ops import sinkhorn_fused as sp
    from shwd_torch.ops import sinkhorn_kernels as sk
    from shwd_torch.ops.chamfer import chamfer_tiled
    from shwd_torch.ops.costs import cost_matrix
    from shwd_torch.ops.sinkhorn import eps_schedule
    src, tgt = flow_clouds(dev)
    phi_layers = kernel_layers(make_flow(
        "Residual", 5, generator=torch.Generator(device=dev).manual_seed(0)))
    phi_x = torch.cat([src, tgt]).contiguous()
    fx, fy = src[None].contiguous(), tgt[None].contiguous()
    flow_cost = cost_matrix(fx, fy, "lp", 2.0).contiguous()
    kw = dict(eps=1e-5, num_iters=40, num_scales=8)
    prices0 = (-sk.emd2_warmup(flow_cost, **kw)[2]).contiguous()
    eps0 = au._hybrid_eps0(flow_cost, EPS_FINAL)
    reg_x, reg_y = registration_clouds(dev)
    reg_cost = cost_matrix(reg_x, reg_y, "lp", 2.0).contiguous()
    calls = {
        "emd2_warmup": lambda: sk.emd2_warmup(flow_cost, **kw),
        "auction_assignment": lambda: au.auction_assignment(
            flow_cost, EPS_FINAL, max_sweeps=4000, prices0=prices0, eps0=eps0),
        "sinkhorn_points": lambda: sp._fused_forward(reg_x, reg_y, "lp", 2.0, **REG_SINK),
        "chamfer_tiled": lambda: chamfer_tiled(fx, fy),
        "residual_chain_forward": lambda: rc.chain_forward(phi_x, phi_layers),
        "sinkhorn_warm": lambda: sk.sinkhorn_warm(reg_cost, **REG_SINK)}
    # what a call runs besides its kernel: the small-problem warm-up's
    # temperatures (emd2_approx's torch expression)
    around = {"sinkhorn_warm": lambda: eps_schedule(reg_cost, REG_SINK["eps"],
                                                    REG_SINK["num_scales"])}
    seen = {}
    for k in kernels:
        kinds = graph_nodes(calls[k["name"]])
        seen[k["name"]] = kinds
        besides = graph_nodes(around[k["name"]]) if k["name"] in around else []
        if besides:
            seen[f"{k['name']} (its temperatures)"] = besides
        k["launches_per_call"] = kinds.count(0) - besides.count(0)
        check(sorted(kinds) == sorted(besides + [0]),
              f"{k['name']}: a call captured as graph nodes {kinds}, expected "
              f"one kernel node besides {besides}")
    emit({"phase": "launches_per_call", "graph_node_types": seen})


def main() -> int:
    import shwd_torch  # noqa: F401  (fails outside the repository)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    # the flow first: its kernels are built but not loaded, so its first
    # interval shows whether run_flow keeps the loading out of its window
    launches, captured = phase_flow(dev)
    flow_cost, k1 = check_warmup(dev)
    k2 = check_auction(dev, flow_cost)
    del flow_cost
    k3 = check_sinkhorn_points(dev)
    k4 = check_chamfer(dev)
    k5 = check_residual_chain(dev)
    k6 = check_sinkhorn_warm(dev)
    k1["launches"] = launches["emd2_warmup"]
    k2["launches"] = launches["auction_assignment"]
    check_auction_seeded(k2, captured)
    del captured
    k4["launches"] = phase_flow_cd(dev)
    phase_flow_methods(dev)
    k4["launches_cd_twins"] = phase_flow_cd_twins(dev)
    ellipsoid, k4["launches_ellipsoid_cd"] = timed(phase_flow_ellipsoid, dev)
    k1["launches_ellipsoid"] = ellipsoid["emd2_warmup"]
    k2["launches_ellipsoid"] = ellipsoid["auction_assignment"]
    with tempfile.TemporaryDirectory() as log_dir:
        reg_launches, (sink_cfg, sink_res), reg_runs = phase_registration(dev, log_dir)
        k2["launches_registration"] = reg_launches["auction_assignment"]
        k3["launches"] = reg_launches["sinkhorn_points"]
        k6["launches"] = reg_launches["sinkhorn_warm"]
        k3["launches_learns"] = phase_registration_learns(dev, log_dir)
        k3["launches_outliers"] = timed(phase_registration_outliers, dev, log_dir)
        k3["launches_jax_init"] = timed(phase_jax_init, dev, log_dir)
        k3["launches_replay"] = timed(phase_replay, dev, log_dir)
        phase_evaluate(dev, sink_cfg, sink_res, log_dir)
        k3["launches_data_parallel"] = phase_data_parallel(dev, log_dir, sink_cfg, sink_res)
        del sink_res
        sweep_launches = phase_sweep(dev, log_dir)
        k3["launches_sweep"] = sweep_launches["sinkhorn_points"]
        k2["launches_sweep"] = sweep_launches["auction_assignment"]
        phase_hpo(dev, log_dir)
        k3["launches_refine"] = phase_pose_refine(dev, sink_cfg, log_dir)
        k3["launches_pseudo"], pseudo_run = phase_registration_pseudo(dev, log_dir)
        phase_registration_max_ssw(dev, log_dir)
        phase_registration_ssw_1024(dev, log_dir)
        timed(phase_sinkhorn_div_1024, dev, log_dir)
        timed(phase_fit_memory, dev, log_dir)
        refs = {label: (registration_config(log_dir, label, criterion, solver),
                        reg_runs[label])
                for label, criterion, solver in (("sinkhorn", "w_cos", "sinkhorn"),
                                                 ("hybrid", "w_cos", "hybrid"),
                                                 ("cd", "cd", "sinkhorn"))}
        refs["pseudo"] = (registration_config(log_dir, "pseudo", "pseudo_w_cos",
                                              pseudo_phi_num=2, pseudo_combine="max"),
                          pseudo_run)
        phase_fused_vs_per_step(dev, refs)
    phase_comparison(dev)
    phase_launches_per_call(dev, [k1, k2, k3, k4, k5, k6])
    emit({"kernels": [k1, k2, k3, k4, k5, k6]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
