#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (shwd_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: nvcc for every kernel source in shwd_torch/csrc, in parallel;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the flow's shapes and a ragged/batched one, with timings;
  4. the slice: the Flow_cube SHWD gradient flow through
     shwd_torch.train.flow_driver.run_flow (1200 points, 5 Residual
     layers, hybrid exact-EMD solver, 400 iterations), with the kernels'
     launch counters reset just before and read just after; final exact
     W2 must be <= 1e-3;
then the kernel table ({"kernels": [...]}), the nvidia-smi line, and a
last line {"ok": true, "device": {...}}. Any failure raises: the script
exits non-zero and prints no result. Without CUDA, or without the
shwd_torch package beside it, it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
        torch.cuda.synchronize()
        for t in (v1, f1, g1):
            check(bool(torch.isfinite(t).all()), f"K1 {name}: non-finite output")
        val_rel = float(((v1 - v2).abs() / v2.abs()).max())
        f_err = float((f1 - f2).abs().max())
        g_err = float((g1 - g2).abs().max())
        check(val_rel <= 1e-3, f"K1 {name}: val rel err {val_rel}")
        check(f_err <= 1e-4 and g_err <= 1e-4, f"K1 {name}: f/g err {f_err} {g_err}")
        report[name] = {"val_rel_err": val_rel, "f_abs_err": f_err,
                        "g_abs_err": g_err}
    ms = time_ms(lambda: sk.emd2_warmup(flow_cost, **kw))
    plain_ms = time_ms(lambda: sk.emd2_warmup_reference(flow_cost, **kw))
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
          "bound_terms": terms,
          "launches_per_call": 2 * kw["num_iters"] * kw["num_scales"] + 2})
    err = max(max(r["f_abs_err"], r["g_abs_err"]) for r in report.values())
    return flow_cost, {"name": "emd2_warmup", "route": "cuda",
                       "source": "shwd_torch/csrc/emd2_warmup.cu",
                       "replaces": "shwd_tpu/ops/sinkhorn_pallas.py:402",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bnd, "bound_by": by, "library_ms": None}


def check_auction(dev, flow_cost):
    """K2 vs auction_assignment_reference: the flow shape from K1's warm
    prices (as the hybrid solver calls it), and a cold batch of four."""
    from shwd_torch.ops import auction as au
    from shwd_torch.ops import sinkhorn_kernels as sk
    _, _, g = sk.emd2_warmup(flow_cost, eps=1e-5, num_iters=40, num_scales=8)
    warm = dict(max_sweeps=4000, prices0=(-g).contiguous(),
                eps0=au._hybrid_eps0(flow_cost, EPS_FINAL))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 128, 3)).astype(np.float32)
    y = x + 0.05 * rng.normal(size=(4, 128, 3)).astype(np.float32)
    xs, ys = (torch.as_tensor(a, device=dev) for a in (x, y))
    cold_cost = ((xs[:, :, None] - ys[:, None]) ** 2).sum(-1).contiguous()
    cold = dict(max_sweeps=4000)
    report, flow_err, flow_rows, flow_sweeps = {}, 0.0, None, None
    for name, c, kw in (("flow_1x1200_warm", flow_cost, warm),
                        ("cold_4x128", cold_cost, cold)):
        a1, p1, s1 = au.auction_assignment(c, EPS_FINAL, **kw)
        a2, p2, s2 = au.auction_assignment_reference(c, EPS_FINAL, **kw)
        # the rows this solve scanned, for the byte bound (same inputs, so
        # the same deterministic run)
        rows = au._auction_launch(c, EPS_FINAL, 6.0, kw["max_sweeps"],
                                  kw.get("prices0"), kw.get("eps0"), None)[3]
        torch.cuda.synchronize()
        n = c.shape[-1]
        for row in a1.cpu().numpy():
            check(sorted(row.tolist()) == list(range(n)), f"K2 {name}: not a permutation")
        v1 = au._assignment_cost(c, a1).double().cpu().numpy()
        v2 = au._assignment_cost(c, a2).double().cpu().numpy()
        lsa = np.array([lsa_value(ci) for ci in c.cpu().numpy()])
        check(bool(np.all(np.abs(v1 - v2) <= n * EPS_FINAL)),
              f"K2 {name}: kernel {v1} vs plain {v2}")
        check(bool(np.allclose(v1, lsa, rtol=1e-4)), f"K2 {name}: {v1} vs exact {lsa}")
        same = bool(torch.equal(a1, a2))
        price_err = float((p1 - p2).abs().max())
        report[name] = {"same_assignment": same, "value_abs_err": float(np.abs(v1 - v2).max()),
                        "price_abs_err": price_err, "exact_rel_err":
                        float(np.abs(v1 / lsa - 1).max()),
                        "sweeps_kernel": s1.tolist(), "sweeps_plain": s2.tolist(),
                        "rows_scanned": rows.tolist()}
        if name.startswith("flow"):
            flow_err = float(np.abs(v1 - v2).max())
            flow_rows, flow_sweeps = int(rows.sum()), s1.tolist()
    ms = time_ms(lambda: au.auction_assignment(flow_cost, EPS_FINAL, **warm))
    plain_ms = time_ms(lambda: au.auction_assignment_reference(flow_cost, EPS_FINAL, **warm),
                       reps=5, warmup=1)
    n = flow_cost.shape[-1]
    # bytes: the cost, prices and eps0 read once, assignment, prices,
    # sweeps and rows written once (a row scanned again comes from L2);
    # ops: two passes of (negate-subtract, compare) over every entry of
    # the rows this run's sweeps and screens scanned
    bytes_moved = n * n * 4 + n * 4 + 4 + 2 * n * 4 + 8
    ops = flow_rows * n * 4
    bnd, by, terms = bound_ms(bytes_moved, ops)
    emit({"phase": "kernel_check", "kernel": "auction_assignment", "checks": report,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
          "bound_terms": terms,
          "flow_sweeps": flow_sweeps, "flow_rows_scanned": flow_rows})
    return {"name": "auction_assignment", "route": "cuda",
            "source": "shwd_torch/csrc/auction.cu",
            "replaces": "shwd_tpu/ops/auction.py:43",
            "max_abs_err": flow_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def phase_flow(dev):
    """The slice: run_flow at the Flow_cube benchmark config."""
    from shwd_torch.ops import auction as au
    from shwd_torch.ops import sinkhorn_kernels as sk
    from shwd_torch.train.flow_driver import FlowConfig, run_flow
    src, tgt = flow_clouds(dev)
    cfg = FlowConfig(method="SHWD", num_iterations=400, eval_interval=50,
                     num_projections=100, shwd_layers=5, shwd_lam=0.1,
                     shwd_max_iter=1, shwd_phi_lr=0.001, shwd_phi_wd=0.1,
                     shwd_solver="hybrid", seed=0)
    sk.emd2_warmup.launches = 0
    au.auction_assignment.launches = 0
    t0 = time.perf_counter()
    res = run_flow(src.cpu().numpy(), tgt.cpu().numpy(), cfg, device=dev)
    wall = time.perf_counter() - t0
    launches = {"emd2_warmup": sk.emd2_warmup.launches,
                "auction_assignment": au.auction_assignment.launches}
    ms_per_iter = float(np.mean(res.interval_seconds)) / cfg.eval_interval * 1e3
    final_w2 = float(res.eval_values[-1])
    emit({"phase": "flow", "ms_per_iter": ms_per_iter,
          "interval_ms_per_iter": (res.interval_seconds / cfg.eval_interval * 1e3).tolist(),
          "final_w2": final_w2, "best_w2": float(np.min(res.eval_values)),
          "w2_curve": res.eval_values.tolist(), "wall_seconds": wall,
          "launches": launches, "iterations": cfg.num_iterations,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    check(np.isfinite(res.clouds).all() and res.clouds.shape == (FLOW_N, 3),
          "flow: malformed clouds")
    check(all(v > 0 for v in launches.values()), f"flow: a kernel never ran {launches}")
    check(final_w2 <= 1e-3, f"flow: final W2 {final_w2} > 1e-3")
    return launches


def main() -> int:
    import shwd_torch  # noqa: F401  (fails outside the repository)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    flow_cost, k1 = check_warmup(dev)
    k2 = check_auction(dev, flow_cost)
    del flow_cost
    launches = phase_flow(dev)
    k1["launches"] = launches["emd2_warmup"]
    k2["launches"] = launches["auction_assignment"]
    emit({"kernels": [k1, k2]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
