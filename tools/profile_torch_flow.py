#!/usr/bin/env python3
"""Where a Flow_cube SHWD flow step's time goes on the card (shwd_torch).

Runs the flow at the benchmark config (1200 points, 5 Residual layers,
hybrid solver) for ``--warm`` steps, then profiles ``--steps`` more with
torch.profiler and prints JSON lines:

  - per-step wall time (host clock, synchronised) and device busy share;
  - device time per step of each kernel group: K1 (the warm-up kernels),
    K2 (the auction kernel), everything else, and the top kernels by name;
  - auction sweeps per solve over the profiled steps (cold inner solve and
    warm final solve).

    python3 tools/profile_torch_flow.py [--warm 100] [--steps 20] [--trace PATH]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

K1_KERNELS = ("warmup_kernel",)
K2_KERNELS = ("auction_kernel",)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=100)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n", type=int, default=1200)
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--trace", type=str, default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_flow: CUDA is not available", file=sys.stderr)
        return 1

    from shwd_torch.ops import auction as au
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    from shwd_torch.train import flow_driver as fd

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, args.n, device=dev)
    tgt = sample_cube_surface(rng, args.n, biased=True, device=dev)
    cfg = fd.FlowConfig(method="SHWD", num_iterations=400, eval_interval=50,
                        shwd_layers=args.layers, shwd_lam=0.1, shwd_max_iter=1,
                        shwd_phi_lr=0.001, shwd_phi_wd=0.1,
                        shwd_solver="hybrid", seed=0)
    init_state, step = fd._make_loss_step(cfg, dev)
    state = init_state(torch.Generator(device=dev).manual_seed(cfg.seed))
    points = src.clone().requires_grad_(True)
    state["opt"], state["sched"] = fd._make_point_opt(cfg, points)

    # record the sweeps of every auction launch (device tensors, read later)
    sweeps = []
    inner = au._auction_launch

    def recording(*a, **kw):
        out = inner(*a, **kw)
        sweeps.append(out[2])
        return out

    au._auction_launch = recording

    for _ in range(args.warm):
        step(points, tgt, state)
    torch.cuda.synchronize()
    sweeps.clear()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(points, tgt, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    au._auction_launch = inner

    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # device-side kernels and copies only: user annotations (such as
        # the optimizer's range) overlap the kernels they enclose
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and "#" not in ev.name):
            name = ev.name
            per_kernel[name][0] += ev.time_range.elapsed_us() / 1e3   # ms
            per_kernel[name][1] += 1

    def group(names):
        return sum(v[0] for k, v in per_kernel.items()
                   if any(n in k for n in names)) / args.steps

    busy = sum(v[0] for v in per_kernel.values()) / args.steps
    k1, k2 = group(K1_KERNELS), group(K2_KERNELS)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    s = torch.stack(sweeps).cpu().numpy().reshape(args.steps, 2, -1)[..., 0]
    print(json.dumps({"card": smi, "n": args.n, "layers": args.layers,
                      "warm_steps": args.warm, "profiled_steps": args.steps,
                      "wall_ms_per_step": wall_ms,
                      "device_busy_ms_per_step": busy,
                      "device_idle_share": 1 - busy / wall_ms,
                      "k1_ms_per_step": k1, "k2_ms_per_step": k2,
                      "other_device_ms_per_step": busy - k1 - k2,
                      "kernel_launches_per_step":
                          sum(v[1] for v in per_kernel.values()) / args.steps,
                      "sweeps_cold_mean": float(s[:, 0].mean()),
                      "sweeps_warm_mean": float(s[:, 1].mean()),
                      "sweeps_cold": s[:, 0].tolist(),
                      "sweeps_warm": s[:, 1].tolist()}))
    print(json.dumps({"top_kernels_ms_per_step": [
        {"name": k[:80], "ms": v[0] / args.steps, "calls": v[1] / args.steps}
        for k, v in top]}))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
