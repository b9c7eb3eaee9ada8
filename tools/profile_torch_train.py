#!/usr/bin/env python3
"""Where a W_COS registration train step's time goes on the card (shwd_torch).

Builds the Trainer at the registration config (B=128, N=M=128, full-width
PCRNet with 3 pose iterations, 3 Residual flow layers, procedural shape
bank), takes ``--warm`` train steps, then times ``--steps`` more without the
profiler and profiles ``--steps`` more with torch.profiler. One JSON line
per case: ``w_cos`` on the ``sinkhorn`` and ``hybrid`` solvers, ``cd``,
``pseudo_w_cos`` (two frozen flows, max), ``max_ssw`` (mlp chart, 512
projections, p = 1) and ``w_cos`` on the ``ssw`` solver at N = M = 1024:

  - wall ms per step without the profiler (host clock, synchronised) and
    under it, device busy ms per step and the idle share;
  - device ms per step of K3 (the fused Sinkhorn kernel), K2 (the auction
    kernel), K4 (the Chamfer kernel; a train step launches none) and
    everything else; device launches per step; the top kernels by name.

    python3 tools/profile_torch_train.py [--warm 5] [--steps 10] [--trace DIR]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GROUPS = {"k3": ("sinkhorn_points",), "k2": ("auction_kernel",),
          "k4": ("chamfer",)}


def case_overrides(label):
    """(criterion, points or None for --points, TrainConfig fields) of a
    case."""
    from shwd_torch.losses import MaxSSWConfig, SHWDConfig, TransportConfig
    if label == "sinkhorn":
        return "w_cos", None, {}
    if label == "hybrid":
        return "w_cos", None, dict(shwd=SHWDConfig(
            transport=TransportConfig(cost="lp", p=2.0, solver="hybrid", eps=5e-3,
                                      num_iters=50, num_scales=4),
            max_iter=1, lam=1.3e-5, phi_lr=9.2e-5))
    if label == "pseudo":
        return "pseudo_w_cos", None, dict(pseudo_phi_num=2, pseudo_combine="max")
    if label == "max_ssw":
        return "max_ssw", None, dict(max_ssw_chart="mlp", max_ssw=MaxSSWConfig(
            num_projections=512, max_iter=1, phi_lr=9.213e-5, p=1.0))
    if label == "ssw_1024":
        return "w_cos", 1024, dict(shwd=SHWDConfig(
            transport=TransportConfig(cost="geodesic", p=2.0, solver="ssw",
                                      num_projections=100),
            max_iter=1, lam=1.311e-5, phi_lr=9.213e-5, phi_weight_decay=1.410e-8))
    return label, None, {}


CASES = ("sinkhorn", "hybrid", "cd", "pseudo", "max_ssw", "ssw_1024")


def make_config(log_dir, label, batch, points):
    from shwd_torch.data import DatasetConfig, TransformConfig
    from shwd_torch.losses import SHWDConfig, TransportConfig
    from shwd_torch.train import TrainConfig
    criterion, fixed, fields = case_overrides(label)
    points = fixed or points
    return TrainConfig(**{**dict(
        experiment="profile", log_dir=str(log_dir), criterion=criterion,
        batch_size=batch,
        dataset=DatasetConfig(
            source_point_num=points, target_point_num=points,
            num_synthetic=2 * batch, synthetic_kinds=("composite",),
            cache_dir="modelnet_cache",
            transform=TransformConfig(noise_sigma=0.02)),
        pcr_iteration_num=3,
        shwd=SHWDConfig(
            transport=TransportConfig(cost="lp", p=2.0, solver="sinkhorn",
                                      eps=5e-3, num_iters=50, num_scales=4),
            max_iter=1, lam=1.3e-5, phi_lr=9.2e-5),
        phi_num_flow_layer=3), **fields})


def profile_case(label, args, smi, log_dir):
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer

    cfg = make_config(log_dir, label, args.batch, args.points)
    trainer = Trainer(cfg)
    dev = trainer.device
    ds = RegistrationDataset(cfg.dataset, "train")
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(0)

    def batches(count):
        out = []
        while len(out) < count:
            out.extend(ds.batches(gen, np.arange(len(ds)), args.batch, rng=rng))
        return out[:count]

    def run(count):
        """``count`` train steps on ready batches; ms per step."""
        todo = batches(count)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in todo:
            loss = trainer._train_step(state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / count, float(loss)

    run(args.warm)
    wall_ms, loss = run(args.steps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_ms, _ = run(args.steps)

    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # device-side kernels and copies only: user annotations (such as
        # the optimizer's range) overlap the kernels they enclose
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and "#" not in ev.name):
            per_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3   # ms
            per_kernel[ev.name][1] += 1

    def group(names):
        return sum(v[0] for k, v in per_kernel.items()
                   if any(n in k for n in names)) / args.steps

    busy = sum(v[0] for v in per_kernel.values()) / args.steps
    parts = {k: group(names) for k, names in GROUPS.items()}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "case": label, "card": smi, "batch": args.batch,
        "points": cfg.dataset.source_point_num,
        "warm_steps": args.warm, "steps": args.steps, "loss": loss,
        "wall_ms_per_step": wall_ms,
        "clouds_per_second": args.batch / wall_ms * 1e3,
        "profiled_wall_ms_per_step": profiled_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1 - busy / wall_ms,
        "k3_ms_per_step": parts["k3"], "k2_ms_per_step": parts["k2"],
        "k4_ms_per_step": parts["k4"],
        "other_device_ms_per_step": busy - sum(parts.values()),
        "kernel_launches_per_step":
            sum(v[1] for v in per_kernel.values()) / args.steps,
        "top_kernels_ms_per_step": [
            {"name": k[:70], "ms": v[0] / args.steps, "calls": v[1] / args.steps}
            for k, v in top]}), flush=True)
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / f"train_{label}.json"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--points", type=int, default=128)
    ap.add_argument("--trace", type=str, default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as log_dir:
        for label in CASES:
            profile_case(label, args, smi, log_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
