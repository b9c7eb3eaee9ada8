#!/usr/bin/env python3
"""The ellipsoid gradient flows of the JAX package, run by the port.

Counterpart of ``benchmarks/flow_parity.py ellipsoid|ellipsoid_2
[--eval-metric cd]``: deform a uniform ellipsoid cloud (N=1000) into a
biased one (``biased_scale`` 0.25, or 0.1 for ``ellipsoid_2``) by Adam on
the point coordinates, 1000 iterations, the metric every 25, for the five
methods with JAX rows (``benchmarks/results_ellipsoid*.json``): SHWD on
the ``hybrid`` exact-EMD solver (the Sinkhorn warm-up kernel and the
auction kernel; a cosine-decayed point lr to 0.1x on ``ellipsoid_2``, as
the JAX script sets it), ASWD, SWD, SSWD and CD. ``--eval-metric cd`` runs
the Chamfer-metric twins (the tiled Chamfer kernel every 25 iterations).

Every ``FlowConfig`` is ``flow_parity.py``'s ``base`` and method dict,
field by field. The clouds are the JAX script's own draws
(``jax.random.PRNGKey(0)``, split in two), read from
``tools/flow_clouds_jax.npz`` (written by ``tests/write_flow_clouds.py``):
the port runs no JAX, and its generators draw other streams.

One JSON row per (experiment, method, metric) is merged into ``--out``,
with ``bench.py``-style keys (``final_w2``/``final_cd``, ``best_*``,
``sec_per_iter``, the curve), the kernels' launches, the card's line, the
JAX row and the bar it is held to: final W2 <= 1e-3 for SHWD
(``flow_parity.py``'s parity bar), else the final value <= 3x the JAX
row's, and below the start wherever the JAX row ends below it.

    python3 tools/flow_rows_torch.py --experiments ellipsoid ellipsoid_2
    python3 tools/flow_rows_torch.py --eval-metric cd
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from registration_rows_torch import card_line, source_digest  # noqa: E402

CLOUDS = Path(__file__).resolve().parent / "flow_clouds_jax.npz"
EXPERIMENTS = {"ellipsoid": 0.25, "ellipsoid_2": 0.1}      # -> the target's biased_scale
ITERATIONS, EVAL_INTERVAL = 1000, 25
METHODS = ("SHWD", "ASWD", "SWD", "SSWD", "CD")
SHWD_W2_BAR = 1e-3          # flow_parity.py's parity bar on final W2
JAX_FACTOR = 3.0            # the other rows: within 3x of the JAX row


def flow_config(experiment: str, method: str, eval_metric: str = "w2"):
    """``flow_parity.py``'s ``FlowConfig`` of ``method`` on ``experiment``:
    its ``base`` (1000 iterations, W2 every 25) and the method's dict."""
    from shwd_torch.train.flow_driver import FlowConfig
    base = dict(num_iterations=ITERATIONS, eval_interval=EVAL_INTERVAL,
                lr=0.01, num_projections=100, shwd_layers=5, shwd_lam=0.1,
                shwd_max_iter=1, shwd_phi_lr=0.001, shwd_phi_wd=0.1, seed=0,
                eval_metric=eval_metric)
    over = {"method": method}
    if method == "SHWD":
        over["shwd_solver"] = "hybrid"
        if experiment == "ellipsoid_2":
            over["lr_decay_alpha"] = 0.1
    return FlowConfig(**{**base, **over})


def clouds(experiment: str):
    """The JAX script's (source, target) of ``experiment``, (N, 3) f32."""
    with np.load(CLOUDS) as f:
        return f[f"{experiment}_source"], f[f"{experiment}_target"]


def jax_row(experiment: str, method: str, eval_metric: str) -> dict:
    suffix = "" if eval_metric == "w2" else f"_{eval_metric}"
    rows = json.loads((ROOT / "benchmarks" / f"results_{experiment}{suffix}.json").read_text())
    rec = next(r for r in rows if r["method"] == method)
    return {k: v for k, v in rec.items() if k not in ("eval_iters", "total_s")}


def judge(row: dict) -> dict:
    """The row's bar, ``meets_bar`` and ``verdict``."""
    key = f"final_{row['eval_metric']}"
    final, start = row[key], row["eval_curve"][0]
    jax_final = row["jax_row"][key]
    if row["method"] == "SHWD" and row["eval_metric"] == "w2":
        bar = {key: SHWD_W2_BAR}
    else:
        bar = {key: JAX_FACTOR * jax_final}
        if jax_final < start:
            bar["below_start"] = start
    row["bar"] = bar
    row["meets_bar"] = bool(np.isfinite(row["eval_curve"]).all()) and all(
        final <= v if k == key else final < v for k, v in bar.items())
    row["verdict"] = "met" if row["meets_bar"] else "MISSED"
    return row


def run(experiment: str, method: str, eval_metric: str, args) -> dict:
    from shwd_torch.train.flow_driver import run_flow
    from shwd_torch.utils.graphs import kernel_wrappers
    cfg = flow_config(experiment, method, eval_metric)
    src, tgt = clouds(experiment)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_flow(src, tgt, cfg, device=dev)
    total = time.perf_counter() - t0
    key = f"final_{eval_metric}"
    row = {"experiment": experiment, "method": method, "eval_metric": eval_metric,
           "points": len(src), "iterations": cfg.num_iterations,
           "eval_interval": cfg.eval_interval, "lr_decay_alpha": cfg.lr_decay_alpha,
           key: float(res.eval_values[-1]),
           key.replace("final", "best"): float(np.min(res.eval_values)),
           "sec_per_iter": float(np.mean(res.interval_seconds)) / cfg.eval_interval,
           "total_s": total, "eval_iters": res.eval_iters.tolist(),
           "eval_curve": [float(v) for v in res.eval_values],
           "path": res.path, "graph": res.graph,
           "launches": {k: w.launches for k, w in wrappers.items() if w.launches},
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
           "card": card_line(), "source_sha256_16": source_digest(),
           "torch": torch.__version__, "commit": args.commit,
           "jax_row": jax_row(experiment, method, eval_metric)}
    return judge(row)


def load_rows(path) -> list:
    p = Path(path)
    return json.loads(p.read_text()) if p.exists() else []


def store(path, row: dict) -> None:
    ident = ("experiment", "method", "eval_metric")
    rows = [r for r in load_rows(path) if any(r[k] != row[k] for k in ident)]
    rows.append(row)
    rows.sort(key=lambda r: (list(EXPERIMENTS).index(r["experiment"]), r["eval_metric"],
                             METHODS.index(r["method"])))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(rows, indent=1) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--experiments", nargs="+", choices=list(EXPERIMENTS),
                    default=list(EXPERIMENTS))
    ap.add_argument("--methods", nargs="+", choices=METHODS, default=list(METHODS))
    ap.add_argument("--eval-metric", nargs="+", choices=("w2", "cd"), default=["w2"])
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="the card unless cpu (for tests)")
    ap.add_argument("--out", default=str(ROOT / "tools" / "flow_rows_h100.json"))
    ap.add_argument("--commit", default=None,
                    help="the commit the tree was taken from, recorded as given")
    args = ap.parse_args(argv)
    failed = False
    for experiment in args.experiments:
        for metric in args.eval_metric:
            for method in args.methods:
                row = run(experiment, method, metric, args)
                store(args.out, row)
                key = f"final_{metric}"
                print(json.dumps({k: row[k] for k in (
                    "experiment", "method", "eval_metric", key, "sec_per_iter",
                    "launches", "verdict")}), flush=True)
                failed |= not bool(np.isfinite(row["eval_curve"]).all())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
