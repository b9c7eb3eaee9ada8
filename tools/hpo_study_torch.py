#!/usr/bin/env python3
"""The JAX package's ``cd`` HPO study, run by the port in one process.

Counterpart of ``benchmarks/hpo_smoke.py 25 150 hpo_study_150ep``: a TPE
study (seed 0, the port's ``train/hpo.py``, whose suggestions are the JAX
sampler's for the same history) over Adam's lr and weight decay, each
trial a 150-epoch ``cd`` fit on 512 ``composite`` shapes (B=128, N=M=128,
noise 0.02, 3 pose iterations) through ``registration_hpo_objective``,
minimising the best validation rotation error. The base config is the
script's field by field; the trials run fused, as the JAX ones did
(``nan_guard`` is off in both).

Every trial is a fit in this process, so the device memory each one
leaves behind adds up: the study records the peak and the allocated
memory after every trial. It writes ``--out`` with the study's best
value and params, every trial's value, the JAX study beside it and the
bar (1.5x its best, 11.90 deg); the study's jsonl goes to ``--storage``
(a study resumes from it).

    python3 tools/hpo_study_torch.py --out chiprun_out/hpo_study_h100.json

``--trials`` and ``--epochs`` cut a run (tests: ``--device cpu``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from registration_rows_torch import card_line, source_digest  # noqa: E402

JAX_STUDY = ROOT / "benchmarks" / "hpo_study_150ep.json"
TRIALS, EPOCHS, SHAPES = 25, 150, 512
BAR_FACTOR = 1.5


def base_config(name: str = "hpo_study_150ep", log_dir: str = "log"):
    """``hpo_smoke.py``'s base ``TrainConfig`` (its experiment is the study's
    name)."""
    from shwd_torch.data import DatasetConfig, TransformConfig
    from shwd_torch.train import TrainConfig
    return TrainConfig(
        experiment=name, log_dir=log_dir, criterion="cd",
        dataset=DatasetConfig(
            source_point_num=128, target_point_num=128, num_synthetic=SHAPES,
            synthetic_kinds=("composite",), cache_dir="modelnet_cache",
            transform=TransformConfig(noise_sigma=0.02)),
        batch_size=128, pcr_iteration_num=3)


def run(args) -> dict:
    from shwd_torch.train.hpo import create_study, registration_hpo_objective
    base = base_config(log_dir=args.log_dir)
    cuda = args.device is None
    objective = registration_hpo_objective(base, num_epochs=args.epochs,
                                           device=args.device)
    per_trial = []

    def measured(trial):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value = objective(trial)
        secs = time.perf_counter() - t0
        gc.collect()
        per_trial.append({
            "number": trial.number, "params": dict(trial.params), "value": value,
            "seconds": secs,
            "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
            "allocated_after_bytes": torch.cuda.memory_allocated() if cuda else None})
        return value

    study = create_study("cd_lr_wd", storage=args.storage, load_if_exists=True, seed=0)
    allocated_before = torch.cuda.memory_allocated() if cuda else None
    t0 = time.perf_counter()
    study.optimize(measured, n_trials=args.trials, verbose=False)
    total = time.perf_counter() - t0
    jax = json.loads(JAX_STUDY.read_text())
    bar = BAR_FACTOR * jax["best_value_rot_error_deg"]
    out = {
        "study": "cd_lr_wd", "n_trials": len(study.completed),
        "epochs_per_trial": args.epochs, "shapes": base.dataset.num_synthetic,
        "total_s": total,
        "best_value_rot_error_deg": study.best_value, "best_params": study.best_params,
        "all_values": [t["value"] for t in study.completed],
        "trials": per_trial, "allocated_before_bytes": allocated_before,
        "card": card_line(), "source_sha256_16": source_digest(),
        "torch": torch.__version__, "commit": args.commit,
        "jax_study": jax, "bar": {"best_value_rot_error_deg": bar}}
    out["meets_bar"] = out["best_value_rot_error_deg"] <= bar
    out["verdict"] = "met" if out["meets_bar"] else "MISSED"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=TRIALS)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="the card unless cpu (for tests)")
    ap.add_argument("--log-dir", default="log/hpo_study")
    ap.add_argument("--storage", default="log/hpo_study/hpo_study_150ep.jsonl")
    ap.add_argument("--out", default=str(ROOT / "tools" / "hpo_study_h100.json"))
    ap.add_argument("--commit", default=None,
                    help="the commit the tree was taken from, recorded as given")
    args = ap.parse_args(argv)
    out = run(args)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in ("n_trials", "best_value_rot_error_deg",
                                           "best_params", "total_s", "verdict")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
