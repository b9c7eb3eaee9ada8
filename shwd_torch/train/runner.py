"""Experiment sweep runner: train_RUNNER / test_RUNNER.

Counterpart of ``shwd_tpu/train/runner.py``. The reference orchestrates
experiments by editing dict-of-lists blocks inside ``train_RUNNER.py``
(:82-481) and spawning one ``subprocess.Popen`` per config pinned to a GPU
(:488-498); ``test_RUNNER.py`` later regex-scrapes run.log to recover each
experiment's flags (:244-292). Here the same capabilities are typed and
explicit:

- ``expand_matrix``: dict-of-lists -> list of override dicts. ``zip`` mode is
  the reference semantics (i-th entry of every list = experiment i); a
  ``product`` mode adds full-grid sweeps.
- ``apply_overrides``: path-addressed overrides ("dataset.noise_sigma") onto
  the frozen TrainConfig tree.
- ``run_sweep``: executes each experiment, in-process one after the other,
  or as bounded-concurrency child processes
  (``python -m shwd_torch.train.runner run-one``), each with its own
  ``device_env`` (e.g. ``CUDA_VISIBLE_DEVICES``, the reference's
  ``--cuda_num`` slot).
- ``run_eval_sweep``: the test_RUNNER: for every experiment directory it
  loads ``config.json`` (no log scraping) and evaluates the requested
  checkpoint family over the test split.

Every entry point runs on the card unless ``device`` names the CPU.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

from .config import TrainConfig, config_from_dict


# -- matrix expansion --------------------------------------------------------

def expand_matrix(matrix: Mapping[str, Sequence[Any]],
                  mode: str = "zip") -> list[dict]:
    """dict-of-lists -> list of {path: value} override dicts.

    ``zip``: experiment i takes element i of every list (reference semantics;
    lists of length 1 broadcast). ``product``: cartesian grid.
    """
    if not matrix:
        return []
    keys = list(matrix.keys())
    if mode == "zip":
        n = max(len(v) for v in matrix.values())
        for k, v in matrix.items():
            if len(v) not in (1, n):
                raise ValueError(
                    f"zip matrix: key {k!r} has {len(v)} entries, expected "
                    f"1 or {n}")
        return [{k: (matrix[k][0] if len(matrix[k]) == 1 else matrix[k][i])
                 for k in keys} for i in range(n)]
    if mode == "product":
        return [dict(zip(keys, combo))
                for combo in itertools.product(*(matrix[k] for k in keys))]
    raise ValueError(f"unknown expansion mode {mode!r}")


def apply_overrides(cfg: TrainConfig, overrides: Mapping[str, Any]):
    """Path-addressed immutable update: {"dataset.noise_sigma": 0.04, ...}."""
    tree: dict = {}
    for path, value in overrides.items():
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def rec(obj, upd):
        fields = {f.name for f in dataclasses.fields(obj)}
        kwargs = {}
        for k, v in upd.items():
            if k not in fields:
                raise KeyError(f"{type(obj).__name__} has no field {k!r}")
            cur = getattr(obj, k)
            if isinstance(v, dict) and dataclasses.is_dataclass(cur):
                kwargs[k] = rec(cur, v)
            else:
                kwargs[k] = v
        return dataclasses.replace(obj, **kwargs)

    return rec(cfg, tree)


def matrix_to_configs(matrix: Mapping[str, Sequence[Any]],
                      base: Optional[TrainConfig] = None,
                      mode: str = "zip") -> list[TrainConfig]:
    base = base or TrainConfig()
    return [apply_overrides(base, ov) for ov in expand_matrix(matrix, mode)]


# -- execution ---------------------------------------------------------------

def run_one(cfg: TrainConfig, verbose: bool = True, device=None) -> dict:
    """Train a single experiment in-process; returns the fit() summary."""
    from ..data.dataset import RegistrationDataset
    from .trainer import Trainer

    trainer = Trainer(cfg, device=device)
    train_ds = RegistrationDataset(cfg.dataset, "train", device=trainer.device)
    return trainer.fit(train_ds, verbose=verbose)


def run_sweep(configs: Sequence[TrainConfig], mode: str = "inprocess",
              max_concurrent: int = 4,
              device_env: Optional[Sequence[Mapping[str, str]]] = None,
              verbose: bool = True, device=None) -> list[dict]:
    """Run every experiment.

    ``inprocess``: one after the other, in this process, on ``device``.
    ``subprocess``: bounded-concurrency child processes, each given
    ``--device`` when ``device`` is set; ``device_env[i]`` supplies
    per-experiment environment variables (device pinning: the reference's
    ``--cuda_num`` slot). A child's result is its ``summary.json``
    (``{"best", "epochs"}``), or ``{"returncode": rc}`` when it wrote none.
    """
    if mode == "inprocess":
        results = []
        for cfg in configs:
            if verbose:
                print(f"=== experiment {cfg.experiment} ===")
            results.append(run_one(cfg, verbose=verbose, device=device))
        return results
    if mode != "subprocess":
        raise ValueError(f"unknown sweep mode {mode!r}")

    jobs: list[tuple[int, subprocess.Popen, Path]] = []
    results: list[Optional[dict]] = [None] * len(configs)

    def reap(block: bool):
        for i, proc, path in list(jobs):
            rc = proc.wait() if block else proc.poll()
            if rc is None:
                continue
            jobs.remove((i, proc, path))
            summary = path.parent / "summary.json"
            results[i] = (json.loads(summary.read_text())
                          if summary.exists() else {"returncode": rc})

    # the child imports this package from the checkout it came from
    package_root = str(Path(__file__).resolve().parents[2])
    for i, cfg in enumerate(configs):
        while len(jobs) >= max_concurrent:
            reap(block=False)
            if len(jobs) >= max_concurrent:
                time.sleep(0.5)
        cfg_path = Path(cfg.log_dir) / cfg.experiment / "config.json"
        cfg.save(cfg_path)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (package_root, env.get("PYTHONPATH")) if p)
        if device_env is not None and i < len(device_env):
            env.update(device_env[i])
        cmd = [sys.executable, "-m", "shwd_torch.train.runner",
               "run-one", "--config", str(cfg_path)]
        if device is not None:
            cmd += ["--device", str(device)]
        jobs.append((i, subprocess.Popen(cmd, env=env), cfg_path))
    try:
        reap(block=True)
    finally:
        for _, proc, _ in jobs:         # only after an interrupt
            proc.kill()
    return results  # type: ignore[return-value]


def run_eval_sweep(experiments: Sequence[str], log_dir: str = "log",
                   checkpoint_family: str = "best_model_snap",
                   save_artifacts: bool = True, device=None) -> dict:
    """test_RUNNER parity: evaluate each trained experiment on the test split
    from its own saved typed config, and write its ``eval_summary.json``.
    """
    from .evaluate import evaluate

    out = {}
    for name in experiments:
        exp_dir = Path(log_dir) / name
        cfg = TrainConfig.load(exp_dir / "config.json")
        ckpt = exp_dir / "models" / checkpoint_family
        res = evaluate(
            cfg, checkpoint=str(ckpt), split="test",
            save_clouds_to=str(exp_dir / "eval") if save_artifacts else None,
            device=device)
        out[name] = {"mean_rot_error": res.mean_rot_error,
                     "mean_trans_error": res.mean_trans_error}
        (exp_dir / "eval_summary.json").write_text(json.dumps(out[name]))
    return out


# -- CLI ---------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="shwd_torch.train.runner")
    sub = p.add_subparsers(dest="cmd", required=True)

    p_one = sub.add_parser("run-one", help="train one experiment from a "
                           "config.json (subprocess worker entry)")
    p_one.add_argument("--config", required=True)

    p_sweep = sub.add_parser("sweep", help="run a dict-of-lists matrix json")
    p_sweep.add_argument("--matrix", required=True,
                         help="json file: {overrides-path: [values...]}")
    p_sweep.add_argument("--mode", default="zip", choices=["zip", "product"])
    p_sweep.add_argument("--exec", dest="exec_mode", default="inprocess",
                         choices=["inprocess", "subprocess"])

    p_eval = sub.add_parser("eval", help="evaluate trained experiments")
    p_eval.add_argument("experiments", nargs="+")
    p_eval.add_argument("--log-dir", default="log")
    p_eval.add_argument("--family", default="best_model_snap")
    for q in (p_one, p_sweep, p_eval):
        q.add_argument("--device", default=None,
                       help="torch device, e.g. cpu or cuda:0 (default: the card)")

    args = p.parse_args(argv)
    if args.cmd == "run-one":
        cfg = TrainConfig.load(args.config)
        res = run_one(cfg, device=args.device)
        summary = {"best": res["best"],
                   "epochs": len(res["history"])}
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_rank() == 0:
            (Path(args.config).parent / "summary.json").write_text(
                json.dumps(summary))
        if dist.is_initialized():           # a data-parallel run's group
            dist.destroy_process_group()
        return 0
    if args.cmd == "sweep":
        matrix = json.loads(Path(args.matrix).read_text())
        configs = matrix_to_configs(matrix, mode=args.mode)
        run_sweep(configs, mode=args.exec_mode, device=args.device)
        return 0
    if args.cmd == "eval":
        out = run_eval_sweep(args.experiments, log_dir=args.log_dir,
                             checkpoint_family=args.family,
                             device=args.device)
        print(json.dumps(out, indent=2))
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
