"""Hyperparameter optimization: resumable study, no external dependency.

Counterpart of ``shwd_tpu/train/hpo.py`` (the reference's
``Optimize_hyperparameters/train_OPTUNA_CD.py``: Optuna's TPE over
log-uniform Adam lr/weight-decay, minimizing the mean rotation error of
short Chamfer trainings, resumable from its storage).

The study machinery is numpy only and copied as it is, so that the same
seed suggests the same parameters in both packages:
- ``Trial.suggest_loguniform / suggest_uniform / suggest_int /
  suggest_categorical``;
- a TPE-style sampler: after ``n_startup`` random trials, split completed
  trials into best-gamma / rest, fit kernel-density mixtures over each, and
  pick the candidate maximizing l(x)/g(x) (Bergstra et al.'s
  tree-structured Parzen estimator on flat spaces);
- jsonl storage with ``load_if_exists`` semantics: every finished trial is a
  line in ``<study>.jsonl``, in the JAX package's format, so a study written
  by either package resumes in the other. KeyboardInterrupt mid-optimize
  leaves the file consistent.

``registration_hpo_objective`` trains through the port's ``run_one``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np


class TrialPruned(Exception):
    """Raise inside an objective to discard the trial (optuna parity)."""


@dataclasses.dataclass
class Trial:
    number: int
    _sampler: "TPESampler"
    _study: "Study"
    params: dict = dataclasses.field(default_factory=dict)
    _dists: dict = dataclasses.field(default_factory=dict)

    def suggest_loguniform(self, name: str, low: float, high: float) -> float:
        v = self._sampler.sample(self._study, name,
                                 ("log", math.log(low), math.log(high)))
        self.params[name] = float(np.exp(v))
        self._dists[name] = ("log", low, high)
        return self.params[name]

    def suggest_uniform(self, name: str, low: float, high: float) -> float:
        v = self._sampler.sample(self._study, name, ("lin", low, high))
        self.params[name] = float(v)
        self._dists[name] = ("lin", low, high)
        return self.params[name]

    def suggest_int(self, name: str, low: int, high: int) -> int:
        v = self._sampler.sample(self._study, name, ("lin", low, high + 1))
        self.params[name] = int(min(high, math.floor(v)))
        self._dists[name] = ("int", low, high)
        return self.params[name]

    def suggest_categorical(self, name: str, choices: list) -> Any:
        idx = self._sampler.sample(self._study, name,
                                   ("lin", 0.0, float(len(choices))))
        pick = choices[int(min(len(choices) - 1, math.floor(idx)))]
        self.params[name] = pick
        self._dists[name] = ("cat", choices)
        return pick


class TPESampler:
    """Parzen-estimator sampler over each parameter independently.

    Internal space: log-params are sampled in log space, so one Gaussian-KDE
    routine covers both distributions.
    """

    def __init__(self, seed: int = 0, n_startup: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates

    def _internal(self, study: "Study", name: str):
        """(values_internal, losses) for completed trials that set `name`."""
        vals, losses = [], []
        for t in study.trials:
            if t["state"] != "complete" or name not in t["params"]:
                continue
            kind = t["dists"].get(name, ["lin"])[0]
            v = t["params"][name]
            if kind == "log":
                v = math.log(v)
            elif kind == "cat":
                choices = t["dists"][name][1]
                v = float(choices.index(v))
            vals.append(float(v))
            losses.append(t["value"])
        return np.asarray(vals), np.asarray(losses)

    def sample(self, study: "Study", name: str,
               dist: tuple[str, float, float]) -> float:
        _, low, high = dist
        vals, losses = self._internal(study, name)
        if len(vals) < self.n_startup:
            return float(self.rng.uniform(low, high))

        order = np.argsort(losses)
        n_best = max(1, int(np.ceil(self.gamma * len(vals))))
        best = vals[order[:n_best]]
        rest = vals[order[n_best:]]
        if rest.size == 0:
            rest = vals

        width = max(high - low, 1e-12)
        bw_best = max(1.06 * (np.std(best) + 1e-3 * width)
                      * len(best) ** -0.2, 1e-6 * width)
        bw_rest = max(1.06 * (np.std(rest) + 1e-3 * width)
                      * len(rest) ** -0.2, 1e-6 * width)

        def log_kde(x, centers, bw):
            d = (x[:, None] - centers[None, :]) / bw
            return (np.log(np.exp(-0.5 * d * d).mean(axis=1) + 1e-300)
                    - math.log(bw))

        # candidates from the "good" mixture + a uniform exploration tail
        n_c = self.n_candidates
        cand = np.concatenate([
            self.rng.choice(best, size=n_c) + bw_best * self.rng.normal(
                size=n_c),
            self.rng.uniform(low, high, size=max(2, n_c // 4)),
        ])
        cand = np.clip(cand, low, high)
        score = log_kde(cand, best, bw_best) - log_kde(cand, rest, bw_rest)
        return float(cand[int(np.argmax(score))])


@dataclasses.dataclass
class FrozenTrial:
    number: int
    value: float
    params: dict
    state: str


class Study:
    """Minimizing study with jsonl persistence (sqlite load_if_exists slot)."""

    def __init__(self, study_name: str, storage: Optional[str | Path] = None,
                 sampler: Optional[TPESampler] = None,
                 load_if_exists: bool = True, seed: int = 0):
        self.study_name = study_name
        self.sampler = sampler or TPESampler(seed=seed)
        self.trials: list[dict] = []
        self._path = Path(storage) if storage else None
        if self._path:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            if self._path.exists():
                if not load_if_exists:
                    raise FileExistsError(self._path)
                for line in self._path.read_text().splitlines():
                    if line.strip():
                        self.trials.append(json.loads(line))
                if self.trials:
                    # a resumed study must not replay the original seeded
                    # stream (it would re-draw the completed trials' exact
                    # params); fold the loaded-trial count into the seed so
                    # resumption continues with fresh, still-deterministic
                    # suggestions
                    self.sampler.rng = np.random.default_rng(
                        [seed, len(self.trials)])

    # -- results -------------------------------------------------------------

    @property
    def completed(self) -> list[dict]:
        return [t for t in self.trials if t["state"] == "complete"]

    @property
    def best_trial(self) -> FrozenTrial:
        done = self.completed
        if not done:
            raise ValueError("no completed trials")
        t = min(done, key=lambda t: t["value"])
        return FrozenTrial(t["number"], t["value"], t["params"], t["state"])

    @property
    def best_params(self) -> dict:
        return self.best_trial.params

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    # -- running -------------------------------------------------------------

    def _record(self, trial: Trial, value: Optional[float], state: str):
        row = {"number": trial.number, "value": value, "params": trial.params,
               "dists": {k: list(v) for k, v in trial._dists.items()},
               "state": state, "time": time.time()}
        self.trials.append(row)
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def optimize(self, objective: Callable[[Trial], float],
                 n_trials: int = 100, verbose: bool = True) -> None:
        start = len(self.trials)
        for _ in range(start, n_trials):
            trial = Trial(number=len(self.trials), _sampler=self.sampler,
                          _study=self)
            try:
                value = float(objective(trial))
            except TrialPruned:
                self._record(trial, None, "pruned")
                continue
            except KeyboardInterrupt:
                self._record(trial, None, "interrupted")
                raise
            self._record(trial, value, "complete")
            if verbose:
                b = self.best_value
                print(f"[{self.study_name}] trial {trial.number}: "
                      f"value={value:.6g} best={b:.6g} params={trial.params}")


def create_study(study_name: str, storage: Optional[str | Path] = None,
                 load_if_exists: bool = True, seed: int = 0) -> Study:
    return Study(study_name, storage=storage, load_if_exists=load_if_exists,
                 seed=seed)


# -- the reference's HPO objective (train_OPTUNA_CD.py:297-315) --------------

def registration_hpo_objective(base_cfg=None, num_epochs: int = 150,
                               verbose: bool = False, device=None):
    """Objective factory: suggested Adam lr/wd -> short CD training ->
    best validation rotation error (minimized). Ranges from
    train_OPTUNA_CD.py:310-315. Trains on the card unless ``device`` names
    the CPU.
    """
    from .config import TrainConfig
    from .runner import run_one

    base = base_cfg or TrainConfig(criterion="cd")

    def objective(trial: Trial) -> float:
        lr = trial.suggest_loguniform("adam_lr", 1e-7, 1e-1)
        wd = trial.suggest_loguniform("adam_weight_decay", 1e-15, 1e-3)
        cfg = dataclasses.replace(
            base, lr=lr, weight_decay=wd, num_epochs=num_epochs,
            experiment=f"{base.experiment}_hpo_t{trial.number}")
        res = run_one(cfg, verbose=verbose, device=device)
        return float(res["best"]["rot"])

    return objective
