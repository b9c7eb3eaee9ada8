"""The port's HPO study (``shwd_torch.train.hpo``) against the JAX
package's: the same suggestions from the same seed, one jsonl format that
either package resumes, and the registration objective on the CPU."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import math

import pytest

from shwd_torch.train import hpo as thpo
from shwd_tpu.train import hpo as jhpo


def _quadratic(trial):
    x = trial.suggest_uniform("x", -10.0, 10.0)
    return (x - 3.0) ** 2


def _loguniform(trial):
    lr = trial.suggest_loguniform("lr", 1e-7, 1e-1)
    return (math.log10(lr) + 4.0) ** 2


def _categorical_int(trial):
    k = trial.suggest_categorical("k", ["a", "b", "c"])
    n = trial.suggest_int("n", 1, 5)
    return {"a": 3.0, "b": 1.0, "c": 2.0}[k] + 0.1 * n


# test_runner_hpo.py's objectives, seeds and trial counts
OBJECTIVES = {"quadratic": (_quadratic, 0, 60), "loguniform": (_loguniform, 1, 80),
              "categorical_int": (_categorical_int, 2, 40)}


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_sampler_suggests_what_jax_suggests(name):
    """Every trial's parameters and value equal the JAX study's, bit for
    bit, through the random start-up trials and the TPE phase."""
    objective, seed, n = OBJECTIVES[name]
    js = jhpo.create_study(name, seed=seed)
    ts = thpo.create_study(name, seed=seed)
    js.optimize(objective, n_trials=n, verbose=False)
    ts.optimize(objective, n_trials=n, verbose=False)
    assert [t["params"] for t in ts.trials] == [t["params"] for t in js.trials]
    assert [t["value"] for t in ts.trials] == [t["value"] for t in js.trials]
    assert ts.best_params == js.best_params


@pytest.mark.parametrize("writer,reader", [(jhpo, thpo), (thpo, jhpo)])
def test_study_resumes_across_packages(tmp_path, writer, reader):
    """A jsonl study written by one package reloads in the other, counts its
    trials toward ``n_trials``, and goes on with the same suggestions as
    the writer's own resume would."""
    path = tmp_path / "study.jsonl"

    def objective(trial):
        return trial.suggest_uniform("x", 0.0, 1.0)

    first = writer.create_study("s", storage=path, seed=0)
    first.optimize(objective, n_trials=5, verbose=False)
    resumed = reader.create_study("s", storage=path, seed=0)
    assert len(resumed.trials) == 5 and resumed.best_value == first.best_value
    (tmp_path / "copy.jsonl").write_text(path.read_text())
    same = writer.create_study("s2", storage=tmp_path / "copy.jsonl", seed=0)
    resumed.optimize(objective, n_trials=8, verbose=False)
    same.optimize(objective, n_trials=8, verbose=False)
    assert [t["params"] for t in resumed.trials] == [t["params"] for t in same.trials]
    assert len([l for l in path.read_text().splitlines() if l.strip()]) == 8


def test_registration_objective_runs_two_trials_on_the_cpu(tmp_path):
    """``registration_hpo_objective`` (cd, 1 epoch a trial) through the
    port's ``run_one`` on the CPU: two finite trials, each with its own
    experiment directory."""
    from shwd_torch.data import DatasetConfig
    from shwd_torch.train import TrainConfig
    base = dataclasses.replace(
        TrainConfig(criterion="cd"), experiment="h", log_dir=str(tmp_path),
        batch_size=4, pcr_iteration_num=1,
        dataset=DatasetConfig(source_point_num=16, target_point_num=16,
                              num_synthetic=16, cache_dir=str(tmp_path / "mc")))
    study = thpo.create_study("h", storage=tmp_path / "h.jsonl", seed=0)
    study.optimize(thpo.registration_hpo_objective(base, num_epochs=1, device="cpu"),
                   n_trials=2, verbose=False)
    assert [t["state"] for t in study.trials] == ["complete", "complete"]
    assert all(math.isfinite(t["value"]) for t in study.trials)
    assert set(study.trials[0]["params"]) == {"adam_lr", "adam_weight_decay"}
    for i in range(2):
        assert (tmp_path / f"h_hpo_t{i}" / "config.json").exists()
