"""The port's sweep runner (``shwd_torch.train.runner``) against the JAX
package's, and the three JAX-free example scripts.

Matrices and tiny experiments are those of ``tests/test_runner_hpo.py``.
The child processes (the ``subprocess`` sweep and the examples) run with
one OpenMP thread and ``--device cpu``; each costs a few seconds of
imports. About 60 s on one worker.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from shwd_torch.data import DatasetConfig
from shwd_torch.train import runner as trun
from shwd_torch.train.config import TrainConfig
from shwd_tpu.train import runner as jrun
from shwd_tpu.train.config import TrainConfig as JTrainConfig

ROOT = Path(__file__).resolve().parent.parent
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

MATRICES = {
    "zip": ({"seed": [1, 2, 3], "dataset.transform.noise_sigma": [0.0, 0.02, 0.04],
             "criterion": ["cd"]}, "zip"),
    "product": ({"seed": [1, 2], "shwd.lam": [10.0, 20.0, 30.0]}, "product"),
    "reference": ({"experiment": [f"4_WD_128_128_{s}_noise"
                                  for s in ("0.00", "0.02", "0.04", "0.1")],
                   "dataset.transform.noise_sigma": [0.0, 0.02, 0.04, 0.1],
                   "seed": [4], "criterion": ["w_cos"]}, "zip"),
    "nested": ({"seed": [7], "dataset.transform.noise_sigma": [0.1],
                "shwd.transport.num_projections": [64], "shwd.lam": [0.5]}, "zip"),
}


def _field(cfg, path):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


@pytest.mark.parametrize("name", list(MATRICES))
def test_matrix_expansion_and_overrides_match_jax(name):
    """expand_matrix gives JAX's override dicts; matrix_to_configs gives
    configs whose overridden fields equal JAX's field by field, and whose
    other fields keep the defaults (equal in both packages)."""
    matrix, mode = MATRICES[name]
    assert trun.expand_matrix(matrix, mode) == jrun.expand_matrix(matrix, mode)
    tcfgs = trun.matrix_to_configs(matrix, mode=mode)
    jcfgs = jrun.matrix_to_configs(matrix, mode=mode)
    assert len(tcfgs) == len(jcfgs) > 0
    for t, j in zip(tcfgs, jcfgs):
        for path in matrix:
            assert _field(t, path) == _field(j, path)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_ragged_zip_and_unknown_field_raise_as_in_jax():
    for mod in (trun, jrun):
        with pytest.raises(ValueError):
            mod.expand_matrix({"a": [1, 2], "b": [1, 2, 3]}, "zip")
    with pytest.raises(KeyError):
        trun.apply_overrides(TrainConfig(), {"not_a_field": 1})
    with pytest.raises(KeyError):
        jrun.apply_overrides(JTrainConfig(), {"not_a_field": 1})


def _tiny_cfg(tmp_path, name, criterion="cd"):
    return dataclasses.replace(
        TrainConfig(), experiment=name, log_dir=str(tmp_path / "log"),
        criterion=criterion, num_epochs=1, batch_size=4, pcr_iteration_num=1,
        dataset=DatasetConfig(source_point_num=16, target_point_num=16,
                              num_synthetic=16, cache_dir=str(tmp_path / "mc")))


def test_inprocess_sweep_then_eval_sweep(tmp_path):
    """Two tiny experiments in this process, then the test_RUNNER pass: each
    leaves config.json, the best checkpoints and eval_summary.json with the
    JAX package's keys, all finite."""
    cfgs = [_tiny_cfg(tmp_path, "exp_a"), _tiny_cfg(tmp_path, "exp_b")]
    results = trun.run_sweep(cfgs, mode="inprocess", verbose=False, device="cpu")
    assert len(results) == 2 and all("best" in r for r in results)
    out = trun.run_eval_sweep(["exp_a", "exp_b"], log_dir=str(tmp_path / "log"),
                              device="cpu")
    assert set(out) == {"exp_a", "exp_b"}
    for name in out:
        exp = tmp_path / "log" / name
        assert (exp / "config.json").exists()
        assert (exp / "models" / "best_model_snap.pt").exists()
        summary = json.loads((exp / "eval_summary.json").read_text())
        assert set(summary) == {"mean_rot_error", "mean_trans_error"}
        assert summary == out[name]
        assert all(math.isfinite(v) for v in summary.values())


def test_subprocess_sweep_runs_one_experiment(tmp_path):
    """``mode="subprocess"``: one child ``python -m shwd_torch.train.runner
    run-one --config ... --device cpu`` with its ``device_env``; its
    summary.json comes back as the result."""
    cfg = _tiny_cfg(tmp_path, "exp_sub")
    (res,) = trun.run_sweep([cfg], mode="subprocess", device="cpu",
                            device_env=[ONE_THREAD], verbose=False)
    assert res.get("epochs") == 1, res
    assert math.isfinite(res["best"]["rot"])
    assert (tmp_path / "log" / "exp_sub" / "models" / "best_rot_error_snap.pt").exists()


EXAMPLES = {
    "flow_cube_torch.py": ["--method", "SWD", "--iters", "4", "--points", "64",
                           "--eval-interval", "2"],
    "train_registration_torch.py": ["--criterion", "cd", "--epochs", "1",
                                    "--batch-size", "4", "--points", "16",
                                    "--num-synthetic", "16"],
    "metric_sweep_torch.py": ["--mode", "kl"],
}


@pytest.mark.parametrize("script", list(EXAMPLES))
def test_example_runs_on_the_cpu(tmp_path, script):
    """Each example script, with tiny arguments and ``--device cpu``, in a
    fresh directory: exit 0, and its json output where it writes one."""
    args = [sys.executable, str(ROOT / "examples" / script), *EXAMPLES[script],
            "--device", "cpu"]
    if script != "train_registration_torch.py":
        args += ["--out", str(tmp_path / "out.json")]
    proc = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **ONE_THREAD})
    assert proc.returncode == 0, proc.stderr[-2000:]
    if script == "train_registration_torch.py":
        assert (tmp_path / "log" / "demo" / "config.json").exists()
    else:
        assert json.loads((tmp_path / "out.json").read_text())
