"""The port's HPO study harness (tools/hpo_study_torch.py) against the JAX
package's ``benchmarks/hpo_smoke.py``: the base config field by field (the
script runs at import, so its base is rebuilt here), and the harness end
to end on the CPU at a tiny size. ~10 s on one worker.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np

from shwd_tpu.data import DatasetConfig, TransformConfig
from shwd_tpu.train import TrainConfig

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "hpo_study_torch", ROOT / "tools" / "hpo_study_torch.py")
hpo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(hpo)


def test_base_config_equals_hpo_smoke():
    """``hpo_smoke.py 25 150 hpo_study_150ep``'s base, every field. ~0 s."""
    want = TrainConfig(
        experiment="hpo_study_150ep", log_dir="log", criterion="cd",
        dataset=DatasetConfig(
            source_point_num=128, target_point_num=128, num_synthetic=512,
            synthetic_kinds=("composite",), cache_dir="modelnet_cache",
            transform=TransformConfig(noise_sigma=0.02)),
        batch_size=128, pcr_iteration_num=3)
    assert dataclasses.asdict(hpo.base_config()) == dataclasses.asdict(want)
    assert (hpo.TRIALS, hpo.EPOCHS, hpo.SHAPES) == (25, 150, 512)


def test_harness_runs_a_tiny_study_on_the_cpu(tmp_path, monkeypatch):
    """2 trials of 2 epochs on a 24-shape bank of 32-point clouds, batch 8:
    the study's keys, both trials' values and params, the JAX study and the
    bar beside them; a second call resumes the stored study. ~8 s."""
    full = hpo.base_config

    def tiny(**kw):
        cfg = full(**kw)
        return dataclasses.replace(cfg, batch_size=8, dataset=dataclasses.replace(
            cfg.dataset, num_synthetic=24, source_point_num=32, target_point_num=32))
    monkeypatch.setattr(hpo, "base_config", tiny)
    out = tmp_path / "study.json"
    argv = ["--trials", "2", "--epochs", "2", "--device", "cpu",
            "--log-dir", str(tmp_path / "log"), "--storage", str(tmp_path / "study.jsonl"),
            "--out", str(out)]
    assert hpo.main(argv) == 0
    row = json.loads(out.read_text())
    for key in ("study", "n_trials", "epochs_per_trial", "total_s",
                "best_value_rot_error_deg", "best_params", "all_values", "trials",
                "card", "jax_study", "bar", "meets_bar", "verdict"):
        assert key in row, key
    assert row["n_trials"] == 2 and len(row["trials"]) == 2 and row["shapes"] == 24
    assert set(row["best_params"]) == {"adam_lr", "adam_weight_decay"}
    assert row["best_value_rot_error_deg"] == min(row["all_values"])
    assert all(np.isfinite(t["value"]) and t["peak_mem_bytes"] is None
               for t in row["trials"])
    assert row["bar"]["best_value_rot_error_deg"] == 1.5 * 11.902755737304688
    assert row["jax_study"]["n_trials"] == 25
    assert hpo.main(argv[:1] + ["3"] + argv[2:]) == 0
    resumed = json.loads(out.read_text())
    assert resumed["n_trials"] == 3 and [t["number"] for t in resumed["trials"]] == [2]
    assert resumed["all_values"][:2] == row["all_values"]
