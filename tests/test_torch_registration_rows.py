"""The port's registration-row harness (tools/registration_rows_torch.py)
against the JAX package's row scripts.

Each row's ``TrainConfig`` is rebuilt here as the JAX script builds it
(``benchmarks/train_bench.py``, ``resume_hybrid.py``, ``meshbank_bench.py``,
``final_max_ssw.py`` + ``resume_max_ssw.py``) and compared field by field
with the harness's; no script that trains is imported. The banks the rows
train and test on, and the train/val split of each row's seed, are held
to the JAX package's bit for bit; the harness runs end to end on the CPU
at a tiny size and resumes from its snapshot.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from shwd_torch import data as td
from shwd_torch.data import modelnet as t_modelnet
from shwd_tpu import data as jd
from shwd_tpu import train as jt
from shwd_tpu.data import modelnet as j_modelnet
from shwd_tpu.losses import SHWDConfig as JSHWD
from shwd_tpu.losses import TransportConfig as JTransport
from shwd_tpu.losses.ssw_loss import MaxSSWConfig as JMaxSSW

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "registration_rows_torch", ROOT / "tools" / "registration_rows_torch.py")
rows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rows)

LAM, PHI_LR, PHI_WD = (1.3111961119405346e-05, 9.213233310357477e-05,
                       1.4096013153858628e-08)


def _train_bench(criterion, epochs, solver=None, tag="", point_num=128):
    """``benchmarks/train_bench.py::run`` with 2048 shapes (the tag is
    ``_<point_num>_<solver>`` where the script is given both)."""
    shwd = jt.TrainConfig.__dataclass_fields__["shwd"].default
    if solver is not None:
        shwd = JSHWD(transport=JTransport(cost="geodesic" if solver == "ssw" else "lp",
                                          p=2.0, solver=solver),
                     max_iter=1, lam=LAM, phi_lr=PHI_LR, phi_weight_decay=PHI_WD)
    return jt.TrainConfig(
        experiment=f"bench_{criterion}{tag}", log_dir="log", criterion=criterion,
        shwd=shwd,
        dataset=jd.DatasetConfig(
            source_point_num=point_num, target_point_num=point_num, num_synthetic=2048,
            synthetic_kinds=("composite",), cache_dir="modelnet_cache",
            transform=jd.TransformConfig(noise_sigma=0.02)),
        num_epochs=epochs,
        max_ssw=JMaxSSW(num_projections=100, max_iter=1, phi_lr=9.2e-5),
        batch_size=128, pcr_iteration_num=3, nan_guard=(solver != "hybrid"))


def _meshbank(n=128, epochs=6000, seed=7):
    """``benchmarks/meshbank_bench.py <n> <epochs> <solver> 1e-3 <seed>``
    with the script's default solver (``ssw`` from N=512; the 520-mesh bank
    takes batch 128)."""
    solver = "ssw" if n >= 512 else "sinkhorn"
    shwd = JSHWD(transport=JTransport(cost="geodesic" if solver == "ssw" else "lp",
                                      p=2.0, solver=solver),
                 max_iter=1, lam=LAM, phi_lr=PHI_LR, phi_weight_decay=PHI_WD)
    return jt.TrainConfig(
        experiment=f"meshbank_w_cos_{n}", log_dir="log", criterion="w_cos", shwd=shwd,
        dataset=jd.DatasetConfig(source_point_num=n, target_point_num=n,
                                 modelnet_root="mesh_bank", cache_dir="meshbank_cache",
                                 transform=jd.TransformConfig(noise_sigma=0.02)),
        num_epochs=epochs, batch_size=128, lr=1e-3, weight_decay=PHI_WD, seed=seed,
        pcr_iteration_num=3, nan_guard=False)


def _robust(name, noise_sigma, outlier_num=0, outlier_sigma=1.0):
    """``benchmarks/robustness_bench.py::run`` of one setting at the
    recorded budget (``robustness_tpu.json``: 100 epochs, 2048 shapes)."""
    return jt.TrainConfig(
        experiment=f"robust_{name}", log_dir="log", criterion="w_cos",
        dataset=jd.DatasetConfig(
            source_point_num=128, target_point_num=128, num_synthetic=2048,
            synthetic_kinds=("composite",), cache_dir="modelnet_cache",
            transform=jd.TransformConfig(noise_sigma=noise_sigma, outlier_num=outlier_num,
                                         outlier_sigma=outlier_sigma)),
        num_epochs=100, batch_size=128, pcr_iteration_num=3, nan_guard=True)


def _max_ssw():
    """``benchmarks/final_max_ssw.py`` with variant P, as
    ``benchmarks/resume_max_ssw.py 900`` reloads it (less ``load_model``)."""
    cfg = jt.TrainConfig(
        experiment="bench_max_ssw", log_dir="log", criterion="max_ssw",
        max_ssw_chart="mlp",
        max_ssw=JMaxSSW(num_projections=512, max_iter=1, phi_lr=PHI_LR, p=1.0),
        dataset=jd.DatasetConfig(
            source_point_num=128, target_point_num=128, num_synthetic=2048,
            synthetic_kinds=("composite",), cache_dir="modelnet_cache",
            transform=jd.TransformConfig(noise_sigma=0.02)),
        num_epochs=700, batch_size=128, pcr_iteration_num=3)
    return dataclasses.replace(cfg, num_epochs=900, checkpoint_combined_weight=100.0)


JAX_CONFIGS = {
    "w_cos": lambda: _train_bench("w_cos", 2000),
    "w_cos_128_hybrid": lambda: _train_bench("w_cos", 2000, "hybrid", "_128_hybrid"),
    "w_cos_meshbank_128": _meshbank,
    "sinkhorn": lambda: _train_bench("sinkhorn", 300),
    "w1_cos": lambda: _train_bench("w1_cos", 200),
    "pseudo_w_cos": lambda: _train_bench("pseudo_w_cos", 150),
    "cd": lambda: _train_bench("cd", 300),
    "max_ssw": _max_ssw,
    # the first run of resume_max_ssw.py's schedule, less the 700 planned
    # epochs: the JAX run was cut at 506 (registration_tpu.json)
    "max_ssw_resume": lambda: dataclasses.replace(_max_ssw(), num_epochs=506),
    "robust_noise_0.00": lambda: _robust("noise_0.00", 0.0),
    "robust_noise_0.02": lambda: _robust("noise_0.02", 0.02),
    "robust_noise_0.04": lambda: _robust("noise_0.04", 0.04),
    "robust_noise_0.10": lambda: _robust("noise_0.10", 0.1),
    "robust_outliers_10": lambda: _robust("outliers_10", 0.02, 10, 1.0),
    "w_cos_1024_ssw": lambda: _train_bench("w_cos", 160, "ssw", "_1024_ssw", 1024),
    "w_cos_meshbank_1024": lambda: _meshbank(1024, 2000, 1234),
    "w_cos_1024_sinkhorn_div": lambda: _train_bench("w_cos", 96, "sinkhorn_div",
                                                    "_1024_sinkhorn_div", 1024),
}


@pytest.mark.parametrize("row", list(JAX_CONFIGS))
def test_row_config_equals_the_jax_scripts(row):
    """Every field of the harness's config is the JAX script's, but
    ``nan_guard``: the JAX rows read every loss on the host (not hybrid);
    the harness runs fused and checks the epoch metrics. ~0.1 s."""
    jax_cfg = dataclasses.asdict(JAX_CONFIGS[row]())
    port = dataclasses.asdict(rows.row_config(row, log_dir="log"))
    assert port.pop("nan_guard") is False
    jax_cfg.pop("nan_guard")
    assert port == jax_cfg
    assert set(rows.ROWS) == set(JAX_CONFIGS)


def test_resume_config_equals_resume_hybrid():
    """``--resume 2500`` continues the hybrid row as
    ``benchmarks/resume_hybrid.py`` did: 2500 epochs from the row's
    ``best_rot_error_snap``. ~0.1 s."""
    base = rows.row_config("w_cos_128_hybrid", log_dir="log")
    port = rows.resume_config(base, 2500)
    jax_cfg = dataclasses.replace(
        _train_bench("w_cos", 2000, "hybrid", "_128_hybrid"), num_epochs=2500,
        load_model="log/bench_w_cos_128_hybrid/models/best_rot_error_snap")
    port, jax_cfg = dataclasses.asdict(port), dataclasses.asdict(jax_cfg)
    port.pop("nan_guard"), jax_cfg.pop("nan_guard")
    assert port == jax_cfg


def test_resume_config_equals_resume_max_ssw():
    """``max_ssw_resume`` with ``--resume 900`` continues as
    ``benchmarks/resume_max_ssw.py 900`` did: from the 506-epoch run's
    ``best_rot_error_snap`` to 900 epochs, the combined snapshot (weight
    100) kept. ~0.1 s."""
    port = rows.resume_config(rows.row_config("max_ssw_resume", log_dir="log"), 900)
    jax_cfg = dataclasses.replace(
        _max_ssw(), load_model="log/bench_max_ssw/models/best_rot_error_snap")
    port, jax_cfg = dataclasses.asdict(port), dataclasses.asdict(jax_cfg)
    assert port.pop("nan_guard") is False
    jax_cfg.pop("nan_guard")
    assert port == jax_cfg
    assert rows.snapshot_name("max_ssw_resume") == "best_combined_snap"
    assert rows.RESUME_TARGETS["max_ssw_resume"] == {"test_mean_rot_error": 5.0,
                                                     "test_mean_trans_error": 0.02}


BANK_ROWS = {"composite": "w_cos", "mesh_bank": "w_cos_meshbank_128",
             "composite_1024": "w_cos_1024_ssw", "mesh_bank_1024": "w_cos_meshbank_1024"}


@pytest.mark.parametrize("bank,split", [("composite", "train"), ("composite", "test"),
                                        ("mesh_bank", "train"), ("mesh_bank", "test"),
                                        ("composite_1024", "test"),
                                        ("mesh_bank_1024", "test")])
def test_banks_and_splits_equal_the_jax_package(bank, split, tmp_path):
    """The 2048-shape composite bank and the OFF bank of ``mesh_bank/``
    (through each package's ``preprocess_modelnet``, its own cache), at
    128 points and at the 1024 of the N=1024 rows, are the JAX package's
    bit for bit, and so is the train/val split of every seed the rows run.
    ~1 s (composite), ~4 s (the 520 train meshes)."""
    row = BANK_ROWS[bank]
    ds_cfg = rows.row_config(row).dataset
    root = str(ROOT / ds_cfg.modelnet_root) if ds_cfg.modelnet_root else None
    args = (ds_cfg.source_point_num, split, root)
    kw = dict(num_synthetic=ds_cfg.num_synthetic, seed=ds_cfg.seed,
              synthetic_kinds=ds_cfg.synthetic_kinds)
    port = t_modelnet.load_dataset(*args, cache_dir=str(tmp_path / "t"), **kw)
    ref = j_modelnet.load_dataset(*args, cache_dir=str(tmp_path / "j"), **kw)
    want = {"train": 2048, "test": 512} if bank.startswith("composite") else {
        "train": 520, "test": 120}
    want = want[split]
    assert port.shape == ref.shape == (want, ds_cfg.source_point_num, 3)
    assert port.dtype == ref.dtype and np.array_equal(port, ref)
    if split == "train":
        cfg = dataclasses.replace(ds_cfg, modelnet_root=root, cache_dir=str(tmp_path / "t"))
        tds = td.RegistrationDataset(cfg, "train", device="cpu")
        jds = jd.RegistrationDataset(dataclasses.replace(cfg, cache_dir=str(tmp_path / "j")),
                                     "train")
        seeds = (1234, 0, 1, 2) if bank == "composite" else (7,)
        for seed in seeds:
            t_idx = tds.train_val_indices(np.random.default_rng(seed))
            j_idx = jds.train_val_indices(np.random.default_rng(seed))
            assert all(np.array_equal(a, b) for a, b in zip(t_idx, j_idx))
            assert len(t_idx[1]) == int(want * 0.2)


def _tiny(monkeypatch):
    """The harness at a tiny size: a 24-shape bank of 32-point clouds,
    batch 8 (2 train steps an epoch, one 4-shape val batch)."""
    full = rows.row_config

    def tiny(row, seed=None, log_dir="log", epochs=None):
        cfg = full(row, seed, log_dir, epochs)
        return dataclasses.replace(
            cfg, batch_size=8, checkpoint_flush_every=1,
            dataset=dataclasses.replace(cfg.dataset, num_synthetic=24,
                                        source_point_num=32, target_point_num=32))
    monkeypatch.setattr(rows, "row_config", tiny)


def test_harness_writes_a_row_with_every_key(tmp_path, monkeypatch):
    """``--device cpu``, 2 epochs of ``w_cos`` on the tiny bank: one row
    with the JAX row's keys, the held-out errors at the best-rotation
    snapshot, the bar and the JAX row; lam as the JAX rule leaves it.
    ~4 s."""
    _tiny(monkeypatch)
    out = tmp_path / "rows.json"
    argv = ["--rows", "w_cos", "--seeds", "3", "--epochs", "2", "--device", "cpu",
            "--log-dir", str(tmp_path / "log"), "--out", str(out), "--commit", "abc"]
    assert rows.main(argv) == 0
    (row,) = json.loads(out.read_text())
    for key in ("row", "seed", "epochs", "card", "commit", "source_sha256_16",
                "first_rot_error", "best_rot_error", "best_trans_error",
                "final_rot_error", "final_trans_error", "rot_curve_every10",
                "trans_curve_every10", "test_mean_rot_error", "test_mean_trans_error",
                "rot_success_ratio_5deg", "s_per_epoch", "ms_per_train_step",
                "peak_mem_bytes", "path", "bar", "meets_bar", "jax_row",
                "evaluated_snapshot_epoch", "lam_final", "lam_expected", "adam_step",
                "init_test_rot_error"):
        assert key in row, key
    assert (row["seed"], row["epochs"], row["epochs_run"], row["commit"]) == (3, 2, 2, "abc")
    assert row["path"] == "fused" and row["nonfinite_epochs"] == []
    assert row["train_steps_per_epoch"] == 2 and row["adam_step"] == 4
    assert row["evaluated_snapshot_epoch"] == row["best_rot_epoch"]
    assert row["test_samples"] == 8 and np.isfinite(row["test_mean_rot_error"])
    assert row["lam_final"] == row["lam_expected"] == float(np.float32(LAM))
    assert row["jax_row"]["test_mean_rot_error"] == pytest.approx(1.7237234115600586)
    assert row["bar"] == {"best_rot_error": 2.5, "test_mean_rot_error": 2.6}


def test_harness_resume_continues_from_the_snapshot(tmp_path, monkeypatch):
    """``--resume 3`` after 2 epochs: the fit starts after the snapshot's
    epoch, Adam's step continues from the snapshot's, and the resumed run
    writes every best-snapshot family anew; the row keeps the first run.
    ~6 s."""
    _tiny(monkeypatch)
    out, log = tmp_path / "rows.json", tmp_path / "log"
    base = ["--rows", "w_cos", "--seeds", "3", "--device", "cpu",
            "--log-dir", str(log), "--out", str(out)]
    assert rows.main(base + ["--epochs", "2"]) == 0
    models = log / "w_cos_s3" / "bench_w_cos" / "models"
    snap = torch.load(str(models / "best_rot_error_snap.pt"), weights_only=True)
    snap_epoch = int(snap["epoch"])
    snap_step = int(snap["opt"]["state"][0]["step"])
    assert snap_step == 2 * snap_epoch
    assert rows.main(base + ["--epochs", "2", "--resume", "3"]) == 0
    (row,) = json.loads(out.read_text())
    res = row["resume"]
    assert row["epochs_run"] == 2
    assert res["resumed_from_epoch"] == snap_epoch and res["resumed_to_epoch"] == 3
    assert res["first_epoch"] == snap_epoch + 1 and res["epochs_run"] == 3 - snap_epoch
    assert res["adam_step"] == snap_step + 2 * res["epochs_run"]
    assert res["init_test_rot_error"] is None and row["init_test_rot_error"] > 0
    for fam in ("best_model_snap", "best_rot_error_snap", "best_trans_error_snap"):
        epoch = int(torch.load(str(models / f"{fam}.pt"), weights_only=True)["epoch"])
        assert snap_epoch < epoch <= 3
