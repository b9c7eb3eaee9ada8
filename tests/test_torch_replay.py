"""Recording a port fit and replaying it (``tools/registration_rows_torch.py
--record-dir ...``; ``replay_port``; ``tests/replay_fit.py``), at a tiny
size: a 5-shape bank of 16-point clouds (4 train shapes, 1 val), B=2, so
2 train steps and one val batch an epoch, full-width PCRNet, 2 epochs.

The port replayed from the record repeats the recorded history bit for
bit, and recording moves nothing (the history equals an unrecorded run's,
per-step and fused); a state recorded at an epoch resumes the rest of the
fit bit for bit; the JAX package replayed from the same record matches
the port step by step within the step tests' tolerances (loss rtol 1e-3;
phi or the chart after the step rtol 1e-4 / atol 2e-5). The JAX replays
run at lr 1e-4: at the rows' 1e-3 a 2-cloud batch turns PCRNet's pose by
~100 deg a step, and Adam's +-lr moves on rounding-noise gradients part
the packages by the fourth step (loss 5e-3 on ``max_ssw``).
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import json

import numpy as np
import pytest

import replay_fit

rows = replay_fit.harness
KEYS = ("train_loss", "val_loss", "rot_error", "trans_error")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The harness at the tiny size; returns a runner of its ``main`` that
    gives the record directory."""
    full = rows.row_config
    lr = {}

    def row_config(row, seed=None, log_dir="log", epochs=None):
        cfg = full(row, seed, log_dir, epochs)
        return dataclasses.replace(
            cfg, batch_size=2, checkpoint_flush_every=1, lr=lr.get("lr", cfg.lr),
            dataset=dataclasses.replace(cfg.dataset, num_synthetic=5, source_point_num=16,
                                        target_point_num=16,
                                        cache_dir=str(tmp_path / "cache")))
    monkeypatch.setattr(rows, "row_config", row_config)

    def run(row, *extra, epochs=2, learning_rate=None):
        if learning_rate is not None:
            lr["lr"] = learning_rate
        argv = ["--rows", row, "--seeds", "3", "--epochs", str(epochs), "--device", "cpu",
                "--log-dir", str(tmp_path / "log"), "--out", str(tmp_path / "rows.json"),
                "--record-dir", str(tmp_path / "rec"), *extra]
        assert rows.main(argv) == 0
        return tmp_path / "rec" / f"{row}_s3"
    return run


def _fit(record, tmp_path, **overrides):
    """The history of an unrecorded fit of the record's config."""
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer
    cfg = record.config(log_dir=str(tmp_path / "plain"), **overrides)
    res = Trainer(cfg, device="cpu").fit(
        RegistrationDataset(cfg.dataset, "train", device="cpu"), verbose=False)
    return res["history"]


def _equal(hist, ref):
    return len(hist) == len(ref) and all(a[k] == b[k] for a, b in zip(hist, ref) for k in KEYS)


@pytest.mark.parametrize("row", ["w_cos", "max_ssw"])
def test_port_replay_repeats_the_recorded_fit_bit_for_bit(tiny, row, tmp_path):
    """Record a 2-epoch fit (start state, epochs 0:2); the port's replay
    from the record gives its history bit for bit; the recorded history
    equals an unrecorded fit's, per-step and fused. The record holds the
    state, 2 x 2 train and 2 x 1 val batches and, for max-SSW, two frame
    draws a train step and one a val batch. ~8 s each."""
    record = rows.Record(tiny(row, "--record-start", "--record-epochs", "0:2"))
    assert record.meta["states"] == [0] and record.meta["epochs"] == [0, 2]
    assert record.meta["path"].startswith("per_step")
    assert [len(record.batch_keys(e, p)) for e in (0, 1) for p in ("train", "val")] == [2, 1] * 2
    draws = [len(record.batch_draws(k)) for k in record.batch_keys(0, "train")]
    assert draws == ([2, 2] if row == "max_ssw" else [0, 0])
    hist, _, _ = rows.replay_port(record, device="cpu")
    assert _equal(hist, record.history)

    assert _equal(_fit(record, tmp_path), record.history)
    assert _equal(_fit(record, tmp_path, fused_epoch=True), record.history)


def test_state_at_an_epoch_resumes_the_fit_bit_for_bit(tiny):
    """``--record-state-at 1`` with ``--record-epochs 1:3`` on a 3-epoch
    fit: the port's replay from the state at epoch 1 repeats epochs 2 and 3
    of the recorded history bit for bit, and the state holds the fit's
    epoch and both Adams one epoch in (count 2). ~8 s."""
    record = rows.Record(tiny("max_ssw", "--record-state-at", "1", "--record-epochs", "1:3",
                              epochs=3))
    assert record.meta["states"] == [1]
    state = record.state(1)
    assert int(state["epoch"]) == 1
    assert int(state["pcrnet_adam/count"]) == 2 and int(state["crit/adam/count"]) == 2
    hist, _, _ = rows.replay_port(record, device="cpu")
    assert [r["epoch"] for r in hist] == [2, 3] and _equal(hist, record.history[1:])


@pytest.mark.parametrize("row", ["w_cos", "max_ssw"])
def test_jax_replay_matches_the_port_step_by_step(tiny, row):
    """The JAX package replayed from the port's record (``replay_fit.
    compare``: its own per-step epoch loop, the record's batches, max-SSW's
    recorded frames handed in): every step's loss within rtol 1e-3 of the
    port's replay and phi or the chart after every step within rtol 1e-4
    / atol 2e-5; the port's replay equals the record bit for bit. ``w_cos``
    on the plain Sinkhorn route. ~25 s each (the JAX side compiles)."""
    record = rows.Record(tiny(row, "--record-start", "--record-epochs", "0:2",
                              learning_rate=1e-4))
    out = replay_fit.compare(record, (0, 2))
    assert out["steps_compared"] == 4 and out["first_parting_step"] is None
    assert max(out["step_loss_rel"]) <= replay_fit.LOSS_RTOL
    assert all(v == 0 for v in out["port_vs_recorded"].values())
    assert json.dumps(out)      # the summary line the script prints


def test_a_history_record_keeps_the_fused_path(tiny):
    """``--record-dir`` alone records the history and meta of the row's
    own (fused) fit, and no state or draw. ~4 s."""
    record = rows.Record(tiny("w_cos"))
    assert record.meta["path"] == "fused" and record.draws is None
    assert record.meta["states"] == [] and record.meta["epochs"] is None
    assert [r["epoch"] for r in record.history] == [1, 2]


def test_record_flags_need_a_record_dir(tiny):
    """``--record-epochs`` (or ``--record-start``, ``--record-state-at``)
    without ``--record-dir`` is refused before any fit, and so is an empty
    epoch range."""
    with pytest.raises(SystemExit):
        rows.main(["--rows", "w_cos", "--device", "cpu", "--record-epochs", "0:2"])
    with pytest.raises(SystemExit):
        rows.main(["--rows", "w_cos", "--device", "cpu", "--record-dir", "x",
                   "--record-epochs", "2:2"])
    assert rows.epoch_range("3:5") == (3, 5)
    assert np.isfinite(rows.epoch_range("0:1")[1])


@pytest.mark.parametrize("row", ["w_cos", "max_ssw"])
def test_one_jax_step_from_the_port_state_holds_all_along(tiny, row):
    """At the rows' lr 1e-3, where the free-running packages part by the
    fourth step, one JAX train call from the port's own state before each
    of its steps (``compare(sync=True)``) stays within the step tests'
    tolerances at every step: the loss at rtol 1e-3, PCRNet's gradients
    within 1e-3 of the largest and every entry within rtol 1e-3 over a
    floor of 1e-5 of the largest, phi or the chart at rtol 1e-4 / atol
    2e-5. ~15 s each."""
    record = rows.Record(tiny(row, "--record-start", "--record-epochs", "0:2"))
    out = replay_fit.compare(record, (0, 2), sides=("port",), sync=True)
    one = out["one_step"]
    assert one["steps"] == 4 and one["first_past_tolerance"] is None, one
    assert one["worst_loss_rel"] <= replay_fit.LOSS_RTOL
    assert one["worst_grad_share_past_per_entry"] == 0
