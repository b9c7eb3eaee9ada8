"""The program's spans where the work happens, on the CPU: the fused
Trainer's passes, ``run_flow``'s parts, ``Trainer.graph_stats``, and the
benchmark's readers of those records (``portbench/metrics``), each on a
synthetic run and store. A device mark's milliseconds come only from the
card (``tests/test_torch_kernels_gpu.py``)."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import numpy as np
import pytest
import torch

from portbench import harness
from shwd_torch import data as td
from shwd_torch import train as tt
from shwd_torch.losses import SHWDConfig, TransportConfig
from shwd_torch.ops.sphere_sampling import sample_cube_surface
from shwd_torch.train import flow_driver as tf
from shwd_torch.utils import profiling


def _trainer(tmp_path):
    cfg = tt.TrainConfig(
        experiment="t", log_dir=str(tmp_path), criterion="w_cos",
        dataset=td.DatasetConfig(source_point_num=24, target_point_num=24,
                                 num_synthetic=16, cache_dir=str(tmp_path / "mc"),
                                 transform=td.TransformConfig(noise_sigma=0.01)),
        batch_size=4, pcr_iteration_num=2,
        shwd=SHWDConfig(transport=TransportConfig(cost="lp", p=2.0, solver="sinkhorn",
                                                  eps=0.05, num_iters=10, num_scales=2),
                        max_iter=1, lam=1e-4, phi_lr=1e-4),
        phi_num_flow_layer=1, num_epochs=1)
    trainer = tt.Trainer(cfg, device="cpu")
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    return trainer, ds, state


def test_the_fused_train_pass_records_its_steps_and_host_seconds(tmp_path):
    """``train.pass`` counts the batches drawn and sums positive host
    seconds of drawing and of the graph's calls inside the pass;
    ``train.eval_pass`` spans the validation pass."""
    trainer, ds, state = _trainer(tmp_path)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(2)
    profiling.clear()
    state, loss = trainer.train_one_epoch(state, ds, np.arange(13), gen, rng)
    trainer.eval_one_epoch(state, ds, np.arange(13, 16), gen)
    assert np.isfinite(loss)
    names = [r.name for r in profiling.records()]
    assert names == ["train.pass", "train.eval_pass"]
    train, val = profiling.records()
    assert train.attrs["steps"] == 3            # 13 rows, batches of 4
    assert train.attrs["batch_s"] > 0 and train.attrs["launch_s"] > 0
    assert train.attrs["batch_s"] + train.attrs["launch_s"] <= train.seconds
    assert val.seconds > 0 and val.start_ns >= train.end_ns


def test_graph_stats_lists_each_step_graph(tmp_path):
    """One train graph and one eval graph per batch shape, with their
    calls; empty before a pass and for a per-step trainer."""
    trainer, ds, state = _trainer(tmp_path)
    assert trainer.graph_stats() == []
    gen = torch.Generator().manual_seed(1)
    state, _ = trainer.train_one_epoch(state, ds, np.arange(8), gen,
                                       np.random.default_rng(2))
    trainer.eval_one_epoch(state, ds, np.arange(8, 14), gen)
    stats = {s["name"]: s for s in trainer.graph_stats()}
    assert sorted(stats) == ["eval step of w_cos/sinkhorn at (2, 24, 3)",
                             "eval step of w_cos/sinkhorn at (4, 24, 3)",
                             "train step of w_cos/sinkhorn at (4, 24, 3)"]
    assert stats["train step of w_cos/sinkhorn at (4, 24, 3)"]["replays"] == 2
    assert all(not s["captured"] for s in stats.values())


def test_run_flow_records_its_parts_under_flow_run():
    """``flow.build``, ``flow.capture`` (with the warm-up's seconds),
    ``flow.interval`` and ``flow.eval`` nest under ``flow.run``, and the
    interval spans are ``interval_seconds``."""
    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 40).numpy()
    tgt = sample_cube_surface(rng, 40, biased=True).numpy()
    cfg = tf.FlowConfig(method="SHWD", num_iterations=4, eval_interval=2, shwd_layers=2,
                        shwd_solver="hybrid")
    profiling.clear()
    res = tf.run_flow(src, tgt, cfg, device="cpu")
    recs = profiling.records()
    run = recs[0]
    assert [r.name for r in recs] == ["flow.run", "flow.build", "flow.eval", "flow.capture",
                                      "flow.interval", "flow.eval", "flow.interval",
                                      "flow.eval"]
    assert all(r.parent == run.index for r in recs[1:]) and run.attrs["method"] == "SHWD"
    capture = recs[3]
    assert 0 < capture.attrs["warmup_s"] <= capture.seconds
    intervals = [r.seconds for r in recs if r.name == "flow.interval"]
    np.testing.assert_array_equal(res.interval_seconds, intervals)
    assert sum(r.seconds for r in recs[1:]) <= run.seconds


# -- the benchmark's readers of the program's records -------------------------

T0 = 1e8             # a synthetic clock far from this process's perf_counter
TRAIN = "train step of w_cos/sinkhorn at (128, 128, 3)"
EVAL = "eval step of w_cos/sinkhorn at (128, 128, 3)"
FLOW = "flow step of SHWD/hybrid"
TRAIN_MS = {"pcrnet_forward": 1.0, "phi_forward": 2.0, "k3": 0.9, "phi_update": 2.5,
            "backward": 3.0, "adam": 0.4}
FLOW_MS = {"phi_forward": 1.5, "k1": 2.4, "k2": 0.8, "phi_update": 2.0, "backward": 1.0,
           "adam": 0.1}


def _put(name, start, end, **attrs):
    """A finished record at seconds ``start`` to ``end`` after T0."""
    rec = profiling._STORE.add(profiling.Record(name, attrs))
    rec.start_ns, rec.end_ns = int((T0 + start) * 1e9), int((T0 + end) * 1e9)


def _collect(at, graph, replays, graph_ms, ms):
    _put("graph.collect", at, at, graph=graph, replays=replays, graph_ms=graph_ms, ms=ms)


def _store():
    """A window from T0 + 10 to T0 + 110; each record kind also lies once
    before it and once after it, with other numbers."""
    profiling.clear()
    for at, scale in ((5.0, 50.0), (115.0, 70.0)):          # outside the window
        _collect(at, TRAIN, 99, 999.0, {k: scale * v for k, v in TRAIN_MS.items()})
        _collect(at, FLOW, 99, 999.0, {k: scale * v for k, v in FLOW_MS.items()})
        _put("train.pass", at - 1, at, steps=7, batch_s=3.0, launch_s=3.0)
        for name in ("train.eval_pass", "flow.build", "flow.capture", "flow.eval"):
            _put(name, at, at + 1)
    _put("train.pass", 20.0, 30.0, steps=12, batch_s=0.012, launch_s=0.0024)
    _put("train.pass", 40.0, 45.0, steps=4, batch_s=0.002, launch_s=0.0008)
    _collect(30.0, TRAIN, 12, 10.0, TRAIN_MS)
    _collect(45.0, TRAIN, 4, 12.0, {k: 2 * v for k, v in TRAIN_MS.items()})
    _put("train.eval_pass", 31.0, 33.0)
    _put("train.eval_pass", 46.0, 46.5)
    _collect(33.0, EVAL, 4, 5.0, {"pcrnet_forward": 0.5, "phi_forward": 1.0, "k3": 0.5})
    _put("flow.run", 50.0, 60.0)
    _put("flow.build", 50.0, 51.0)
    _put("flow.capture", 51.0, 53.0, warmup_s=1.0)
    _put("flow.eval", 53.0, 53.25)
    _put("flow.eval", 59.0, 59.5)
    _collect(58.0, FLOW, 50, 9.0, FLOW_MS)
    _collect(59.0, FLOW, 50, 9.5, {k: 3 * v for k, v in FLOW_MS.items()})


def _run():
    return harness.Run(cell="c", seed=1, seconds=100.0, trace=True, config={}, workload={},
                       t_start=T0, setup_s=10.0, window_s=100.0)


def _train_mean(label):
    return (12 * TRAIN_MS[label] + 4 * 2 * TRAIN_MS[label]) / 16


def _flow_mean(*labels):
    return sum(50 * FLOW_MS[k] + 50 * 3 * FLOW_MS[k] for k in labels) / 100


BUSY = 100 * (12 * 10.0 + 4 * 12.0 + 4 * 5.0 + 50 * 9.0 + 50 * 9.5) / 1e3 / 100.0
READINGS = {
    "pcrnet_forward_ms.train": _train_mean("pcrnet_forward"),
    "phi_forward_ms.train": _train_mean("phi_forward"),
    "k3_ms.train": _train_mean("k3"),
    "phi_update_ms.train": _train_mean("phi_update"),
    "backward_ms.train": _train_mean("backward"),
    "adam_ms.train": _train_mean("adam"),
    "batch_ms_per_step.train": 1e3 * 0.014 / 16,
    "launch_ms_per_step.train": 1e3 * 0.0032 / 16,
    "graph_busy_share.train": BUSY,
    "eval_pass_share.train": 100 * 2.5 / 100.0,
    "phi_forward_ms.flow": _flow_mean("phi_forward"),
    "k1_ms.flow": _flow_mean("k1"),
    "k2_ms.flow": _flow_mean("k2"),
    "phi_update_ms.flow": _flow_mean("phi_update"),
    "point_update_ms.flow": _flow_mean("backward", "adam"),
    "graph_busy_share.flow": BUSY,
    "phi_build_share.flow": 1.0,
    "capture_share.flow": 2.0,
    "eval_share.flow": 0.75,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_span_metric_reads_the_program_s_records_in_the_window(name, monkeypatch):
    """Each reader keeps the records inside the run's window and ignores
    those before and after it; with no such record, or a program without
    the store, it returns None."""
    assert name in {m["name"] for m in harness.load_benchmark()["per_layer"]}
    read = harness.metric_reader(name)
    _store()
    assert read(_run()) == pytest.approx(READINGS[name], rel=1e-9)
    profiling.clear()
    assert read(_run()) is None
    _store()
    monkeypatch.delattr(profiling, "records")
    assert read(_run()) is None
    profiling.clear()
