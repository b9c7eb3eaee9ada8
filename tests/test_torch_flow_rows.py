"""The port's ellipsoid flow harness (tools/flow_rows_torch.py) against the
JAX package's ``benchmarks/flow_parity.py``.

The clouds file the harness reads is the JAX samplers' draws bit for bit;
every ``FlowConfig`` is the JAX script's (its ``base`` and method dicts are
rebuilt here: the script runs at import); the harness runs end to end on
the CPU at a tiny size. ~15 s on one worker, most of it the end-to-end
runs.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from shwd_tpu.train.flow_driver import FlowConfig as JFlowConfig

import write_flow_clouds

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "flow_rows_torch", ROOT / "tools" / "flow_rows_torch.py")
flows = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(flows)


def _flow_parity(experiment, method, eval_metric):
    """``flow_parity.py <experiment> [--eval-metric cd]``'s config of
    ``method``: N=1000, 1000 iterations, eval every 25; SHWD on ``hybrid``
    with the cosine lr decay to 0.1 on ``ellipsoid_2``."""
    base = dict(num_iterations=1000, eval_interval=25, lr=0.01, num_projections=100,
                shwd_layers=5, shwd_lam=0.1, shwd_max_iter=1, shwd_phi_lr=0.001,
                shwd_phi_wd=0.1, seed=0, eval_metric=eval_metric)
    methods = {"SHWD": dict(method="SHWD", shwd_solver="hybrid"), "ASWD": dict(method="ASWD"),
               "SWD": dict(method="SWD"), "SSWD": dict(method="SSWD"), "CD": dict(method="CD")}
    overrides = methods[method]
    if method == "SHWD" and experiment == "ellipsoid_2":
        overrides = {**overrides, "lr_decay_alpha": 0.1}
    return JFlowConfig(**{**base, **overrides})


def test_clouds_file_equals_the_jax_draws():
    """tools/flow_clouds_jax.npz holds PRNGKey(0)'s ellipsoid clouds,
    source and target of both experiments, bit for bit. ~1 s."""
    want = write_flow_clouds.draw()
    with np.load(flows.CLOUDS) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32 and got[k].shape == (1000, 3)
            assert np.array_equal(got[k], v), k
    for experiment in flows.EXPERIMENTS:
        src, tgt = flows.clouds(experiment)
        assert np.array_equal(src, want[f"{experiment}_source"])
        assert np.array_equal(tgt, want[f"{experiment}_target"])


@pytest.mark.parametrize("metric", ["w2", "cd"])
@pytest.mark.parametrize("method", ["SHWD", "ASWD", "SWD", "SSWD", "CD"])
@pytest.mark.parametrize("experiment", ["ellipsoid", "ellipsoid_2"])
def test_flow_config_equals_flow_parity(experiment, method, metric):
    """Every field of the harness's ``FlowConfig`` is the JAX script's.
    ~0 s."""
    port = dataclasses.asdict(flows.flow_config(experiment, method, metric))
    assert port == dataclasses.asdict(_flow_parity(experiment, method, metric))


def test_every_row_has_its_jax_row():
    """The five methods of both experiments and both metrics have a JAX
    row; SHWD's final W2 on each is under the 1e-3 bar. ~0 s."""
    for experiment in flows.EXPERIMENTS:
        for metric in ("w2", "cd"):
            for method in flows.METHODS:
                row = flows.jax_row(experiment, method, metric)
                assert np.isfinite(row[f"final_{metric}"])
        assert flows.jax_row(experiment, "SHWD", "w2")["final_w2"] <= flows.SHWD_W2_BAR


def test_harness_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """``--device cpu`` cut to N=64, 10 iterations, eval every 5: every
    method on ``ellipsoid_2`` with both metrics, one row each with the bar,
    the JAX row and finite curves; SHWD takes the decaying lr. ~12 s."""
    full_config, full_clouds = flows.flow_config, flows.clouds
    monkeypatch.setattr(flows, "flow_config", lambda *a: dataclasses.replace(
        full_config(*a), num_iterations=10, eval_interval=5))
    monkeypatch.setattr(flows, "clouds", lambda e: tuple(c[:64] for c in full_clouds(e)))
    out = tmp_path / "flows.json"
    argv = ["--experiments", "ellipsoid_2", "--eval-metric", "w2", "cd",
            "--device", "cpu", "--out", str(out), "--commit", "abc"]
    assert flows.main(argv) == 0
    rows = json.loads(out.read_text())
    assert [(r["eval_metric"], r["method"]) for r in rows] == [
        (m, k) for m in ("cd", "w2") for k in flows.METHODS]
    for r in rows:
        key = f"final_{r['eval_metric']}"
        for k in (key, key.replace("final", "best"), "sec_per_iter", "eval_curve",
                  "eval_iters", "bar", "meets_bar", "verdict", "jax_row", "card",
                  "path", "commit"):
            assert k in r, k
        assert r["points"] == 64 and r["eval_iters"] == [0, 5, 10]
        assert np.isfinite(r["eval_curve"]).all() and r["path"] == "fused"
        assert r["verdict"] in ("met", "MISSED")
        assert r["lr_decay_alpha"] == (0.1 if r["method"] == "SHWD" else 1.0)
        assert r["launches"] == {}                 # no kernel on the CPU
    shwd = next(r for r in rows if r["method"] == "SHWD" and r["eval_metric"] == "w2")
    assert shwd["bar"] == {"final_w2": 1e-3}
    cd = next(r for r in rows if r["method"] == "CD" and r["eval_metric"] == "cd")
    assert cd["bar"]["final_cd"] == pytest.approx(3 * cd["jax_row"]["final_cd"])
