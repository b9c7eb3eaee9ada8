"""The harness finds each cell's pieces by name, and BENCHMARK.json keeps
to the benchmark's contract. Nothing here measures: a measured run
without a card fails."""

import json
import re
import shutil
import statistics
import subprocess
import sys

import pytest

from portbench import harness, run as cli

BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_configuration_traffic_driver_and_reference(cell):
    bench, entry, config, workload = harness.cell_inputs(cell)
    assert entry["config"] == config["reference"]
    driver = harness.driver(config)
    assert driver.__name__ == f"portbench.{config['driver']}"
    assert hasattr(driver, "run_cell") and hasattr(driver, "extra_readings")
    assert hasattr(harness.reference(config), "follow")
    assert workload["limits"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_each_metric_a_cell_reports_has_a_reader(cell, trace):
    metrics = harness.cell_metrics(BENCH, cell, trace)
    names = {m["name"] for m in metrics}
    if trace:
        assert any(n.startswith("mfu") for n in names)
    else:
        assert "setup_s" in names and len(names) >= 2
    for m in metrics:
        assert callable(harness.metric_reader(m["name"]))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for cell in CELLS:
        assert len(harness.cell_metrics(BENCH, cell, False)) >= 2
        assert harness.cell_metrics(BENCH, cell, True)


def test_a_cell_and_a_metric_added_as_files_only_are_found(tmp_path):
    root = tmp_path / "checkout"
    (root / "portbench").mkdir(parents=True)
    for part in ("configs", "workloads", "metrics"):
        shutil.copytree(harness.PKG / part, root / "portbench" / part)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "pcrnet_wcos.train_b64", "config": "pcrnet_wcos",
                               "traffic": "train_b64", "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy_share.train", "unit": "%", "better": "lower",
                               "source": "program_span", "layer": "epoch loop",
                               "moves": "train_clouds_per_s",
                               "workloads": ["pcrnet_wcos.train_b64"]})
    bench["end_to_end"][0]["workloads"].append("pcrnet_wcos.train_b64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    workload = json.loads((harness.PKG / "workloads" / "pcrnet_wcos.train_b128.json").read_text())
    workload["batch_size"] = 64
    (root / "portbench" / "workloads" / "pcrnet_wcos.train_b64.json").write_text(
        json.dumps(workload))
    (root / "portbench" / "metrics" / "dummy_share.train.py").write_text(
        "def read(run):\n    return 100.0 * run.spans.get('dummy', 0.0) / run.window_s\n")

    found, entry, config, wl = harness.cell_inputs("pcrnet_wcos.train_b64", root)
    assert wl["batch_size"] == 64 and config["driver"] == "train_cell"
    e2e = {m["name"] for m in harness.cell_metrics(found, "pcrnet_wcos.train_b64", False)}
    layer = {m["name"] for m in harness.cell_metrics(found, "pcrnet_wcos.train_b64", True)}
    assert e2e == {"train_clouds_per_s", "setup_s"}
    assert layer == {"dummy_share.train"}
    run = harness.Run(cell="pcrnet_wcos.train_b64", seed=1, seconds=1, trace=True,
                      config=config, workload=wl, window_s=4.0, spans={"dummy": 1.0})
    assert harness.read_metrics(run, harness.cell_metrics(found, run.cell, True), root) == {
        "dummy_share.train": {"value": 25.0, "unit": "%"}}


def test_a_measured_run_without_a_card_fails_and_prints_no_result(capsys):
    assert cli.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


def test_quartile_spread_is_pythons():
    # the bounds were set from statistics.quantiles(values, n=4), as the
    # check reads them
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)
