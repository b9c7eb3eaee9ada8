"""Finds a cell's pieces by name and assembles one run's result.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics. Each piece sits in a file of its own, found by
name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
  its ``driver`` names the driver module (``portbench/<driver>.py``) and
  its ``reference`` the plain reference under ``reference/``;
- a cell's traffic: ``workloads/<cell>.json``;
- a metric: ``metrics/<metric>.py``, whose ``read(run)`` returns the value
  or None where the run has nothing to read.

A driver runs the cell's set-up, window and correctness check, and fills
a ``Run``; the harness then reads the metrics that the cell reports
(end-to-end ones without ``--trace``, per-layer ones with it). A traced
run whose driver cannot reach what a listed metric reads (a graph's
stats, a kernel, the device's busy time) raises ``MissingReading`` and
prints no result.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent

# top-level modules that must not be loaded by the process that prints
# the result: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "shwd_tpu")


class MissingReading(RuntimeError):
    """A traced run could not reach what one of its metrics reads."""


def require(found, what: str):
    """``found``, or ``MissingReading`` naming ``what`` where it is None,
    empty or zero."""
    if not found:
        raise MissingReading(f"a traced run found no {what}")
    return found


@dataclasses.dataclass
class Check:
    """A number compared with its limit; ``ok`` when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver hands the metric readers and the result line."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    workload: dict
    device: Any = None
    t_start: float = 0.0
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counts: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    graphs: list = dataclasses.field(default_factory=list)
    model_flops: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)   # name -> probe()
    trace_summary: dict | None = None
    memory_peak_bytes: int = 0
    checks: list = dataclasses.field(default_factory=list)
    # diagnostics for standard error: seconds since the process started
    # at each step of the set-up; each flow's wall and step seconds
    phases: dict = dataclasses.field(default_factory=dict)
    # what the check compared: the inputs both sides were given, and the
    # program's readings (kept for the readings of limits and controls)
    check_inputs: dict = dataclasses.field(default_factory=dict)
    program_readings: dict = dataclasses.field(default_factory=dict)


def sync(device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The device's peak allocated bytes so far (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    import torch
    return torch.cuda.max_memory_allocated(device)


def mark(run: "Run", phase: str) -> None:
    """Note that the set-up reached ``phase``, in seconds since the process
    started (written to standard error with the result)."""
    run.phases[phase] = time.perf_counter() - run.t_start


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell_inputs(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell's entry, its configuration file, its
    workload file)."""
    bench = load_benchmark(root)
    cell = cell_entry(bench, name)
    config = json.loads((root / config_entry(bench, cell["config"])["file"]).read_text())
    workload = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    return bench, cell, config, workload


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones it
    takes, or with ``trace`` the per-layer ones that list it (or, without
    a list, move an end-to-end metric that it reports)."""
    def takes(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if takes(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def reported(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names
    return [m for m in bench["per_layer"] if reported(m)]


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(config: dict):
    """The driver module that a configuration names."""
    return importlib.import_module(f"portbench.{config['driver']}")


def reference(config: dict):
    """The plain reference module named by a configuration."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def read_metrics(run: Run, metrics: list[dict], root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def result_line(run: Run, metrics: dict, device: dict) -> dict:
    correct = bool(run.checks) and all(c.ok for c in run.checks) and run.failed == 0
    out = {"correct": correct,
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace_summary is not None:
        out["breakdown"] = run.trace_summary["breakdown"]
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out
