"""Profiling and throughput counters.

Counterpart of ``shwd_tpu/utils/profiling.py``:

- ``trace``: context manager around ``torch.profiler``; writes a Chrome
  trace (``trace.json``: host ops, CUDA kernels, copies) of the region.
- ``annotate``: a named sub-region inside a trace (``record_function``).
- ``ThroughputMeter``: items per second (clouds, loss evaluations, steps)
  with warm-up laps skipped and jsonl emission.
- ``device_peak_flops``, ``counted_flops`` and ``mfu``: the FLOP
  accounting of a step against the card's peak.

Dispatch is asynchronous: a timed region ends in a synchronisation, so
``ThroughputMeter.lap`` takes the tensor to wait for.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path = "profile") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (host ops, and CUDA kernels when a card
    is present) and write ``<log_dir>/trace.json`` (chrome://tracing or
    Perfetto). Yields the profiler, whose ``key_averages()`` sum the
    region's ops by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named sub-region: ``with annotate("inner_adversarial"): ...``."""
    return torch.profiler.record_function(name)


def _wait_for(obj: Any) -> None:
    """Wait until the card has finished the work that produces ``obj`` (a
    tensor, or a list, tuple or dict of them); CPU tensors need no wait."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _wait_for(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _wait_for(v)


class ThroughputMeter:
    """Counts items (clouds, loss evals, steps) per second.

    Usage:
        meter = ThroughputMeter(warmup=2)
        for batch in ...:
            out = step(...)
            meter.lap(batch_size, block_on=out)
        print(meter.summary())
    """

    def __init__(self, warmup: int = 1, name: str = "items"):
        self.warmup = warmup
        self.name = name
        self._laps: list[tuple[int, float]] = []
        self._t_last: Optional[float] = None

    def start(self) -> None:
        self._t_last = time.perf_counter()

    def lap(self, count: int, block_on: Any = None) -> float:
        """Record ``count`` items completed; first waits for ``block_on``
        (``torch.cuda.synchronize`` of its device) so asynchronous dispatch
        does not fake the rate. Returns this lap's seconds."""
        if block_on is not None:
            _wait_for(block_on)
        now = time.perf_counter()
        if self._t_last is None:
            self._t_last = now
            return 0.0
        dt = now - self._t_last
        self._t_last = now
        self._laps.append((count, dt))
        return dt

    @property
    def measured(self) -> list[tuple[int, float]]:
        return self._laps[self.warmup:]

    def rate(self) -> float:
        """items/s over post-warmup laps."""
        laps = self.measured
        total_items = sum(c for c, _ in laps)
        total_time = sum(t for _, t in laps)
        return total_items / total_time if total_time > 0 else 0.0

    def summary(self) -> dict:
        laps = self.measured
        return {
            "metric": f"{self.name}_per_second",
            "value": self.rate(),
            "laps": len(laps),
            "total_items": sum(c for c, _ in laps),
            "total_seconds": sum(t for _, t in laps),
        }

    def emit(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps({"time": time.time(), **self.summary()}) + "\n")


# Dense bf16 tensor-core peak per card, the MFU convention's denominator
# (NVIDIA H100 data sheet, without sparsity). Matched in order on
# torch.cuda.get_device_name, so the PCIe and NVL parts come before the SXM
# part, which reports itself as e.g. "NVIDIA H100 80GB HBM3".
_PEAK_FLOPS_BY_NAME = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
)


def peak_flops_for_name(name: str) -> float:
    """The table's dense bf16 peak for a card name; NaN for a card the table
    does not know."""
    for sub, peak in _PEAK_FLOPS_BY_NAME:
        if sub in name:
            return peak
    return float("nan")


def device_peak_flops(device: str | torch.device | None = None) -> float:
    """Dense bf16 FLOP/s of the card ``device`` (default: the current card);
    NaN on the CPU or an unknown card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return float("nan")
    return peak_flops_for_name(torch.cuda.get_device_name(dev))


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of ONE call ``fn(*args, **kwargs)``, counted while it runs
    (``torch.utils.flop_counter.FlopCounterMode``), backward passes inside
    ``fn`` included. The call really runs, with its side effects.

    What it counts: matrix products, convolutions and attention (the
    matmul class), at 2 FLOPs per multiply-add. Elementwise ops, reductions,
    sorts and everything inside the hand-written CUDA kernels (and their
    plain twins' elementwise work) add 0. It is the counterpart of the JAX
    package's ``compiled_flops`` only in name: XLA's cost analysis counts
    elementwise work too, and each op inside a loop once.
    """
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(flops_per_step: float, seconds_per_step: float,
        device: str | torch.device | None = None) -> dict:
    """Achieved FLOP/s and model-FLOP utilisation against the card's peak.

    Returns {"gflops_per_step", "achieved_gflops_per_s", "mfu",
    "peak_tflops"}.
    """
    peak = device_peak_flops(device)
    achieved = flops_per_step / seconds_per_step if seconds_per_step > 0 else 0.0
    return {
        "gflops_per_step": flops_per_step / 1e9,
        "achieved_gflops_per_s": achieved / 1e9,
        "mfu": achieved / peak,
        "peak_tflops": peak / 1e12,
    }
