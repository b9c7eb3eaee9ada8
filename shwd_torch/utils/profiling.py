"""The port's record of where time goes: host spans, device marks inside
captured steps, the trace and the throughput meter.

Counterpart of ``shwd_tpu/utils/profiling.py`` (``trace``,
``ThroughputMeter``), extended with what the port records while it runs:

- ``span(name, **attrs)``: a host span. Entering one appends a ``Record``
  (name, start and end on ``time.perf_counter_ns``, the index of the
  enclosing span, attributes) to a bounded in-memory store; the oldest
  records go first once it is full, and ``dropped()`` counts them. While a
  torch profiler is recording, and only then, the span is also a range of
  its name in the profiler's trace, on the profiler's own clock (a
  function-scope ``RecordFunction``: a user-scope ``record_function``
  range would make the profiler add a device-side annotation over all the
  device work launched inside it, which a reader of the trace's device
  records takes for busy time).
- ``note(name, **attrs)``: a record of one instant (no duration).
- ``device_span(label)``: a mark inside a captured step. It does nothing
  unless a ``utils.graphs.StepGraph`` is capturing; during a capture it
  records timing events on the capture stream at entry and exit, which
  become event nodes of the graph (``DeviceMarks``). ``StepGraph.collect``
  reads the last replay's milliseconds by label after a host sync the
  caller makes anyway, and notes them in the store.
- ``device_count(label, value)``: a counter inside a captured step
  (``DeviceCounters``): during a capture, or inside ``counting``, the
  tensor ``value()`` (the step's own, rewritten by every replay) is kept,
  and ``StepGraph.collect`` notes the last replay's sums by label; outside,
  ``value`` is not called.
- ``records(start_s, end_s)``: the store's finished records that lie inside
  a ``time.perf_counter`` interval, for readers of the spans (the
  benchmark's per-layer metrics, an operator).
- ``trace``: a Chrome trace of a region through ``torch.profiler``.
- ``ThroughputMeter``: items per second (clouds, loss evaluations, steps)
  with warm-up laps skipped and jsonl emission.

Dispatch is asynchronous: a host span around device work measures the
enqueue unless the work ends in a synchronisation inside it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import torch

STORE_SIZE = 65536
# a host-only profiler range (RecordScope::FUNCTION); None where this
# PyTorch has none, and the spans then make no range
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Record:
    """One span or note: ``index`` (counts every record made), ``name``,
    ``parent`` (the enclosing span's index, or None), ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``; ``end_ns`` is None while the span
    is open) and ``attrs``."""

    __slots__ = ("index", "name", "parent", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.index = self.parent = self.start_ns = self.end_ns = None

    @property
    def seconds(self) -> float | None:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e9

    def __repr__(self) -> str:
        return (f"Record({self.index}, {self.name!r}, parent={self.parent}, "
                f"seconds={self.seconds}, attrs={self.attrs})")


class _Store:
    def __init__(self, size: int):
        self.records: collections.deque = collections.deque(maxlen=size)
        self.dropped = 0
        self.made = 0
        self.open: list[int] = []

    def add(self, rec: Record) -> Record:
        rec.index = self.made
        self.made += 1
        rec.parent = self.open[-1] if self.open else None
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)
        return rec


_STORE = _Store(STORE_SIZE)


class _Span:
    __slots__ = ("record", "_ranged")

    def __init__(self, name: str, attrs: dict):
        self.record = Record(name, attrs)
        self._ranged = None

    def __enter__(self) -> Record:
        rec = _STORE.add(self.record)
        _STORE.open.append(rec.index)
        # a module attribute, read on every entry: set by torch.profiler
        # while it records (no dispatcher call when it is not)
        if torch.autograd.profiler._is_profiler_enabled and _RANGE is not None:
            self._ranged = _RANGE(rec.name)
            self._ranged.__enter__()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> None:
        self.record.end_ns = time.perf_counter_ns()
        if self._ranged is not None:
            self._ranged.__exit__(None, None, None)
        _STORE.open.pop()


def span(name: str, **attrs) -> _Span:
    """A host span: ``with span("flow.build") as rec: ...``. ``rec.attrs``
    may gain attributes inside the block."""
    return _Span(name, attrs)


def note(name: str, **attrs) -> Record:
    """A record of this instant, inside the span that is open."""
    rec = _STORE.add(Record(name, attrs))
    rec.start_ns = rec.end_ns = time.perf_counter_ns()
    return rec


def records(start_s: float = float("-inf"), end_s: float = float("inf")) -> list[Record]:
    """The store's finished records that start at or after ``start_s`` and
    end at or before ``end_s`` (seconds of ``time.perf_counter``), oldest
    first."""
    lo, hi = start_s * 1e9, end_s * 1e9
    return [r for r in _STORE.records
            if r.end_ns is not None and r.start_ns >= lo and r.end_ns <= hi]


def dropped() -> int:
    """How many records the full store has let go."""
    return _STORE.dropped


def clear() -> None:
    """Empty the store (the open spans stay open, unrecorded)."""
    _STORE.records.clear()
    _STORE.dropped = 0


# -- device marks inside a captured step -------------------------------------

_CAPTURE_RUNNING = 1         # CUstreamCaptureStatus: CU_STREAM_CAPTURE_STATUS_ACTIVE
_driver = None


def _capture_tail(stream) -> tuple | None:
    """The graph nodes that the next operation captured on ``stream`` will
    follow (the driver's ``cuStreamGetCaptureInfo``), or None where the
    driver cannot say."""
    global _driver
    try:
        if _driver is None:
            _driver = ctypes.CDLL("libcuda.so.1")
        info = _driver.cuStreamGetCaptureInfo_v2
    except (OSError, AttributeError):
        return None
    status = ctypes.c_int(0)
    deps = ctypes.POINTER(ctypes.c_void_p)()
    count = ctypes.c_size_t(0)
    if info(ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), None, None,
            ctypes.byref(deps), ctypes.byref(count)) != 0 or status.value != _CAPTURE_RUNNING:
        return None
    return tuple(deps[i] for i in range(count.value))


class DeviceMarks:
    """The timing events one captured step records: ``spans`` holds
    (label, begin event, end event). An event is recorded only where work
    was captured since the last one; otherwise the last is reused, so
    adjacent marks share their boundary."""

    def __init__(self, stream: "torch.cuda.Stream"):
        self.stream = stream
        self.spans: list[tuple] = []
        self._last = None          # (event, the capture's tail right after it)

    def event(self) -> "torch.cuda.Event":
        if self._last is not None:
            ev, tail = self._last
            if tail is not None and tail == _capture_tail(self.stream):
                return ev
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record(self.stream)
        self._last = (ev, _capture_tail(self.stream))
        return ev

    def elapsed_ms(self) -> dict:
        """Milliseconds by label of the last replay (after a sync), summed
        over a label's spans."""
        out: dict = {}
        for label, begin, end in self.spans:
            out[label] = out.get(label, 0.0) + begin.elapsed_time(end)
        return out


_capturing: Optional[DeviceMarks] = None
_NO_MARK = contextlib.nullcontext()


@contextlib.contextmanager
def capturing(marks: DeviceMarks):
    """``device_span`` records into ``marks`` inside this block (a
    ``StepGraph`` capture)."""
    global _capturing
    outer, _capturing = _capturing, marks
    try:
        yield marks
    finally:
        _capturing = outer


class _Mark:
    __slots__ = ("marks", "label", "begin")

    def __init__(self, marks: DeviceMarks, label: str):
        self.marks, self.label = marks, label

    def __enter__(self) -> None:
        self.begin = self.marks.event()

    def __exit__(self, *exc) -> None:
        self.marks.spans.append((self.label, self.begin, self.marks.event()))


def device_span(label: str):
    """A mark around device work inside a captured step; nothing outside
    a ``StepGraph`` capture (eager steps, the CPU)."""
    marks = _capturing
    return _NO_MARK if marks is None else _Mark(marks, label)


# -- device counters inside a captured step ----------------------------------

class DeviceCounters:
    """The counts one captured step keeps on the device: ``parts`` holds
    (label, tensor or int). A tensor is the step's own (written by every
    replay) and counts its sum; an int counts itself each replay."""

    def __init__(self):
        self.parts: list[tuple] = []

    def add(self, label: str, value) -> None:
        self.parts.append((label, value))

    def read(self) -> dict:
        """The last replay's count by label (after a sync), summed over a
        label's parts: one copy to the host for all of them."""
        tensors = [v for _, v in self.parts if isinstance(v, torch.Tensor)]
        sums = iter(torch.stack([t.sum(dtype=torch.int64) for t in tensors]).tolist()
                    if tensors else [])
        out: dict = {}
        for label, v in self.parts:
            out[label] = out.get(label, 0) + (next(sums) if isinstance(v, torch.Tensor)
                                              else int(v))
        return out


_counting: Optional[DeviceCounters] = None


@contextlib.contextmanager
def counting(counters: DeviceCounters):
    """``device_count`` records into ``counters`` inside this block (a
    ``StepGraph`` capture, or a caller that reads the counts itself)."""
    global _counting
    outer, _counting = _counting, counters
    try:
        yield counters
    finally:
        _counting = outer


def device_count(label: str, value) -> None:
    """Count ``value()`` (a tensor whose sum is the count, or an int) under
    ``label`` inside a ``counting`` block; outside one nothing is called,
    so an eager step does no work for it."""
    if _counting is not None:
        _counting.add(label, value())


# -- trace and throughput ----------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str | Path = "profile") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (host ops, and CUDA kernels when a card
    is present) and write ``<log_dir>/trace.json`` (chrome://tracing or
    Perfetto); the program's spans inside it appear as ranges. Yields the
    profiler, whose ``key_averages()`` sum the region's ops by name."""
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
