"""The benchmark's own spans and the device trace of a traced run.

- ``Spans``: host-clock spans around the calls the window makes into the
  program, summed by name.
- ``DeviceTrace``: torch.profiler over the traced part of the window.
  Kernels, copies and sets on the device are split by their correlation
  with a ``cudaGraphLaunch`` into the graph's nodes and the eager work
  outside the graphs. The profiler may drop records, so what it gives is a
  lower bound.

Busy device time of the traced part = the union of the graphs' spans
(from a replay's first node to its last, read from the profiler: gaps
between a graph's nodes count as busy) and the eager device intervals.
Idle = 1 - busy / the traced part's host-clock length. Where the host
launched graphs and the profiler kept no node of any of them, the busy
time is unknown (None), and a traced run fails.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    """Host-clock seconds by name."""

    def __init__(self):
        self.total = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def split_device_events(events):
    """From kineto-like records (name, is_device, start_ns, end_ns,
    correlation), returns (graph spans, eager device intervals, device ops
    by name in seconds, host ops as (start, end, name), the number of
    ``cudaGraphLaunch`` calls). A graph span runs from the first to the
    last device record of one ``cudaGraphLaunch``."""
    launches = {c for name, dev, _, _, c in events
                if not dev and name == "cudaGraphLaunch"}
    graph = {}
    eager = []
    by_name = defaultdict(float)
    host = []
    for name, dev, s, e, c in events:
        if not dev:
            host.append((s, e, name))
            continue
        by_name[name] += (e - s) / 1e9
        if c in launches:
            lo, hi = graph.get(c, (s, e))
            graph[c] = (min(lo, s), max(hi, e))
        else:
            eager.append((s, e))
    return list(graph.values()), eager, dict(by_name), host, len(launches)


def idle_gaps(spans, host, limit=10):
    """The longest gaps between device activity, named by the host op that
    covers each gap's middle (the innermost, i.e. the latest to start)."""
    merged = _union(spans)
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    gaps.sort(reverse=True)
    out = []
    host = sorted(host)
    for length, s, e in gaps[:limit]:
        mid = (s + e) / 2
        covering = [h for h in host if h[0] <= mid <= h[1]]
        label = max(covering)[2] if covering else "host outside any profiled op"
        out.append([label, length / 1e9])
    return out


class DeviceTrace:
    """torch.profiler (CPU and CUDA activity) over a block, then the
    device's busy seconds and the breakdown."""

    def __init__(self):
        self.events = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._prof is None:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        cpu = torch.autograd.DeviceType.CPU
        self.events = [(e.name(), e.device_type() != cpu, e.start_ns(),
                        e.start_ns() + e.duration_ns(), e.correlation_id())
                       for e in prof.profiler.kineto_results.events()]

    def summary(self) -> dict:
        """busy_s (None where graphs were launched and the profiler kept
        none of their nodes), the traced window, and the breakdown."""
        spans, eager, by_name, host, launches = split_device_events(self.events)
        busy = None
        if spans or not launches:
            busy = sum(e - s for s, e in _union(spans + eager)) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": self.window_s,
                "breakdown": {"device_ops": [[k, v] for k, v in ops],
                              "idle_gaps": idle_gaps(spans + eager, host)}}
