"""Readers of the program's own records (``shwd_torch.utils.profiling``):
its host spans and the device marks of its captured steps, kept to the
run's untraced window.

The window is ``run.t_start + run.setup_s`` to that plus ``run.window_s``,
all on ``time.perf_counter``, the clock of the program's records. Traced
epochs or flows run after the window, so the profiler's cost never enters
these numbers. Each reader returns None where the program keeps no such
record (a program without the store, or without the span or mark).
"""

from __future__ import annotations


def window_records(run) -> list | None:
    """The program's finished records inside the run's window, or None."""
    try:
        from shwd_torch.utils.profiling import records
    except ImportError:
        return None
    if run.window_s <= 0:
        return None
    start = run.t_start + run.setup_s
    return records(start, start + run.window_s)


def span_share(run, name: str) -> float | None:
    """The spans named ``name`` over the window, in percent."""
    spans = [r.seconds for r in window_records(run) or () if r.name == name]
    return 100.0 * sum(spans) / run.window_s if spans else None


def collects(run, prefix: str = "") -> list[dict]:
    """The attributes of the window's ``graph.collect`` records of the
    graphs whose name starts with ``prefix``."""
    return [r.attrs for r in window_records(run) or ()
            if r.name == "graph.collect" and r.attrs["graph"].startswith(prefix)]


def mark_ms(run, prefix: str, labels: tuple) -> float | None:
    """Device ms per replay of the marks ``labels`` (summed) in the graphs
    named ``prefix...``: each collect's last replay weighted by the replays
    it covers."""
    found = collects(run, prefix)
    replays = sum(a["replays"] for a in found)
    if not replays or not any(label in a["ms"] for a in found for label in labels):
        return None
    return sum(a["replays"] * sum(a["ms"].get(label, 0.0) for label in labels)
               for a in found) / replays


def graph_busy_share(run) -> float | None:
    """Replays times each graph's whole-step device ms, over the window,
    in percent, summed over every graph collected in it."""
    found = collects(run)
    if not found:
        return None
    return 100.0 * sum(a["replays"] * a["graph_ms"] for a in found) / 1e3 / run.window_s


def pass_ms_per_step(run, attr: str) -> float | None:
    """Host ms per train step of the ``train.pass`` attribute ``attr``
    (seconds summed over the pass)."""
    passes = [r.attrs for r in window_records(run) or () if r.name == "train.pass"]
    steps = sum(a["steps"] for a in passes)
    return 1e3 * sum(a[attr] for a in passes) / steps if steps else None
