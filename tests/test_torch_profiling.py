"""The port's profiling (``shwd_torch/utils``): the meter and the trace as
``tests/test_profiling.py`` holds them in the JAX package, the spans and
their store, the device marks outside a capture, and the copied FLOP
models. A few seconds on one worker."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import json
import time

import torch

from shwd_torch.utils import flops as tflops
from shwd_torch.utils import profiling
from shwd_torch.utils.graphs import StepGraph
from shwd_torch.utils.profiling import ThroughputMeter, trace
from shwd_tpu.utils import flops as jflops


def test_throughput_meter_rate(tmp_path):
    meter = ThroughputMeter(warmup=1, name="clouds")
    meter.start()
    for _ in range(4):
        time.sleep(0.01)
        meter.lap(32, block_on=torch.ones(4))
    assert len(meter.measured) == 3
    r = meter.rate()
    assert 0 < r < 32 / 0.01
    s = meter.summary()
    assert s["metric"] == "clouds_per_second"
    assert s["total_items"] == 96
    meter.emit(tmp_path / "m.jsonl")
    row = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert row["value"] == r


def test_span_and_trace_write_a_chrome_trace(tmp_path):
    """A span inside ``trace`` lies in the Chrome trace as a range of its
    name."""
    with trace(tmp_path / "prof"):
        with profiling.span("region"):
            x = torch.ones(8, 8) * 2
            y = (x @ x).sum()
    assert float(y) == 2048.0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "region" for e in events)


def _names(prof) -> set:
    return {e.key for e in prof.key_averages()}


def test_spans_nest_and_name_their_parents():
    """Each record names the index of the span open around it; a note is
    an instant inside the open span."""
    profiling.clear()
    with profiling.span("outer", k=1) as outer:
        with profiling.span("inner") as inner:
            mark = profiling.note("here", n=2)
        with profiling.span("sibling") as sibling:
            pass
    after = profiling.note("after")
    assert outer.parent is None and after.parent is None
    assert inner.parent == outer.index and sibling.parent == outer.index
    assert mark.parent == inner.index and mark.seconds == 0.0 and mark.attrs == {"n": 2}
    assert [r.name for r in profiling.records()] == ["outer", "inner", "here", "sibling",
                                                     "after"]
    assert outer.attrs == {"k": 1}
    assert outer.seconds >= inner.seconds + sibling.seconds >= 0


def test_the_store_is_bounded_and_counts_what_it_dropped(monkeypatch):
    """A full store lets its oldest records go and counts them; an open
    span is not a finished record."""
    monkeypatch.setattr(profiling, "_STORE", profiling._Store(4))
    for i in range(6):
        profiling.note(f"n{i}")
    assert [r.name for r in profiling.records()] == ["n2", "n3", "n4", "n5"]
    assert profiling.dropped() == 2
    with profiling.span("open"):
        assert "open" not in [r.name for r in profiling.records()]
    assert profiling.records()[-1].name == "open" and profiling.dropped() == 3
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_records_keeps_what_lies_inside_the_interval():
    profiling.clear()
    t0 = time.perf_counter()
    with profiling.span("first"):
        pass
    t1 = time.perf_counter()
    with profiling.span("second"):
        pass
    t2 = time.perf_counter()
    assert [r.name for r in profiling.records(t0, t1)] == ["first"]
    assert [r.name for r in profiling.records(t1, t2)] == ["second"]
    assert [r.name for r in profiling.records(t0, t2)] == ["first", "second"]
    assert profiling.records(t2) == [] and profiling.records(end_s=t0) == []


def test_a_span_is_a_profiler_range_only_while_a_profiler_records(monkeypatch):
    """Under torch.profiler the span is a host range of its name, of
    function scope (no user-scope range, which the profiler would mirror
    on the device); without a profiler no range is made."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("traced_span"):
            torch.ones(4).sum()
    assert "traced_span" in _names(prof)
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == "traced_span"]
    assert len(ranges) == 1 and ranges[0].scope() == 0        # RecordScope::FUNCTION

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} without a profiler")

    monkeypatch.setattr(profiling, "_RANGE", refuse)
    with profiling.span("quiet_span") as rec:
        torch.ones(4).sum()
    assert rec.seconds >= 0


def test_device_span_does_nothing_outside_a_capture():
    """Outside a StepGraph capture a device mark is a no-op context (the
    same object every time), and a CPU graph collects nothing."""
    assert profiling.device_span("k3") is profiling.device_span("adam")
    with profiling.device_span("k3"):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    graph = StepGraph("t", lambda a: a * 2, [torch.zeros(3)], device="cpu")
    graph(torch.ones(3))
    assert graph.collect() is None and graph.replays == 1


def test_flop_models_are_the_jax_package_s():
    for name in ("flow_step_flops", "wcos_train_step_flops"):
        assert name in dir(tflops)
    assert tflops.flow_step_flops(1200) == jflops.flow_step_flops(1200)
    assert (tflops.wcos_train_step_flops(128, 128, pcr_iterations=3, layers=3,
                                         solver="sinkhorn")
            == jflops.wcos_train_step_flops(128, 128, pcr_iterations=3, layers=3,
                                            solver="sinkhorn"))
    assert tflops.ssw_cost_flops(2, 100, 128, 128, p=1) == \
        jflops.ssw_cost_flops(2, 100, 128, 128, p=1)
