"""A traced run reads the device's busy time from the profiler's records
alone, and fails where it cannot reach what a listed metric reads."""

import pytest

from portbench import harness, kernels
from portbench.tracing import DeviceTrace


def _summary(events, window_s=1.0):
    trace = DeviceTrace()
    trace.events, trace.window_s = events, window_s
    return trace.summary()


def test_busy_time_is_the_union_of_graph_spans_and_eager_work():
    ms = 1_000_000
    events = [("cudaGraphLaunch", False, 0, 1 * ms, 7),
              ("node_a", True, 2 * ms, 3 * ms, 7), ("node_b", True, 5 * ms, 6 * ms, 7),
              ("eager", True, 4 * ms, 7 * ms, 9)]
    summary = _summary(events, window_s=0.01)
    # the graph spans 2-6 ms (its gap counts as busy); with the eager 4-7 ms
    assert summary["busy_s"] == pytest.approx(0.005)


def test_graphs_launched_without_a_traced_node_leave_busy_time_unknown():
    ms = 1_000_000
    events = [("cudaGraphLaunch", False, 0, 1 * ms, 7), ("eager", True, 4 * ms, 7 * ms, 9)]
    summary = _summary(events)
    assert summary["busy_s"] is None
    run = harness.Run(cell="x", seed=0, seconds=1, trace=True, config={}, workload={},
                      counts={"train_steps": 1}, trace_summary=summary)
    assert harness.metric_reader("device_idle_share.train")(run) is None
    with pytest.raises(harness.MissingReading):
        harness.require(summary["busy_s"], "device busy time")


def test_a_kernel_probe_fails_where_the_program_function_is_gone():
    assert callable(kernels.program_function("ops.costs", "cost_matrix"))
    with pytest.raises(harness.MissingReading):
        kernels.program_function("ops.sinkhorn_fused", "_no_such_function")
