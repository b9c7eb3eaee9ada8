"""The port's profiling and FLOP accounting (``shwd_torch/utils``): the
meter and the trace as ``tests/test_profiling.py`` holds them in the JAX
package, the H100 peak table, the FLOP counter and the copied FLOP
models. A few seconds on one worker."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import json
import math
import time

import pytest
import torch

from shwd_torch.utils import flops as tflops
from shwd_torch.utils.profiling import (
    ThroughputMeter, annotate, counted_flops, device_peak_flops, mfu,
    peak_flops_for_name, trace,
)
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


def test_annotate_and_trace_write_a_chrome_trace(tmp_path):
    with trace(tmp_path / "prof"):
        with annotate("region"):
            x = torch.ones(8, 8) * 2
            y = (x @ x).sum()
    assert float(y) == 2048.0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "region" for e in events)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", math.nan)])
def test_peak_table(name, peak):
    got = peak_flops_for_name(name)
    assert got == peak or (math.isnan(peak) and math.isnan(got))


def test_cpu_has_no_peak_and_no_mfu():
    assert math.isnan(device_peak_flops("cpu"))
    m = mfu(2e9, 0.5, "cpu")
    assert m["gflops_per_step"] == 2.0 and m["achieved_gflops_per_s"] == 4.0
    assert math.isnan(m["mfu"])


def test_counted_flops_counts_products_with_their_backward():
    """A (10, 3) @ (3, 5) product: 2 * 10 * 3 * 5 forward; its backward to
    the (10, 3) input is one more product of the same size; the
    elementwise work adds 0."""
    w = torch.randn(3, 5)

    def fn(x):
        ((x @ w).exp().sum()).backward()

    x = torch.randn(10, 3, requires_grad=True)
    assert counted_flops(fn, x) == 2 * (2 * 10 * 3 * 5)
    assert counted_flops(lambda: torch.randn(100).exp().sum()) == 0


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
