"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line as the last line of its
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit), and the same checks as the last
lines of standard error. Exits non-zero and prints no result without
enough CUDA cards, without the program beside the benchmark, when JAX
or the JAX package was loaded, or when a traced run cannot reach what one
of its metrics reads.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(message: str) -> int:
    print(f"portbench: {message}", file=sys.stderr)
    return 2


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi prints it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        return fail("--seed must be a non-negative whole number")
    bench, cell, config, workload = harness.cell_inputs(args.workload)
    import torch

    # load from one process with one CPU thread: the host's share of a
    # step is Python and launches, and idle worker threads only add noise
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        return fail(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import shwd_torch
    except ImportError as err:
        return fail(f"the program is not beside the benchmark: {err}")
    if harness.ROOT not in Path(shwd_torch.__file__).resolve().parents:
        return fail(f"shwd_torch was loaded from {shwd_torch.__file__}, not from this checkout")
    from shwd_torch.device import disable_tf32
    disable_tf32()

    run = harness.Run(cell=args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), config=config, workload=workload,
                      device=torch.device("cuda", 0), t_start=T_START)
    metrics = harness.cell_metrics(bench, args.workload, run.trace)
    read = {}

    def measure():
        read.update(harness.read_metrics(run, metrics))

    try:
        harness.driver(config).run_cell(run, measure)
        if run.trace:
            busy = harness.require(run.trace_summary and run.trace_summary["busy_s"],
                                   "device busy time in the profiler's trace")
            if busy <= 0:
                raise harness.MissingReading("a traced run read no device busy time")
    except harness.MissingReading as err:
        return fail(str(err))

    found = harness.forbidden_modules()
    if found:
        return fail(f"loaded {', '.join(found)} in the process that measures the port")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit": power_limit()}
    if run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
    line = harness.result_line(run, read, device)
    print("setup " + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in run.phases.items())
          + f" window_start={run.setup_s:.3f}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
