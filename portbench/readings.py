"""Readings from which a cell's limits are set (not run by the benchmark's
own runs):

    python3 -m portbench.readings --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--out FILE]

For each seed, a run of the cell with a window of one epoch or one flow,
the numbers it compares (the program against the reference: the lower
readings) and where they come from. For each control seed, on the same inputs, the same
numbers for the control (the reference with TF32 products; for the flow
also with the cost through a product) and for the planted faults that the
cell can have, each put in the program's place against the reference:
half of each batch left out (training), half of the points left out
(flow), a point of the answer moved (flow). A state left unchanged reads 1
by the change's and the interval's measure and needs no run. One JSON
line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--full-control", action="store_true",
                    help="also run the flow control over the whole flow for w2_final")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="the window of each seed's run (0: one epoch or one flow)")
    ap.add_argument("--witness", action="store_true",
                    help="flow: run the reference's whole flow on every flow of the window")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench, cell, config, workload = harness.cell_inputs(args.workload)
    import torch

    from shwd_torch.device import disable_tf32
    if not torch.cuda.is_available():
        print("portbench.readings: needs a CUDA card", file=sys.stderr)
        return 2
    disable_tf32()
    driver = harness.driver(config)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell=args.workload, seed=seed, seconds=args.seconds, trace=False,
                          config=config, workload=workload, device=torch.device("cuda", 0),
                          t_start=t0)
        driver.run_cell(run, lambda: None)
        line = {"seed": seed, "program": {c.name: c.value for c in run.checks}}
        line.update(driver.extra_readings(run, seed in args.control_seeds,
                                          args.full_control))
        if args.witness:
            line["witness"] = driver.witness(run)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
