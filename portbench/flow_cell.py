"""Driver of the Wasserstein-gradient-flow cells.

Set-up: one short flow at the cell's size (its first interval), so that
the kernels are built and loaded and every library is warm before the
window.

Window: whole flows back to back, each a call of the program's
``run_flow`` on the fused path with a fresh cloud pair and phi seed drawn
from (``--seed``, flow index). Each flow pays its own warm-up and graph
capture, as every call of ``run_flow`` does. The benchmark's ``eval_fn``
keeps a host copy of the points at each interval's end and computes
nothing; the window ends at the first flow end past ``--seconds``. With
``--trace 1`` one more flow runs whole under the device trace.

Check: after the window and with the program's state freed, the exact W2
of every flow's final cloud, and the
exact W2 of the first flow's cloud after its first interval against that
of the plain reference's flow from the same clouds and seed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import kernels, traffic, yardstick
from .harness import Check, Run, mark, peak_bytes, reference, require, sync
from .reference.common import w2_exact
from .tracing import DeviceTrace


# flow indices of the set-up's warm flow and of the traced flow, apart
# from the window's (0, 1, 2, ...)
WARM_FLOW, TRACED_FLOW = 2 ** 40, 2 ** 40 + 1


def _config(run: Run, seed: int, **changes):
    from shwd_torch.train.flow_driver import FlowConfig
    return FlowConfig(**{**run.config["flow_config"], "seed": seed, **changes})


def reference_config(config: dict) -> dict:
    fc, arch = config["flow_config"], config["architecture"]
    return {"blocks": fc["shwd_layers"], "layers": arch["phi_layers"],
            "hidden": arch["phi_hidden"], "lipschitz_coeff": arch["lipschitz_coeff"],
            "inner_steps": fc["shwd_max_iter"], "lam": fc["shwd_lam"],
            "phi_lr": fc["shwd_phi_lr"], "phi_wd": fc["shwd_phi_wd"], "lr": fc["lr"]}


def run_cell(run: Run, measure) -> None:
    from shwd_torch.train.flow_driver import run_flow

    dev = run.device
    n = run.config["points"]
    interval = run.config["flow_config"]["eval_interval"]
    iterations = run.config["flow_config"]["num_iterations"]

    mark(run, "imported")
    src, tgt = traffic.cube_pair(run.seed, WARM_FLOW, n)
    warm = _config(run, traffic.flow_seed(run.seed, WARM_FLOW), num_iterations=interval)
    run_flow(src, tgt, warm, eval_fn=lambda p, t: 0.0, device=dev)

    flows = []
    sync(dev)
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    while True:
        i = len(flows)
        src, tgt = traffic.cube_pair(run.seed, i, n)
        seed = traffic.flow_seed(run.seed, i)
        kept = []
        t_flow = time.perf_counter()
        res = run_flow(src, tgt, _config(run, seed),
                       eval_fn=lambda p, t, kept=kept: kept.append(p.copy()) or 0.0, device=dev)
        flows.append({"source": src, "target": tgt, "seed": seed, "points": kept,
                      "interval_s": float(np.sum(res.interval_seconds)), "graph": res.graph,
                      "wall_s": time.perf_counter() - t_flow})
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.memory_peak_bytes = peak_bytes(dev)
    bad = sum(not np.isfinite(f["points"][-1]).all() for f in flows)
    run.attempted, run.failed = len(flows), bad
    run.counts = {"flows": len(flows), "flow_iterations": len(flows) * iterations}
    run.spans = {"flow_intervals": sum(f["interval_s"] for f in flows)}
    run.phases.update({f"flow{i}": f"{f['wall_s']:.4f}/{f['interval_s']:.4f}"
                       for i, f in enumerate(flows)})
    run.graphs = [f["graph"] for f in flows]
    if run.trace:
        require(all(g and g["kernel_nodes"] for g in run.graphs),
                "flow step graph with kernel nodes in every FlowResult")
    fc = run.config["flow_config"]
    run.model_flops = len(flows) * iterations * yardstick.flow_step_flops(
        n, blocks=fc["shwd_layers"], inner_steps=fc["shwd_max_iter"],
        dual_iterations=fc["hybrid_warmup_iters"] * fc["hybrid_warmup_scales"],
        auction_sweeps=run.config["flops"]["auction_sweeps"])

    if run.trace:
        _trace(run, run_flow, n)
        last = flows[-1]
        run.kernels = kernels.flow_probes(
            torch.as_tensor(last["points"][-1], device=dev),
            torch.as_tensor(last["target"], device=dev), fc)
    measure()
    run.kernels = {}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.checks = checks(run, flows)


def _trace(run: Run, run_flow, n: int) -> None:
    """One more whole flow under the device trace."""
    trace = DeviceTrace()
    src, tgt = traffic.cube_pair(run.seed, TRACED_FLOW, n)
    trace.start()
    run_flow(src, tgt, _config(run, traffic.flow_seed(run.seed, TRACED_FLOW)),
             eval_fn=lambda p, t: 0.0, device=run.device)
    trace.stop()
    run.trace_summary = trace.summary()


def interval_gaps(points: np.ndarray, ref: np.ndarray, source: np.ndarray,
                  target: np.ndarray) -> dict:
    """The points after the first interval against the reference's: the
    distance between the two clouds over the distance the reference moved,
    and the gap of their exact W2 to the target over the reference's."""
    moved = np.linalg.norm(ref - source)
    w2_ref = w2_exact(ref, target)
    return {"interval_gap": float(np.linalg.norm(points - ref) / max(moved, 1e-30)),
            "interval_w2_gap": abs(w2_exact(points, target) - w2_ref) / max(w2_ref, 1e-30)}


def checks(run: Run, flows: list) -> list[Check]:
    """The worst final exact W2 over the window's flows, and the gap of the
    first flow's exact W2 after its first interval against the
    reference's. (The distance between the two clouds there,
    ``interval_gap``, is not compared: one assignment that differs parts
    the trajectories by a few percent of the distance moved, whatever the
    size of the difference that tipped it.)"""
    first = flows[0]
    run.check_inputs = {"source": first["source"], "target": first["target"],
                        "seed": first["seed"], "cfg": reference_config(run.config),
                        "steps": run.config["flow_config"]["eval_interval"]}
    run.program_readings = {"w2_final": [w2_exact(f["points"][-1], f["target"])
                                         for f in flows],
                            "interval_points": first["points"][1],
                            "flows": [{k: f[k] for k in ("source", "target", "seed")}
                                      for f in flows]}
    ref = reference(run.config).follow(**run.check_inputs, device=run.device)
    values = interval_gaps(first["points"][1], ref, first["source"], first["target"])
    limits = run.workload["limits"]
    return [Check("w2_final", max(run.program_readings["w2_final"]), limits["w2_final"]),
            Check("interval_w2_gap", values["interval_w2_gap"], limits["interval_w2_gap"])]


def extra_readings(run: Run, controls: bool, full_control: bool = False) -> dict:
    """For ``portbench.readings``: the first interval's gaps, and with
    ``controls`` those of the control (the reference with TF32 products
    and the cost through a product), of half of the points left out and of
    a point of the answer moved, each against the reference; with
    ``full_control`` also the control's final W2 after the whole flow."""
    follow = reference(run.config).follow
    inp = run.check_inputs
    src, tgt = inp["source"], inp["target"]
    ref = follow(**inp, device=run.device)
    out = {"where": interval_gaps(run.program_readings["interval_points"], ref, src, tgt)}
    if not controls:
        return out
    ctrl = follow(**inp, device=run.device, tf32=True, matmul_cost=True)
    half = follow(**inp, device=run.device, half=True)
    moved = run.program_readings["interval_points"].copy()
    moved[0, 0] += 1.0
    out.update(control=interval_gaps(ctrl, ref, src, tgt),
               half_points=interval_gaps(half, ref, src, tgt),
               point_moved=interval_gaps(moved, ref, src, tgt))
    if full_control:
        steps = run.config["flow_config"]["num_iterations"]
        final = follow(**{**inp, "steps": steps}, device=run.device, tf32=True,
                       matmul_cost=True)
        out["control"]["w2_final"] = w2_exact(final, tgt)
    return out


def witness(run: Run) -> list:
    """(the program's final W2, the reference's whole flow's final W2) of
    each flow of the window, from the same clouds and seed."""
    follow = reference(run.config).follow
    steps = run.config["flow_config"]["num_iterations"]
    out = []
    for w2, f in zip(run.program_readings["w2_final"], run.program_readings["flows"]):
        final = follow(f["source"], f["target"], f["seed"], reference_config(run.config),
                       steps, run.device)
        out.append([w2, w2_exact(final, f["target"])])
    return out
