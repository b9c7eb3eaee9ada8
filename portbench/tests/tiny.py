"""Runs of the cells' drivers on the CPU at a tiny size: a 40-shape bank of
16 points at batch 4; flows of 48 points over 100 iterations. The program
runs its plain twins of the kernels there; its ``sinkhorn`` transport is
sent down the kernel's route (the plain version of K3, per-item eps0), as
on the card."""

import copy
import time

import torch

from portbench import flow_cell, harness, train_cell

# the tiny flow does not reach the cell's W2; its own limit, from sound
# tiny runs (0.00116-0.00187 on seeds 1-4 and 6) and the control's whole
# flows (0.0064 and 0.0068 on seeds 4 and 6)
TINY_W2_LIMIT = 0.004


def kernel_route(monkeypatch):
    import shwd_torch.losses.transport as transport
    plain = transport.emd2_points
    monkeypatch.setattr(transport, "emd2_points",
                        lambda *a, **k: plain(*a, **{**k, "use_kernel": True}))


def train_run(seed: int) -> harness.Run:
    _, _, config, workload = harness.cell_inputs("pcrnet_wcos.train_b128")
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config.update(bank_shapes=40, points=16)
    workload["batch_size"] = 4
    run = harness.Run(cell="pcrnet_wcos.train_b128", seed=seed, seconds=0.0, trace=False,
                      config=config, workload=workload, device=torch.device("cpu"),
                      t_start=time.perf_counter())
    train_cell.run_cell(run, lambda: None)
    return run


def flow_run(seed: int) -> harness.Run:
    _, _, config, workload = harness.cell_inputs("flow_cube_shwd.flows_n1200")
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config["points"] = 48
    workload["limits"]["w2_final"] = TINY_W2_LIMIT
    config["flow_config"].update(num_iterations=100, eval_interval=20)
    run = harness.Run(cell="flow_cube_shwd.flows_n1200", seed=seed, seconds=0.0,
                      trace=False, config=config, workload=workload,
                      device=torch.device("cpu"), t_start=time.perf_counter())
    flow_cell.run_cell(run, lambda: None)
    return run


def values(run: harness.Run) -> dict:
    return {c.name: c.value for c in run.checks}


def correct(run: harness.Run) -> bool:
    return harness.result_line(run, {}, {})["correct"]
