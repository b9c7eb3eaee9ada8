"""The registration train step on the exact-EMD (``hybrid``) solver, on
the CPU at a small size (B=4, N=M=16, PCRNet at its published widths, phi
3 x [3, 8 x 6, 3], weights drawn from a seed): the step against the plain
reference at the program's own assignments, ``Trainer.last_solves``, and
the auction's device counters. The same check at the real size decides the
benchmark cell ``pcrnet_wcos_hybrid.train_b128`` on the card."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import copy
import time

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from portbench import harness, train_hybrid_cell
from shwd_torch.ops.auction import hybrid_assignment_warm
from shwd_torch.utils import profiling

CELL = "pcrnet_wcos_hybrid.train_b128"


def _run(seed: int, check_steps: int = 1) -> harness.Run:
    _, _, config, workload = harness.cell_inputs(CELL)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config.update(bank_shapes=40, points=16)
    workload.update(batch_size=4, check_steps=check_steps)
    run = harness.Run(cell=CELL, seed=seed, seconds=0.0, trace=False, config=config,
                      workload=workload, device=torch.device("cpu"),
                      t_start=time.perf_counter())
    train_hybrid_cell.run_cell(run, lambda: None)
    return run


@pytest.mark.parametrize("seed", [3, 11])
def test_a_hybrid_train_step_is_the_reference_at_its_own_assignments(seed):
    """One fused train step: the loss, PCRNet's and phi's first gradients and
    their changes match the plain reference taken at the program's inner and
    final assignments, and those are exact (permutations at scipy's optimum
    on the reference's float64 cost)."""
    values = {c.name: c.value for c in _run(seed).checks}
    assert values["non_permutations"] == 0
    assert values["assignment_gap"] <= 1e-6
    assert values["loss_gap"] < 1e-5 and values["val_gap"] < 1e-5
    assert values["grad_gap"] < 1e-4 and values["change_gap"] < 1e-4
    assert values["phi_grad_gap"] < 1e-5 and values["phi_change_gap"] < 1e-4


def test_last_solves_are_scipy_s_permutations_on_tie_free_costs():
    """Each solve of each step, read back with ``Trainer.last_solves``, is a
    permutation and scipy's assignment on the reference's cost of the same
    step (random clouds: no ties), with the solve's sweeps and prices."""
    run = _run(5, check_steps=2)
    ref = harness.reference(run.config).follow(**run.check_inputs)
    assert run.program_readings["non_permutations"] == 0
    for step, records in zip(run.program_readings["solves"], ref["solves"]):
        assert len(step) == 2 and len(records) == 2
        for numbers, record in zip(step, records):
            assert numbers["permutations"] == numbers["items"] == 4
            assert numbers["stragglers"] == 0 and numbers["price_max"] > 0
            assert record["flips"] == 0 and record["gap"] <= 1e-6
    # the inner solve is cold and bids; the final one restarts warm
    assert all(step[0]["sweeps_sum"] >= step[1]["sweeps_sum"]
               for step in run.program_readings["solves"])


def test_last_solves_is_none_for_the_sinkhorn_solver_and_returns_copies():
    from shwd_torch import data as td
    from shwd_torch import train as tt
    from shwd_torch.losses import SHWDConfig, TransportConfig

    def trainer(solver):
        cfg = tt.TrainConfig(
            criterion="w_cos", batch_size=4, pcr_iteration_num=1, phi_num_flow_layer=1,
            dataset=td.DatasetConfig(source_point_num=12, target_point_num=12,
                                     num_synthetic=8),
            shwd=SHWDConfig(transport=TransportConfig(cost="lp", p=2.0, solver=solver,
                                                      eps=0.05, num_iters=5, num_scales=2),
                            max_iter=1, lam=1e-4, phi_lr=1e-4))
        tr = tt.Trainer(cfg, device="cpu")
        bank = torch.rand(8, 12, 3, generator=torch.Generator().manual_seed(0)) - 0.5
        from portbench.train_cell import fed_dataset
        ds = fed_dataset(cfg.dataset, bank, torch.device("cpu"))
        state = tr.init_state(torch.Generator().manual_seed(0))
        assert tr.last_solves() is None
        tr.train_one_epoch(state, ds, np.arange(4), torch.Generator().manual_seed(1),
                           np.random.default_rng(2))
        return tr

    assert trainer("sinkhorn").last_solves() is None
    tr = trainer("hybrid")
    first = tr.last_solves()
    assert [tuple(s["assign"].shape) for s in first] == [(4, 12), (4, 12)]
    assert [s["assign"].dtype for s in first] == [torch.int32, torch.int32]
    first[0]["assign"].fill_(-7)
    assert (tr.last_solves()[0]["assign"] >= 0).all()


def _cost(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    x, y = torch.rand(b, n, 3, generator=g), torch.rand(b, n, 3, generator=g)
    return ((x[:, :, None] - y[:, None]) ** 2).sum(-1)


@pytest.mark.parametrize("warm", [False, True])
def test_the_auction_counters_are_its_sweeps_stragglers_and_problems(warm):
    """Inside a counting block (a captured step's), each solve adds its
    sweeps summed over the batch, its stragglers and its problems; outside
    one the counters' values are never made."""
    c = _cost(3, 20, 1)
    seed = prices = None
    if warm:
        _, seed, prices, _ = hybrid_assignment_warm(c, None, None, use_warm=False)
        c = c + 1e-3 * _cost(3, 20, 2)
    counters = profiling.DeviceCounters()
    with profiling.counting(counters):
        value, assign, _, sweeps = hybrid_assignment_warm(c, seed, prices, use_warm=warm)
    got = counters.read()
    assert got == {"auction_sweeps": int(sweeps.sum()), "auction_stragglers": 0,
                   "auction_problems": 3}
    for k in range(3):
        assert value[k].tolist() == linear_sum_assignment(c[k].double().numpy())[1].tolist()
    profiling.device_count("never", lambda: 1 / 0)


def test_the_stragglers_counter_sees_a_capped_auction():
    """With one sweep a phase from flat prices, the cap leaves persons
    unassigned; the counter counts them and the value's assignment takes
    their rows' argmin."""
    c = _cost(2, 24, 3)
    counters = profiling.DeviceCounters()
    with profiling.counting(counters):
        value, assign, _, sweeps = hybrid_assignment_warm(
            c, torch.full((2, 24), -1, dtype=torch.int32), torch.zeros(2, 24),
            use_warm=True, max_sweeps=1)
    got = counters.read()
    assert got["auction_stragglers"] == int((assign < 0).sum()) > 0
    assert got["auction_sweeps"] == int(sweeps.sum())
    rows = (assign < 0).nonzero()
    assert (value[rows[:, 0], rows[:, 1]] == c.argmin(-1)[rows[:, 0], rows[:, 1]]).all()
