"""The exact-EMD training cell ``pcrnet_wcos_hybrid.train_b128`` on the CPU
at a tiny size (a 40-shape bank of 16 points at batch 4; the program runs
its plain twins of the kernels): a sound run is correct, each fault that
its limits were read against, planted in the program, makes it not correct,
the control fails a limit, a program without the read of its solves stops
at set-up, and its FLOP counts and counter reader by hand."""

import copy
import time

import pytest
import torch

from portbench import harness, train_hybrid_cell, yardstick, yardstick_hybrid
from shwd_torch.train.trainer import Trainer
from shwd_torch.utils import profiling

CELL = "pcrnet_wcos_hybrid.train_b128"


def _run(seed: int) -> harness.Run:
    _, _, config, workload = harness.cell_inputs(CELL)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config.update(bank_shapes=40, points=16)
    workload["batch_size"] = 4
    return harness.Run(cell=CELL, seed=seed, seconds=0.0, trace=False, config=config,
                       workload=workload, device=torch.device("cpu"),
                       t_start=time.perf_counter())


def _correct(run) -> bool:
    return harness.result_line(run, {}, {})["correct"]


@pytest.mark.parametrize("seed", [3, 5])
def test_a_sound_tiny_run_is_correct(seed):
    run = _run(seed)
    train_hybrid_cell.run_cell(run, lambda: None)
    assert _correct(run), run.checks
    assert [c.name for c in run.checks] == list(run.workload["limits"])


@pytest.mark.parametrize("fault", sorted(train_hybrid_cell.FAULTS))
def test_each_planted_fault_makes_the_run_not_correct(fault):
    # at this size (16 points) eps_final 1e-3 leaves some seeds' assignments
    # optimal; on seed 10 it does not, with one torch thread or two (at
    # N=128 every seed read on the card shows it)
    run = train_hybrid_cell.faulty_run(_run(10), fault)
    assert not _correct(run), run.checks


def test_the_control_fails_a_limit():
    run = _run(4)
    train_hybrid_cell.run_cell(run, lambda: None)
    follow = harness.reference(run.config).follow
    control = follow(**{**run.check_inputs, "assignments": None}, tf32=True)
    at_control = follow(**{**run.check_inputs, "assignments": control["assignments"]})
    values = train_hybrid_cell.check_values(
        {**train_hybrid_cell.as_readings(control), "solves": control["solves"],
         "non_permutations": 0}, at_control)
    limits = run.workload["limits"]
    assert values["non_permutations"] == 0 and values["assignment_gap"] <= 1e-12
    assert any(values[k] > limits[k] for k in limits)


def test_a_program_without_the_read_of_its_solves_stops_at_set_up(monkeypatch):
    monkeypatch.delattr(Trainer, "last_solves")
    run = _run(3)
    t0 = time.perf_counter()
    with pytest.raises(harness.MissingReading, match="Trainer.last_solves"):
        train_hybrid_cell.run_cell(run, lambda: None)
    assert time.perf_counter() - t0 < 5 and not run.phases


def test_hybrid_step_counts_at_b128_n128():
    # PCRNet as in the sinkhorn cell; phi and the cost of two differentiated
    # solves; one warm-up of 200 iterations at 8 FLOPs an entry
    step = yardstick_hybrid.hybrid_train_step_flops(128, 128, pose_iterations=3, blocks=3,
                                                    warmup_iterations=200, inner_steps=1)
    diff = yardstick.phi_forward_flops(128 * 256, 3) + yardstick.cost_flops(128, 128, 128)
    assert step == pytest.approx(3 * 22_474_457_088 + 2 * 3 * diff + 200 * 8.0 * 128 ** 3)
    val = yardstick_hybrid.hybrid_val_batch_flops(102, 128, pose_iterations=3, blocks=3,
                                                  warmup_iterations=200)
    assert val == pytest.approx(yardstick.pcrnet_forward_flops(102, 128, 3)
                                + yardstick.phi_forward_flops(102 * 256, 3)
                                + yardstick.cost_flops(102, 128, 128)
                                + 200 * 8.0 * 102 * 128 ** 2)


def test_sweeps_per_solve_reads_the_train_graphs_counters():
    """Sweeps over problems, each collect weighted by its replays; the eval
    graph's and a record without counters are left out; None without
    counters."""
    base = time.perf_counter()
    profiling.clear()
    train = "train step of w_cos/hybrid at (128, 128, 3)"
    for name, replays, counts in (
            (train, 12, {"auction_sweeps": 300, "auction_problems": 256}),
            (train, 4, {"auction_sweeps": 600, "auction_problems": 256}),
            ("eval step of w_cos/hybrid at (128, 128, 3)", 4,
             {"auction_sweeps": 9999, "auction_problems": 128})):
        profiling.note("graph.collect", graph=name, replays=replays, graph_ms=1.0, ms={},
                       counts=counts)
    profiling.note("graph.collect", graph=train, replays=3, graph_ms=1.0, ms={})
    run = harness.Run(cell=CELL, seed=0, seconds=1, trace=True, config={}, workload={},
                      t_start=base - 1.0, setup_s=1.0,
                      window_s=time.perf_counter() - base + 1.0)
    read = harness.metric_reader("auction_sweeps_per_solve.hybrid")
    assert read(run) == pytest.approx((12 * 300 + 4 * 600) / (16 * 256))
    profiling.clear()
    assert read(run) is None
