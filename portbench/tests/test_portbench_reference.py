"""The plain references agree with the program on the CPU at a tiny size,
and the controls (the references with TF32 products) fail the cells'
limits there too."""

import pytest

import tiny
from portbench import flow_cell, harness, train_cell


@pytest.fixture(autouse=True)
def _kernel_route(monkeypatch):
    tiny.kernel_route(monkeypatch)


def test_training_reference_follows_the_program():
    run = tiny.train_run(seed=3)
    gaps = tiny.values(run)
    assert gaps["loss_gap"] < 1e-5 and gaps["val_gap"] < 1e-3
    assert gaps["grad_gap"] < 1e-2 and gaps["change_gap"] < 1e-2
    assert gaps["phi_change_gap"] < 1e-4
    assert tiny.correct(run)


def test_flow_reference_follows_the_program():
    run = tiny.flow_run(seed=3)
    gaps = tiny.values(run)
    assert gaps["interval_w2_gap"] < 1e-5
    assert tiny.correct(run)


def test_training_control_fails_the_limits():
    run = tiny.train_run(seed=4)
    control = train_cell.extra_readings(run, controls=True)["control"]
    limits = run.workload["limits"]
    assert any(control[k] > limits[k] for k in limits)


def test_flow_control_fails_the_limits():
    run = tiny.flow_run(seed=4)
    control = flow_cell.extra_readings(run, controls=True, full_control=True)["control"]
    limits = run.workload["limits"]
    assert any(control[k] > limits[k] for k in limits)


def test_flow_reference_points_follow_the_program():
    run = tiny.flow_run(seed=2)
    where = flow_cell.extra_readings(run, controls=False)["where"]
    assert where["interval_gap"] < 1e-5


def test_a_reading_is_the_gap_of_norms_by_the_worst_leaf():
    from portbench import compare
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-9}
    # leaf c is measured against the median leaf's norm (1.0), not its own
    assert compare.worst_leaf_gap(prog, ref) == (pytest.approx(0.1), "a")
    assert compare.moved_leaves(ref) == {"a", "b"}
    assert harness.Check("x", float("nan"), 1.0).ok is False
