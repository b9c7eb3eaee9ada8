"""The frozen counts against values worked by hand at the cells' shapes."""

import pytest

from portbench import harness, yardstick


def test_peaks_are_the_h100_data_sheet_f32_hbm_and_sfu_rates():
    assert yardstick.F32_FLOPS_PER_S == 67e12
    assert yardstick.HBM_BYTES_PER_S == 3.35e12
    assert yardstick.SFU_OPS_PER_S == pytest.approx(4.18176e12)


def test_k3_counts_at_b128_n128():
    # entries 128^3 = 2,097,152; 50 x 4 = 200 sweeps: 2*200*6 + 8 + 4 + 7 = 2419
    # ops an entry; 401 exps an entry plus 200 logs per row and column
    b, ops, exps = yardstick.k3_counts(128, 128, 128, 50, 4)
    assert ops == 5_073_010_688
    assert exps == 847_511_552
    assert b == 524_800
    assert yardstick.bound_s(b, ops, exps) == pytest.approx(202.67e-6, rel=1e-4)


def test_k1_counts_at_the_flow_cost():
    b, ops, exps = yardstick.k1_counts(1, 1200, 1200, 40, 8)
    assert ops == 5_539_680_000
    assert exps == 923_808_000
    assert b == 5_769_604
    assert yardstick.bound_s(b, ops, exps) == pytest.approx(220.91e-6, rel=1e-4)


def test_k2_counts_only_the_bytes_of_its_cost():
    b, ops, exps = yardstick.k2_counts(1, 1200)
    assert (b, ops, exps) == (5_760_000, 0.0, 0.0)
    assert yardstick.bound_s(b, ops, exps) == pytest.approx(1.7194e-6, rel=1e-4)


def test_pcrnet_forward_flops_at_b128():
    # PointNet 2*16384*147,648 per encode, four encodes; head 2*128*4,065,024, three times
    assert yardstick.pcrnet_forward_flops(128, 128, 3) == 22_474_457_088


def test_train_step_counts_the_duals_forward_only():
    step = yardstick.wcos_train_step_flops(128, 128, pose_iterations=3, blocks=3,
                                           sinkhorn_iterations=200, inner_steps=1)
    diff = yardstick.phi_forward_flops(128 * 256, 3) + yardstick.cost_flops(128, 128, 128)
    duals = 200 * 8.0 * 128 ** 3
    assert step == pytest.approx(3 * 22_474_457_088 + 2 * (3 * diff + duals))


def test_flow_step_computes_the_duals_once_and_an_auction_per_solve():
    step = yardstick.flow_step_flops(1200, blocks=5, inner_steps=1, dual_iterations=320,
                                     auction_sweeps=128)
    per_solve = (3 * (yardstick.phi_forward_flops(2400, 5) + 1200 ** 2 * 8.0)
                 + 128 * 4.0 * 1200 ** 2)
    assert step == pytest.approx(2 * per_solve + 320 * 8.0 * 1200 ** 2)


@pytest.mark.parametrize("name,count", [("mfu.train", "train_steps"),
                                        ("mfu.flow", "flow_iterations")])
def test_mfu_divides_by_the_f32_peak(name, count):
    run = harness.Run(cell="x", seed=0, seconds=1, trace=True, config={}, workload={},
                      window_s=2.0, model_flops=67e12, counts={count: 1})
    assert harness.metric_reader(name)(run) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["k3_roofline.train", "k1_roofline.flow",
                                  "k2_roofline.flow"])
def test_a_roofline_reader_reads_its_probe_and_nothing_else(name):
    kernel = name.split("_")[0]
    run = harness.Run(cell="x", seed=0, seconds=1, trace=True, config={}, workload={})
    assert harness.metric_reader(name)(run) is None
    run.kernels = {kernel: lambda: 42.0}
    assert harness.metric_reader(name)(run) == 42.0
