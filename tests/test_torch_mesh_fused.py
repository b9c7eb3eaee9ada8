"""The data-parallel Trainer on its fused path, on 2 gloo ranks on the CPU.

Under a mesh the fused path holds each rank's rows as the static inputs of
the captured train step, keeps the criterion's collectives and the
gradient bucket's all-reduce inside the step, and reduces the epoch's loss
and the validation sums outside the graphs (``Trainer`` docstring). On the
CPU a graph is its step called directly, so the fused meshed fit must give
the ``fused_epoch=False`` meshed fit's history and weights bit for bit,
with the same collectives. Two criteria with collectives inside the step:
``w_cos`` on the ``sinkhorn`` solver (eps0 over the group on the CPU route,
phi's inner gradients, the gradient bucket) and ``max_ssw`` (a summed
loss: keys for the global batch, phi's summed gradients). 50 shapes, half
in validation: one train step of 16 an epoch, and a validation batch of
16 split over the ranks and a last one of 9 that does not divide and runs
whole.
One spawn, about 15 s on one worker.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import dataclasses
import shutil

import pytest
import torch

import torch_dist
from shwd_torch.losses import MaxSSWConfig
from test_torch_trainer_parallel import _fit_cfg

CASES = {
    "w_cos-sinkhorn": dict(criterion="w_cos", solver="sinkhorn"),
    "max_ssw": dict(criterion="max_ssw", max_ssw=MaxSSWConfig(
        num_projections=8, p=1.0, max_iter=2, phi_lr=1e-2, minibatch=5)),
}
KEYS = ("train_loss", "val_loss", "rot_error", "trans_error")


@pytest.fixture(scope="module")
def both_paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_fused")
    cfgs = []
    for case, kw in CASES.items():
        kw = dict(kw)
        cfg = _fit_cfg(tmp, case, solver=kw.pop("solver", "sinkhorn"), **kw)
        cfgs.append(dataclasses.replace(
            cfg, dataset=dataclasses.replace(cfg.dataset, num_synthetic=50,
                                             val_split=0.5)).to_json())
    out = torch_dist.spawn(torch_dist.fit_both_paths, 2, tmp, cfgs)
    shutil.rmtree(tmp)  # the fits' snapshots: ~430 MB
    return {case: [r[i] for r in out] for i, case in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_meshed_fused_fit_equals_the_meshed_per_step_fit(both_paths, case):
    """On each rank: the fused fit took the fused path (graphs for the
    train step, the split eval batch and the whole tail), and its history,
    final weights and collective count equal the per-step meshed fit's bit
    for bit; both ranks hold the same history."""
    ranks = both_paths[case]
    for runs in ranks:
        fused, step = runs[True], runs[False]
        assert fused["path"] == "fused"
        assert step["path"] == "per_step: fused_epoch=False"
        assert [r["path"] for r in fused["history"]] == ["fused", "fused"]
        assert [[r[k] for k in KEYS] for r in fused["history"]] == \
            [[r[k] for k in KEYS] for r in step["history"]]
        assert all(torch.equal(a, b) for a, b in zip(fused["params"], step["params"]))
        assert fused["collectives"] == step["collectives"] > 0
        names = sorted(g["name"].split(" at ")[1] for g in fused["graphs"])
        # the train step and the full eval batch on 8 rows, the tail whole
        assert names == ["(8, 16, 3)", "(8, 16, 3)", "(9, 16, 3)"], names
    assert [[r[k] for k in KEYS] for r in ranks[0][True]["history"]] == \
        [[r[k] for k in KEYS] for r in ranks[1][True]["history"]]
