"""The port's data-parallel Trainer and its collective sites, on gloo
processes on the CPU.

Every rank runs the same program from the same seed and takes its rows of
each global batch (``tests/torch_dist.py``; a spawn costs about 4 s). The
fits are held against the port's one-process fit at the JAX package's
tolerances (``tests/test_parallel.py``): the JAX mesh fit draws its weights
and poses from ``jax.random``, so across packages the data-parallel train
step is held instead, from the same weights on the same batch, against the
JAX step on a mesh with data = 2. About 85 s on one worker: nine spawns
and the JAX step's compile (30 s).
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from shwd_torch import data as td
from shwd_torch import train as tt
from shwd_torch.losses import MaxSSWConfig, SHWDConfig, TransportConfig
from shwd_tpu import data as jd
from shwd_tpu import train as jt
from test_torch_trainer import _batch, _compare_step, _configs, _np


def _fit_cfg(tmp_path, name, criterion="w_cos", solver="ssw", **kw):
    """``tests/test_parallel.py::_fit_cfg`` in the port."""
    fields = dict(
        experiment=name, log_dir=str(tmp_path), criterion=criterion,
        dataset=td.DatasetConfig(
            source_point_num=16, target_point_num=16, num_synthetic=64,
            synthetic_kinds=("composite",), cache_dir=str(tmp_path / "mc"),
            transform=td.TransformConfig(noise_sigma=0.0)),
        num_epochs=2, batch_size=16, pcr_iteration_num=2,
        shwd=SHWDConfig(
            transport=TransportConfig(cost="geodesic" if solver == "ssw" else "lp",
                                      p=2.0, solver=solver, num_projections=8,
                                      eps=0.05, num_iters=10, num_scales=3),
            max_iter=1, lam=1e-4, phi_lr=1e-4),
        phi_num_flow_layer=1, seed=7)
    fields.update(kw)
    return tt.TrainConfig(**fields)


def _one_process(cfg):
    tr = tt.Trainer(cfg, device="cpu")
    return tr.fit(td.RegistrationDataset(cfg.dataset, "train", device="cpu"),
                  verbose=False)["history"]


def _same_history(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.isfinite(g["train_loss"])
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(g["rot_error"], w["rot_error"], rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("data,slices", [(4, 1), (2, 2)])
def test_fit_on_four_ranks_matches_one_process(tmp_path, data, slices):
    """``w_cos``/``ssw`` on 4 ranks: every rank's per-epoch train loss,
    validation loss and rotation error equal the one-process fit (rtol
    2e-3, atol 1e-5 / 1e-3); only rank 0 writes the run's files.

    lr is 1e-4 here, not the 1e-3 of the JAX test: from the same weights the
    ranks' averaged gradient differs from the one-process gradient by
    rounding (6e-6 of its largest entry at the first step), and at 1e-3
    Adam and the circle OT's jumping optimal shift grow that into a 4 %
    gradient difference by the fourth step and 8 % of the rotation error by
    epoch 2, on 2 ranks as on 4. At 1e-4 the two fits agree to 1e-5."""
    cfg = _fit_cfg(tmp_path, "fit", lr=1e-4)
    want = _one_process(cfg)
    out = torch_dist.spawn(torch_dist.fit, 4, tmp_path, cfg.to_json(), data, slices)
    for rank, r in enumerate(out):
        _same_history(r["history"], want)
        assert r["wrote"] == (rank == 0)


CRITERIA = {
    "w_cos-sinkhorn": dict(criterion="w_cos", solver="sinkhorn"),
    "w_cos-hybrid": dict(criterion="w_cos", solver="hybrid"),
    "sinkhorn": dict(criterion="sinkhorn", sinkhorn_iter=20),
    "cd-nan_guard": dict(criterion="cd", nan_guard=True),
    "pseudo_w_cos": dict(criterion="pseudo_w_cos", solver="sinkhorn", pseudo_phi_num=2),
    "max_ssw": dict(criterion="max_ssw", max_ssw=MaxSSWConfig(
        num_projections=8, p=1.0, max_iter=2, phi_lr=1e-2, minibatch=5)),
}


def _criterion_cfg(tmp_path, case):
    """45 shapes: 36 train (two batches of 16) and 9 in validation, so the
    last validation batch (1 cloud) does not divide over 2 ranks."""
    kw = dict(CRITERIA[case])
    solver = kw.pop("solver", "sinkhorn")
    cfg = _fit_cfg(tmp_path, case, solver=solver, **kw)
    return dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset,
                                                                num_synthetic=45))


@pytest.fixture(scope="module")
def criteria_fits(tmp_path_factory):
    """Every case of CRITERIA fitted on the same 2 ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp("criteria")
    cfgs = [_criterion_cfg(tmp, case).to_json() for case in CRITERIA]
    out = torch_dist.spawn(torch_dist.fits, 2, tmp, cfgs, 2, 1)
    yield tmp, {case: [r[i] for r in out] for i, case in enumerate(CRITERIA)}
    shutil.rmtree(tmp)  # the fits' snapshots: ~1 GB


@pytest.mark.parametrize("case", list(CRITERIA))
def test_fit_on_two_ranks_matches_one_process(criteria_fits, case):
    """One tiny fit per criterion on 2 ranks against the one-process fit, at
    the tolerances above; the last validation batch is computed whole on
    both ranks. ``cd`` runs the per-step path (``nan_guard``: the loss read
    every step)."""
    tmp, fits = criteria_fits
    want = _one_process(_criterion_cfg(tmp, case))
    for r in fits[case]:
        _same_history(r["history"], want)


def test_collective_sites_match_one_process(tmp_path):
    """On 2 ranks, each op whose single-device value is batch-wide gives the
    one-process value on the whole batch: emd2_approx (eps0 = max |C|, one
    half of the batch 10x the other), the auction's eps0 (the cost range,
    exact), phi after an SHWD train call (phi's gradient averaged) and after
    a max-SSW call with a minibatch of 3 (keys drawn for the global batch,
    phi's gradient summed; its value summed), and the pseudo-SHWD value
    (each flow's batch mean before the max). rtol 1e-5; each fails without
    its collective."""
    rng = np.random.default_rng(0)
    cost = rng.uniform(size=(4, 8, 8)).astype(np.float32)
    cost[2:] *= 10
    x = rng.normal(size=(4, 8, 3)).astype(np.float32)
    y = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    want = torch_dist.sites(cost, x, y)
    for r in torch_dist.spawn(torch_dist.collective_sites, 2, tmp_path, cost, x, y):
        assert r["eps0"] == want["eps0"]
        for k in ("emd2", "shwd_loss", "shwd_phi", "ssw_value", "ssw_phi", "pseudo"):
            np.testing.assert_allclose(r[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_train_step_on_two_ranks_matches_the_jax_mesh_step(tmp_path):
    """``w_cos``/``sinkhorn`` from the same weights on the same batch (B=4,
    N=32): the port's step on 2 ranks against the JAX step with the batch
    sharded over data = 2 (slices = 4 replicas on the 8-device mesh). Loss
    and averaged gradients rtol 1e-3, the parameters after the Adam step
    and phi after its inner step as ``test_torch_trainer._compare_step``."""
    jcfg, tcfg = _configs("w_cos", "sinkhorn", tmp_path)
    jcfg = dataclasses.replace(jcfg, mesh_data=2, mesh_slices=4)
    arrays = _batch()
    jtr = jt.Trainer(jcfg)
    jstate = jtr.init_state(jax.random.PRNGKey(3))
    jbatch = jtr._shard_batch(jd.RegistrationBatch(*(jnp.asarray(a) for a in arrays)))

    def loss_fn(params, crit_state):
        source, target, _ = jt.trainer._mean_subtract(jbatch)
        out = jtr.model.apply(params, target, source, jcfg.pcr_iteration_num)
        (loss, _, _), _ = jtr.crit_apply(crit_state, target, out.transformed_source, True)
        return loss

    jgrads = jax.jit(jax.grad(loss_fn))(jstate.params, jstate.crit_state)
    jnew, jloss = jtr._train_step(jstate, jbatch, train=True)

    out = torch_dist.spawn(torch_dist.train_step, 2, tmp_path, tcfg.to_json(),
                           _np(jstate.params), _np(jstate.crit_state.phi_params),
                           _np(jstate.crit_state.phi_state), arrays)
    for r in out:
        tstate = tt.Trainer(tcfg, device="cpu").init_state(torch.Generator().manual_seed(0))
        tstate.model.load_state_dict(r["model"])
        for p, g in zip(tstate.model.parameters(), r["grads"]):
            p.grad = g
        tstate.crit_state.phi.load_state_dict(r["phi"])
        _compare_step((jloss, jgrads, jnew), (tstate, torch.tensor(r["loss"])), rtol=1e-3)


def test_batch_size_must_divide_over_data(tmp_path):
    """A training batch that does not split over the data ranks raises on
    every rank, as in the JAX trainer."""
    cfg = _fit_cfg(tmp_path, "odd", batch_size=5)
    for msg in torch_dist.spawn(torch_dist.fit_raises, 2, tmp_path, cfg.to_json(), 2):
        assert msg is not None and "batch_size=5 must divide evenly" in msg
