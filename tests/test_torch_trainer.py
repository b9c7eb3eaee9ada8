"""Port parity: one registration train step vs shwd_tpu.train.Trainer, and
the port trainer's own behaviour (checkpoints, snapshots, resume, strikes,
nan_guard, config files).

Both sides get the same RegistrationBatch (made with numpy) and the same
weights (the JAX init, converted); never the same seed. PCRNet runs at its
full widths on B=4 clouds of 32 points.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shwd_torch.losses.transport as t_transport
import shwd_tpu.losses.transport as j_transport
from shwd_torch import data as td
from shwd_torch import train as tt
from shwd_torch.losses import SHWDConfig as TSHWD
from shwd_torch.losses import TransportConfig as TTransport
from shwd_torch.utils import load_checkpoint
from shwd_torch.utils.convert import load_pcrnet, load_phi, pcrnet_tree, phi_tree
from shwd_tpu import data as jd
from shwd_tpu import train as jt
from shwd_tpu.losses import SHWDConfig as JSHWD
from shwd_tpu.losses import TransportConfig as JTransport

B, N = 4, 32
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(criterion, solver, tmp_path, **kw):
    tp = dict(cost="lp", p=2.0, solver=solver, eps=5e-3, num_iters=20, num_scales=3)
    sh = dict(max_iter=1, lam=1e-3, phi_lr=1e-3)
    common = dict(experiment="t", log_dir=str(tmp_path), criterion=criterion,
                  batch_size=B, pcr_iteration_num=2, phi_num_flow_layer=2,
                  **{"lr": LR, **kw})
    jcfg = jt.TrainConfig(shwd=JSHWD(transport=JTransport(**tp), **sh), **common)
    tcfg = tt.TrainConfig(shwd=TSHWD(transport=TTransport(**tp), **sh), **common)
    return jcfg, tcfg


def _batch(seed=71):
    """A registration batch from numpy draws, as numpy arrays."""
    rng = np.random.default_rng(seed)
    target = td.shape_bank(B, N, seed=seed, kinds=("composite",))
    noisy = target + 0.02 * rng.normal(size=target.shape).astype(np.float32)
    raw = np.concatenate([rng.normal(size=(B, 4)), 0.3 * rng.normal(size=(B, 3))],
                         -1).astype(np.float32)
    raw[:, :4] /= np.linalg.norm(raw[:, :4], axis=-1, keepdims=True)
    src, rot, trans = td.apply_pose(torch.from_numpy(noisy), torch.from_numpy(raw))
    return target, src.numpy(), rot.numpy(), trans.numpy()


def _one_step(criterion, solver, tmp_path):
    """(jax loss, grads, params after, crit state after), (port state after,
    loss, grads)."""
    jcfg, tcfg = _configs(criterion, solver, tmp_path)
    arrays = _batch()
    jtr = jt.Trainer(jcfg)
    jstate = jtr.init_state(jax.random.PRNGKey(3))
    jbatch = jd.RegistrationBatch(*(jnp.asarray(a) for a in arrays))

    def loss_fn(params, crit_state):
        source, target, _ = jt.trainer._mean_subtract(jbatch)
        out = jtr.model.apply(params, target, source, jcfg.pcr_iteration_num)
        (loss, _, _), _ = jtr.crit_apply(crit_state, target,
                                         out.transformed_source, True)
        return loss

    jgrads = jax.jit(jax.grad(loss_fn))(jstate.params, jstate.crit_state)
    jnew, jloss = jtr._train_step(jstate, jbatch, train=True)

    ttr = tt.Trainer(tcfg, device="cpu")
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    load_pcrnet(tstate.model, _np(jstate.params))
    if tstate.crit_state is not None:
        load_phi(tstate.crit_state.phi, _np(jstate.crit_state.phi_params),
                 _np(jstate.crit_state.phi_state))
    tbatch = td.RegistrationBatch(*(torch.from_numpy(a) for a in arrays))
    tloss = ttr._train_step(tstate, tbatch)
    return (jloss, jgrads, jnew), (tstate, tloss)


def _compare_model(jside, tside, rtol):
    """Loss, PCRNet gradients and parameters after the Adam step.
    Gradients agree to rtol, with an absolute floor of
    rtol / 100 of the largest gradient. The first Adam step moves every
    weight by lr * g / (|g| + 1e-8), that is by +-lr whatever |g|: where
    |g| is clear of that floor both sides have the same sign and the
    weights agree to 2e-5; below it the sign is rounding noise, so there
    only |delta| <= 2 lr is asked. ``_compare_step`` adds phi."""
    (jloss, jgrads, jnew), (tstate, tloss) = jside, tside
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    tgrads = {"feature": [{k: getattr(l, k).grad.numpy() for k in ("w", "b")}
                          for l in tstate.model.feature_model.layers],
              "head": [{k: getattr(l, k).grad.numpy() for k in ("w", "b")}
                       for l in tstate.model.head]}
    gmax = max(float(np.abs(np.asarray(g)).max())
               for g in jax.tree_util.tree_leaves(jgrads))
    assert gmax > 1e-4
    after = pcrnet_tree(tstate.model)
    for group in ("feature", "head"):
        for i, jg in enumerate(jgrads[group]):
            for k in ("w", "b"):
                want = np.asarray(jg[k])
                floor = rtol * 1e-2 * gmax
                np.testing.assert_allclose(tgrads[group][i][k], want, rtol=rtol,
                                           atol=floor)
                p_want = np.asarray(jnew.params[group][i][k])
                p_got = after[group][i][k]
                clear = np.abs(want) > 4 * floor
                np.testing.assert_allclose(p_got[clear], p_want[clear], atol=2e-5)
                assert np.abs(p_got - p_want).max() <= 2 * LR + 1e-6


def _compare_step(jside, tside, rtol):
    """``_compare_model``, then phi after its inner step."""
    _compare_model(jside, tside, rtol)
    (_, _, jnew), (tstate, _) = jside, tside
    if tstate.crit_state is not None:
        tp, ts = phi_tree(tstate.crit_state.phi)
        jc = jnew.crit_state
        for a, b in zip(jax.tree_util.tree_leaves(_np(jc.phi_params)),
                        jax.tree_util.tree_leaves(tp)):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)
        # u, v are unit vectors from one power iteration on the stepped
        # weights; the near-zero last layer (entries ~1e-3 after the step)
        # turns the weights' 2e-5 into ~1e-4 of its singular vectors
        for a, b in zip(jax.tree_util.tree_leaves(_np(jc.phi_state)),
                        jax.tree_util.tree_leaves(ts)):
            np.testing.assert_allclose(b, a, atol=5e-4)


@pytest.mark.parametrize("criterion,solver", [
    ("w_cos", "sinkhorn"), ("w_cos", "hybrid"), ("cd", "sinkhorn")])
def test_train_step_matches_jax(tmp_path, criterion, solver):
    """Default CPU routes on both sides (sinkhorn: cost_matrix +
    emd2_approx). Loss and gradients rtol 1e-3 (f32, 60 Sinkhorn
    iterations and two networks in another op order)."""
    jside, tside = _one_step(criterion, solver, tmp_path)
    _compare_step(jside, tside, rtol=1e-3)


def test_train_step_matches_jax_on_the_kernel_route(tmp_path, monkeypatch):
    """The fused-kernel route forced on both sides: the Pallas kernel in
    interpret mode against the CUDA kernel's plain version (per-item eps0,
    rescaled potentials). Loss rtol 1e-3, gradients rtol 5e-3 (the plan
    amplifies dual rounding by 1/eps)."""
    monkeypatch.setattr(j_transport, "emd2_points", functools.partial(
        j_transport.emd2_points, use_pallas=True, interpret=True))
    monkeypatch.setattr(t_transport, "emd2_points", functools.partial(
        t_transport.emd2_points, use_kernel=True))
    jside, tside = _one_step("w_cos", "sinkhorn", tmp_path)
    _compare_step(jside, tside, rtol=5e-3)


def _max_update(jafter, jbefore):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree_util.tree_leaves(jafter),
                               jax.tree_util.tree_leaves(jbefore)))


@pytest.mark.parametrize("criterion,solver,min_frac", [
    ("w_cos", "sinkhorn", 0.9), ("w_cos", "hybrid", 0.7), ("cd", "sinkhorn", 0.99)])
def test_consecutive_train_steps_match_jax(tmp_path, criterion, solver, min_frac):
    """Four consecutive steps on two alternating fixed batches, so that the
    carried state is exercised: the model's Adam moments and step count,
    phi, phi's Adam state and its spectral-norm vectors.

    lr is 1e-4 here: Adam moves an entry whose gradient is rounding noise
    by +-lr with a sign that differs between any two implementations, and
    at 1e-3 those moves flip max-pool winners and the two runs drift apart
    by step 3. At 1e-4 the loss of every step agrees to rtol 1e-4 (it
    changes by 1e-2 from step to step, so an update that is 1 % wrong
    shows; a model Adam state dropped between steps puts step 3 off by
    1e-3 and step 4 by 3e-2). After the last step the pose layer agrees to
    lr / 100, and of every other tensor's entries at least ``min_frac``
    agree to lr / 10 and none differs by more than 2 lr per step. The
    max-pool leaves many noise gradients behind it, and the exact
    solver's gradient jumps where the permutation changes, hence 0.9 for
    sinkhorn, 0.7 for hybrid, 0.99 for cd."""
    steps, lr = 4, 1e-4
    jcfg, tcfg = _configs(criterion, solver, tmp_path, lr=lr)
    batches = [_batch(71), _batch(72)]
    jtr = jt.Trainer(jcfg)
    jstate = jstart = jtr.init_state(jax.random.PRNGKey(3))
    ttr = tt.Trainer(tcfg, device="cpu")
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    load_pcrnet(tstate.model, _np(jstate.params))
    if tstate.crit_state is not None:
        load_phi(tstate.crit_state.phi, _np(jstate.crit_state.phi_params),
                 _np(jstate.crit_state.phi_state))
    jlosses, tlosses = [], []
    for i in range(steps):
        arrays = batches[i % 2]
        jstate, jloss = jtr._train_step(
            jstate, jd.RegistrationBatch(*(jnp.asarray(a) for a in arrays)), train=True)
        tloss = ttr._train_step(
            tstate, td.RegistrationBatch(*(torch.from_numpy(a) for a in arrays)))
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    # the steps did move the model, and the loss with it
    assert _max_update(jstate.params, jstart.params) > 2 * lr
    assert abs(jlosses[2] / jlosses[0] - 1) > 1e-3
    after = pcrnet_tree(tstate.model)
    for k in ("w", "b"):
        np.testing.assert_allclose(after["head"][-1][k],
                                   np.asarray(jstate.params["head"][-1][k]),
                                   rtol=0, atol=lr / 100)
    for group in ("feature", "head"):
        for i, jlayer in enumerate(jstate.params[group]):
            for k in ("w", "b"):
                diff = np.abs(after[group][i][k] - np.asarray(jlayer[k]))
                assert diff.max() <= 2 * steps * lr + 1e-7
                assert np.mean(diff < lr / 10) >= min_frac, (group, i, k)
    if tstate.crit_state is not None:
        tp, _ = phi_tree(tstate.crit_state.phi)
        for a, b in zip(jax.tree_util.tree_leaves(_np(jstate.crit_state.phi_params)),
                        jax.tree_util.tree_leaves(tp)):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)
        assert float(tstate.crit_state.lam) == pytest.approx(
            float(jstate.crit_state.lam), rel=1e-6)


# -- the port trainer's own behaviour ------------------------------------------

def tiny_config(tmp_path, criterion="cd", **kw):
    kw.setdefault("num_epochs", 2)
    return tt.TrainConfig(
        experiment="t", log_dir=str(tmp_path), criterion=criterion,
        dataset=td.DatasetConfig(source_point_num=24, target_point_num=24,
                                 num_synthetic=16, cache_dir=str(tmp_path / "mc"),
                                 transform=td.TransformConfig(noise_sigma=0.01)),
        batch_size=4, pcr_iteration_num=2,
        shwd=TSHWD(transport=TTransport(cost="lp", p=2.0, solver="sinkhorn",
                                        eps=0.05, num_iters=10, num_scales=2),
                   max_iter=1, lam=1e-4, phi_lr=1e-4),
        phi_num_flow_layer=1, **kw)


def _fit(cfg, **kw):
    tr = tt.Trainer(cfg, device="cpu")
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    return tr, ds, tr.fit(ds, verbose=False, **kw)


@pytest.mark.parametrize("criterion", ["cd", "w_cos", "w1_cos", "sinkhorn",
                                       "pseudo_w_cos", "max_ssw"])
def test_trainer_runs_and_checkpoints(tmp_path, criterion):
    cfg = tiny_config(tmp_path, criterion)
    tr, _, result = _fit(cfg)
    assert len(result["history"]) == 2
    assert np.isfinite(result["history"][-1]["train_loss"])
    # the val split (3 of 16 items, < batch_size) is still evaluated
    rot = result["history"][-1]["rot_error"]
    assert np.isfinite(rot) and rot > 1.0
    rows = [json.loads(l) for l in (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    fresh = tr.init_state(torch.Generator().manual_seed(9))
    for snap in ("best_model_snap", "best_rot_error_snap", "best_trans_error_snap"):
        _, epoch = load_checkpoint(tmp_path / "t" / "models" / snap, fresh)
        assert 1 <= epoch <= 2
    assert not list((tmp_path / "t" / "models").glob("*.tmp*"))


def _scripted_eval(trainer, values):
    """Replace the validation pass by scripted (loss, rot, trans) rows."""
    rows = iter(values)
    trainer.eval_one_epoch = lambda *a, **k: next(rows)


def test_best_snapshot_holds_the_improving_epoch(tmp_path):
    """The state is updated in place, so a snapshot must be a copy: with
    val losses 1.0, 0.5, 0.9 the best-loss checkpoint holds epoch 2's
    model, phi and Adam moments, not epoch 3's."""
    cfg = tiny_config(tmp_path, "w_cos", num_epochs=3, checkpoint_flush_every=0)
    tr = tt.Trainer(cfg, device="cpu")
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    _scripted_eval(tr, [(1.0, 9.0, 9.0), (0.5, 8.0, 9.5), (0.9, 8.5, 9.9)])
    seen = []
    inner = tr.train_one_epoch

    def recording(state, *a):
        out = inner(state, *a)
        seen.append(([p.detach().clone() for p in state.model.parameters()],
                     [p.detach().clone() for p in state.crit_state.phi.parameters()],
                     state.opt.state[next(state.model.parameters())]["exp_avg"].clone()))
        return out

    tr.train_one_epoch = recording
    result = tr.fit(ds, verbose=False)
    assert result["best"]["loss"] == 0.5
    fresh = tr.init_state(torch.Generator().manual_seed(9))
    _, epoch = load_checkpoint(tmp_path / "t" / "models" / "best_model_snap", fresh)
    assert epoch == 2
    model2, phi2, mom2 = seen[1]
    model3, _, _ = seen[2]
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(), model2))
    assert not all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(), model3))
    assert all(torch.equal(a, b) for a, b in zip(fresh.crit_state.phi.parameters(), phi2))
    assert torch.equal(fresh.opt.state[next(fresh.model.parameters())]["exp_avg"], mom2)
    # the translation family last improved at epoch 1
    _, epoch = load_checkpoint(tmp_path / "t" / "models" / "best_trans_error_snap", fresh)
    assert epoch == 1
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(), seen[0][0]))


def test_interrupted_fit_still_flushes_best_snapshots(tmp_path):
    """An interrupt (SIGTERM arrives as KeyboardInterrupt) in epoch 2
    leaves epoch 1's best checkpoints on disk."""
    cfg = tiny_config(tmp_path, "cd", num_epochs=3, checkpoint_flush_every=0)
    tr = tt.Trainer(cfg, device="cpu")
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    rows = iter([(1.0, 9.0, 9.0)])

    def interrupted(*a, **k):
        try:
            return next(rows)
        except StopIteration:
            raise KeyboardInterrupt("SIGTERM") from None

    tr.eval_one_epoch = interrupted
    with pytest.raises(KeyboardInterrupt):
        tr.fit(ds, verbose=False)
    fresh = tr.init_state(torch.Generator().manual_seed(9))
    _, epoch = load_checkpoint(tmp_path / "t" / "models" / "best_model_snap", fresh)
    assert epoch == 1


def test_trainer_resume(tmp_path):
    cfg = tiny_config(tmp_path, "w_cos", num_epochs=1)
    _, _, first = _fit(cfg)
    ckpt = str(tmp_path / "t" / "models" / "best_model_snap")
    cfg2 = dataclasses.replace(cfg, load_model=ckpt, num_epochs=2, experiment="t2")
    tr2, _, second = _fit(cfg2)
    assert [r["epoch"] for r in second["history"]] == [2]
    # the resumed run started from the checkpoint, not from a fresh init:
    # its Adam state had already taken the first epoch's steps
    steps = first["history"][0]["train_steps"]
    step = second["state"].opt.state[next(second["state"].model.parameters())]["step"]
    assert steps == 3 and float(step) == 2 * steps


def test_eval_raises_on_empty_val_set(tmp_path):
    cfg = tiny_config(tmp_path)
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, val_split=0.0))
    with pytest.raises(ValueError, match="validation set"):
        _fit(cfg)


def test_early_stop_strikes_counted_and_snapshotted(tmp_path):
    """Non-improving epochs raise the strike count on the criterion state;
    past the limit phi stops moving; the count travels in checkpoints."""
    cfg = tiny_config(tmp_path, "w_cos", num_epochs=4, checkpoint_flush_every=0)
    cfg = dataclasses.replace(cfg, shwd=dataclasses.replace(cfg.shwd, early_stop_strikes=1))
    tr = tt.Trainer(cfg, device="cpu")
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    _scripted_eval(tr, [(1.0, 9.0, 9.0), (2.0, 9.0, 9.0), (3.0, 9.0, 9.0), (4.0, 8.0, 9.0)])
    phis = []
    inner = tr.train_one_epoch

    def recording(state, *a):
        out = inner(state, *a)
        phis.append([p.detach().clone() for p in state.crit_state.phi.parameters()])
        return out

    tr.train_one_epoch = recording
    result = tr.fit(ds, verbose=False)
    assert result["state"].crit_state.strikes == 3
    moved = [not all(torch.equal(a, b) for a, b in zip(phis[i], phis[i + 1]))
             for i in range(3)]
    # epoch 2 trains with 0 strikes, epoch 3 with 1 (still <= limit),
    # epoch 4 with 2 (> limit): phi frozen
    assert moved == [True, True, False]
    fresh = tr.init_state(torch.Generator().manual_seed(9))
    load_checkpoint(tmp_path / "t" / "models" / "best_rot_error_snap", fresh)
    assert fresh.crit_state.strikes == 3


def test_nan_guard_dumps_and_raises(tmp_path):
    cfg = tiny_config(tmp_path, "w_cos", nan_guard=True)
    tr = tt.Trainer(cfg, device="cpu")
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    inner = tr.crit_apply

    def poisoned(state, x, y, train=True):
        (loss, sx, sy), state = inner(state, x, y, train)
        return (loss * float("nan"), sx, sy), state

    tr.crit_apply = poisoned
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.fit(ds, verbose=False)
    dump = tmp_path / "t" / "nan_dump"
    with np.load(dump / "batch.npz") as z:
        assert z["source"].shape == (4, 24, 3) and z["igt_rotation"].shape == (4, 3, 3)
    fresh = tr.init_state(torch.Generator().manual_seed(9))
    _, epoch = load_checkpoint(dump / "state_pre_step", fresh)
    assert epoch == 0
    assert all(bool(torch.isfinite(p).all()) for p in fresh.model.parameters())


def test_phi_adam_sees_only_the_inner_objective(tmp_path):
    """The model's backward must not leak into phi's .grad: after a train
    step phi's gradients equal those of the criterion called alone on the
    same (detached) clouds."""
    cfg = tiny_config(tmp_path, "w_cos")
    tr = tt.Trainer(cfg, device="cpu")
    a = tr.init_state(torch.Generator().manual_seed(4))
    b = tr.init_state(torch.Generator().manual_seed(4))
    batch = td.RegistrationBatch(*(torch.from_numpy(x) for x in _batch(72)))
    source, target, _ = tt.trainer._mean_subtract(batch)
    out = b.model(target, source, cfg.pcr_iteration_num)
    tr.crit_apply(b.crit_state, target, out.transformed_source.detach(), True)
    tr._train_step(a, batch)
    for p, q in zip(a.crit_state.phi.parameters(), b.crit_state.phi.parameters()):
        assert p.grad is not None and torch.equal(p.grad, q.grad)
        assert torch.equal(p, q)
    assert all(p.grad is not None for p in a.model.parameters())


def test_config_roundtrip_and_jax_written_file(tmp_path):
    cfg = tiny_config(tmp_path, "w_cos", checkpoint_combined_weight=100.0)
    cfg.save(tmp_path / "c.json")
    assert tt.TrainConfig.load(tmp_path / "c.json") == cfg
    # a file written by the JAX package loads with the same values
    jcfg = jt.TrainConfig(
        experiment="j", criterion="w1_cos", batch_size=7, fused_epoch=False,
        dataset=jd.DatasetConfig(num_synthetic=33, synthetic_kinds=("composite",),
                                 transform=jd.TransformConfig(outlier_num=3)),
        shwd=JSHWD(transport=JTransport(solver="hybrid", eps=1e-3), lam=0.5))
    jcfg.save(tmp_path / "j.json")
    loaded = tt.TrainConfig.load(tmp_path / "j.json")
    assert dataclasses.asdict(loaded) == dataclasses.asdict(jcfg)
    assert loaded.dataset.synthetic_kinds == ("composite",)
    # and the defaults agree field by field
    assert dataclasses.asdict(tt.TrainConfig()) == dataclasses.asdict(jt.TrainConfig())
    # the other way round too
    assert dataclasses.asdict(jt.TrainConfig.load(tmp_path / "c.json")) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_data=2), "a 2x1 mesh needs 2 ranks; 1 given of a world of 1"),
    (dict(mesh_slices=2), "a 0x2 mesh needs 0 ranks; 1 given of a world of 1"),
])
def test_unported_options_raise_with_their_roadmap_item(tmp_path, kw, match):
    """The mesh options are ported (``tests/test_torch_trainer_parallel.py``);
    a mesh larger than this one-process world raises before any process
    group is made."""
    with pytest.raises(ValueError, match=match):
        tt.Trainer(tt.TrainConfig(log_dir=str(tmp_path), **kw), device="cpu")
    assert not torch.distributed.is_initialized()


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        assert tt.Trainer(tt.TrainConfig(log_dir=str(tmp_path))).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.Trainer(tt.TrainConfig(log_dir=str(tmp_path)))
