"""The evaluation harness (success curves in one pass) and the criterion
states in checkpoints: parity with shwd_tpu.train.evaluate's errors, the
one-pass curves against a recount per threshold, every criterion's state
through a checkpoint, and a resumed run against an uninterrupted one.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch import data as td
from shwd_torch import train as tt
from shwd_torch.losses import SHWDConfig as TSHWD
from shwd_torch.losses import TransportConfig as TTransport
from shwd_torch.train import evaluate as te
from shwd_torch.utils import load_checkpoint, save_checkpoint
from shwd_torch.utils.convert import load_pcrnet
from shwd_tpu import data as jd
from shwd_tpu import train as jt
from shwd_tpu.ops.quaternion import rotation_error_deg, translation_error
from test_torch_trainer import _batch, _configs, _np

CRITERIA = ["w_cos", "w1_cos", "pseudo_w_cos", "max_ssw", "cd", "sinkhorn"]


def _cfg(tmp_path, criterion="cd", solver="sinkhorn", **kw):
    kw = {"num_epochs": 1, "batch_size": 4, **kw}
    return tt.TrainConfig(
        experiment="e", log_dir=str(tmp_path), criterion=criterion,
        dataset=td.DatasetConfig(source_point_num=24, target_point_num=24,
                                 num_synthetic=20, cache_dir=str(tmp_path / "mc"),
                                 transform=td.TransformConfig(noise_sigma=0.01)),
        pcr_iteration_num=2,
        shwd=TSHWD(transport=TTransport(cost="lp", p=2.0, solver=solver, eps=0.05,
                                        num_iters=10, num_scales=2, num_projections=16),
                   max_iter=1, lam=1e-4, phi_lr=1e-4),
        phi_num_flow_layer=1, **kw)


def test_errors_step_matches_jax(tmp_path):
    """Per-sample rotation and translation errors of one batch through the
    JAX init of PCRNet, converted: atol 1e-3 deg and 1e-5."""
    jcfg, tcfg = _configs("cd", "sinkhorn", tmp_path)
    arrays = _batch()
    jtr = jt.Trainer(jcfg)
    params = jtr.init_state(jax.random.PRNGKey(5)).params
    jb = jd.RegistrationBatch(*(jnp.asarray(a) for a in arrays))
    source, target, translation = jt.trainer._mean_subtract(jb)
    out = jtr.model.apply(params, target, source, jcfg.pcr_iteration_num)
    jrot = np.asarray(rotation_error_deg(jb.igt_rotation, out.est_R))
    jtrans = np.asarray(translation_error(jb.igt_rotation, translation, out.est_t[:, 0, :]))

    model = tt.Trainer(tcfg, device="cpu").init_state(torch.Generator().manual_seed(0)).model
    load_pcrnet(model, _np(params))
    rot, trans, moved = te.errors_step(
        model, td.RegistrationBatch(*(torch.from_numpy(a) for a in arrays)),
        tcfg.pcr_iteration_num)
    assert rot.shape == (4,) and moved.shape == (4, 32, 3)
    assert jrot.min() > 1.0          # a random model: errors of real size
    np.testing.assert_allclose(rot.numpy(), jrot, rtol=0, atol=1e-3)
    np.testing.assert_allclose(trans.numpy(), jtrans, rtol=0, atol=1e-5)


def test_success_curves_are_the_jax_definition():
    """The thresholds and the curve of the JAX package's evaluate, on the
    same per-sample errors, exactly."""
    rng = np.random.default_rng(0)
    rot = (180 * rng.uniform(size=57) ** 2).astype(np.float32)
    rot[:5] = [0.0, 1.0, 45.0, 179.99, 180.0]
    trans = rng.uniform(size=57).astype(np.float32)
    rot_thr = np.arange(0, 181, 1, dtype=np.float64)
    trans_thr = np.arange(0, 1.01, 0.01)
    np.testing.assert_array_equal(te.ROT_THRESHOLDS, rot_thr)
    np.testing.assert_array_equal(te.TRANS_THRESHOLDS, trans_thr)
    np.testing.assert_array_equal(te.success_curves(rot, rot_thr),
                                  (rot[None, :] <= rot_thr[:, None]).mean(1))
    np.testing.assert_array_equal(te.success_curves(trans, trans_thr),
                                  (trans[None, :] <= trans_thr[:, None]).mean(1))


def _recount(cfg, state, thr_rot, thr_trans):
    """The definition of the original harness: one full pass over the
    split per threshold, counting the samples within it."""
    ds = td.RegistrationDataset(cfg.dataset, "test", device="cpu")
    out = []
    for thr, which in [(t, 0) for t in thr_rot] + [(t, 1) for t in thr_trans]:
        gen = torch.Generator().manual_seed(cfg.seed + 999)
        hits = total = 0
        for batch in ds.batches(gen, np.arange(len(ds)), cfg.batch_size, shuffle=False,
                                drop_remainder=False):
            err = te.errors_step(state.model, batch, cfg.pcr_iteration_num)[which]
            hits += int((err.double() <= thr).sum())
            total += err.shape[0]
        out.append(hits / total)
    return out


def test_one_pass_curves_equal_a_pass_per_threshold(tmp_path):
    """A split of 8 test shapes at batch 3 (a remainder batch), a trained
    model: the one-pass curves at five thresholds of each kind equal the
    recount, both curves are non-decreasing and end at 1."""
    cfg = _cfg(tmp_path, batch_size=3, num_epochs=2)
    tr = tt.Trainer(cfg, device="cpu")
    res = tr.fit(td.RegistrationDataset(cfg.dataset, "train", device="cpu"), verbose=False)
    state = res["state"]
    out = te.evaluate(cfg, state=state, device="cpu")
    assert out.per_sample_rot.shape == (8,)
    rot_idx, trans_idx = [0, 5, 30, 90, 180], [0, 3, 10, 50, 100]
    got = ([out.rot_success_ratio[i] for i in rot_idx]
           + [out.trans_success_ratio[i] for i in trans_idx])
    want = _recount(cfg, state, [out.rot_thresholds[i] for i in rot_idx],
                    [out.trans_thresholds[i] for i in trans_idx])
    assert got == want
    assert 0 < max(got[:5]) and min(got[:4]) < 1
    for curve in (out.rot_success_ratio, out.trans_success_ratio):
        assert (np.diff(curve) >= 0).all() and curve[-1] == 1.0
    assert out.mean_rot_error == pytest.approx(float(out.per_sample_rot.mean()))


def test_split_smaller_than_the_batch_and_saved_files(tmp_path):
    """The test split (8 shapes) at the default batch of 32 still
    evaluates; the snapshot clouds and the curves are written."""
    cfg = _cfg(tmp_path, batch_size=32)
    tr = tt.Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    out = te.evaluate(cfg, state=state, device="cpu", save_clouds_to=str(tmp_path / "ev"))
    assert out.per_sample_rot.shape == (8,) and np.isfinite(out.mean_trans_error)
    with np.load(tmp_path / "ev" / "qualitative.npz") as z:
        assert z["transformed_source"].shape == (24, 3)
    with np.load(tmp_path / "ev" / "success_curves.npz") as z:
        np.testing.assert_array_equal(z["rot_success"], out.rot_success_ratio)
        np.testing.assert_array_equal(z["trans_thresholds"], out.trans_thresholds)


def _state_dicts(state):
    """Everything a TrainState carries, as flat name -> tensor or value."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out["opt"] = state.opt.state_dict()
    crit = state.crit_state
    if crit is not None:
        for f in dataclasses.fields(crit):
            v = getattr(crit, f.name)
            if isinstance(v, torch.nn.Module):
                out.update({f"crit.{f.name}.{k}": t for k, t in v.state_dict().items()})
            elif isinstance(v, torch.optim.Optimizer):
                out[f"crit.{f.name}"] = v.state_dict()
            elif isinstance(v, torch.Generator):
                out[f"crit.{f.name}"] = v.get_state()
            else:
                out[f"crit.{f.name}"] = v
    return out


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("criterion", CRITERIA)
def test_checkpoint_round_trip_and_evaluate_from_it(tmp_path, criterion):
    """After a train step, the whole state (model, its Adam state, the
    criterion's flows or chart with their buffers, optimizer, lam,
    strikes and generator) goes through a checkpoint into a state drawn
    from another seed, and ``evaluate`` gives the same per-sample errors,
    bit for bit, from the file as from the state in memory."""
    cfg = _cfg(tmp_path, criterion, max_ssw=tt.config.MaxSSWConfig(num_projections=16,
                                                                    max_iter=1))
    tr = tt.Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    tr.train_one_epoch(state, ds, np.arange(8), torch.Generator().manual_seed(1),
                       np.random.default_rng(0))
    if criterion in ("w_cos", "w1_cos"):
        state.crit_state.strikes = 2
    path = tmp_path / "ck"
    save_checkpoint(path, state, 3)
    fresh = tr.init_state(torch.Generator().manual_seed(7))
    assert not _equal(_state_dicts(fresh), _state_dicts(state))
    _, epoch = load_checkpoint(path, fresh)
    assert epoch == 3
    want, got = _state_dicts(state), _state_dicts(fresh)
    assert want.keys() == got.keys()
    for k in want:
        assert _equal(got[k], want[k]), k
    mem = te.evaluate(cfg, state=state, device="cpu")
    disk = te.evaluate(cfg, checkpoint=str(path), device="cpu")
    np.testing.assert_array_equal(disk.per_sample_rot, mem.per_sample_rot)
    np.testing.assert_array_equal(disk.per_sample_trans, mem.per_sample_trans)


def test_checkpoint_of_another_criterion_is_refused(tmp_path):
    a = tt.Trainer(_cfg(tmp_path, "w_cos"), device="cpu")
    b = tt.Trainer(_cfg(tmp_path, "max_ssw"), device="cpu")
    save_checkpoint(tmp_path / "ck", a.init_state(torch.Generator().manual_seed(0)), 1)
    with pytest.raises(ValueError, match="SHWDState"):
        load_checkpoint(tmp_path / "ck", b.init_state(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("criterion,solver", [("w_cos", "ssw"), ("max_ssw", "sinkhorn")])
def test_resumed_run_gives_the_uninterrupted_losses(tmp_path, criterion, solver):
    """Two epochs, a checkpoint, a fresh state from another seed loaded
    from it, two more epochs: the same train and validation losses as four
    uninterrupted epochs on the same data stream. The criterion draws its
    frames from its generator, so this holds only because the generator's
    state travels in the checkpoint."""
    cfg = _cfg(tmp_path, criterion, solver,
               max_ssw=tt.config.MaxSSWConfig(num_projections=16, max_iter=1))
    tr = tt.Trainer(cfg, device="cpu")
    ds = td.RegistrationDataset(cfg.dataset, "train", device="cpu")
    train_idx, val_idx = ds.train_val_indices(np.random.default_rng(0))

    def run(state, epochs, gen, rng):
        rows = []
        for _ in range(epochs):
            state, loss = tr.train_one_epoch(state, ds, train_idx, gen, rng)
            rows.append((loss, *tr.eval_one_epoch(state, ds, val_idx, gen)))
        return rows

    straight = run(tr.init_state(torch.Generator().manual_seed(0)), 4,
                   torch.Generator().manual_seed(1), np.random.default_rng(2))
    gen, rng = torch.Generator().manual_seed(1), np.random.default_rng(2)
    state = tr.init_state(torch.Generator().manual_seed(0))
    first = run(state, 2, gen, rng)
    save_checkpoint(tmp_path / "ck", state, 2)
    resumed = tr.init_state(torch.Generator().manual_seed(9))
    load_checkpoint(tmp_path / "ck", resumed)
    assert first + run(resumed, 2, gen, rng) == straight
    assert len(set(r[0] for r in straight)) == 4


def test_evaluate_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.evaluate(_cfg(tmp_path), checkpoint="unused")
