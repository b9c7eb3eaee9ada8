"""The port's trainer state in the JAX layout (``shwd_torch.utils.convert.
export_state``) and back (``load_state``).

Every state a registration fit carries (PCRNet and its Adam; SHWD's
Residual phi, its Adam, lam and strikes; max-SSW's MLP or encoder-flow
chart and its Adam; the pseudo criterion's stacked frozen flows, Residual
or Planar; the epoch) goes out and comes back bit for bit. The exported
tree, read into the JAX package's state (``tests/replay_fit.py::
jax_state``), gives the port's PCRNet pose and criterion value within the
tolerances of ``test_torch_init_states.py``; and the exported keys are
the ones ``tests/write_init_states.py::flatten`` writes for the same JAX
state. Full-width PCRNet, B=2 clouds of 16 points.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shwd_torch import data as td
from shwd_torch import train as tt
from shwd_torch.losses import MaxSSWConfig, SHWDConfig, TransportConfig
from shwd_torch.utils import convert
from shwd_tpu import data as jd
from shwd_tpu import train as jt
from shwd_tpu.train.config import config_from_dict

import json

import replay_fit
import write_init_states as writer

POSE_TOL = dict(rtol=1e-5, atol=1e-6)      # test_torch_init_states.py
VALUE_TOL = dict(rtol=1e-5, atol=0)
KINDS = {
    "w_cos": dict(criterion="w_cos"),
    "max_ssw": dict(criterion="max_ssw", max_ssw_chart="mlp"),
    "max_ssw_encoder_flow": dict(criterion="max_ssw", max_ssw_chart="encoder_flow"),
    "pseudo_w_cos": dict(criterion="pseudo_w_cos"),
    "pseudo_planar": dict(criterion="pseudo_w_cos", flow_name="Planar"),
}


def _config(kind, tmp_path):
    return tt.TrainConfig(
        log_dir=str(tmp_path), batch_size=2, pcr_iteration_num=2,
        shwd=SHWDConfig(transport=TransportConfig(solver="sinkhorn", num_iters=10,
                                                  num_scales=2),
                        max_iter=1, lam=1e-3, phi_lr=1e-3),
        max_ssw=MaxSSWConfig(num_projections=8, max_iter=1, p=1.0, phi_lr=1e-3),
        pseudo_phi_num=2, **KINDS[kind])


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, size=(2, 16, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0].astype(np.float32)
    trans = (0.3 * rng.normal(size=(2, 3))).astype(np.float32)
    source = (target @ rot.transpose(0, 2, 1) + trans[:, None]).astype(np.float32)
    return target, source, rot, trans


def _torch_batch(arrays):
    return td.RegistrationBatch(*(torch.from_numpy(a) for a in arrays))


def _stepped(kind, tmp_path):
    """(trainer, state) one train step into a fit: both Adams hold moments."""
    trainer = tt.Trainer(_config(kind, tmp_path), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    trainer._train_step(state, _torch_batch(_batch()))
    state.epoch = 5
    if kind == "w_cos":
        with torch.no_grad():
            state.crit_state.lam.fill_(0.0123)
        state.crit_state.strikes = 2
    return trainer, state


def _tensors(trainer, state) -> dict:
    """Every tensor and number the state carries, by name."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}

    def opt(prefix, o, params):
        for i, p in enumerate(params):
            for k, v in o.state.get(p, {}).items():
                out[f"{prefix}/{i}/{k}"] = v
    opt("opt", state.opt, list(state.model.parameters()))
    crit = state.crit_state
    if hasattr(crit, "phi"):
        out.update({f"phi/{k}": v for k, v in crit.phi.state_dict().items()})
        opt("crit_opt", crit.opt, list(crit.phi.parameters()))
    if hasattr(crit, "phis"):
        out.update({f"phis/{k}": v for k, v in crit.phis.state_dict().items()})
    if hasattr(crit, "lam"):
        out["lam"], out["strikes"] = crit.lam, torch.tensor(crit.strikes)
    out["epoch"] = torch.tensor(state.epoch)
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_export_round_trips_every_state_bit_for_bit(kind, tmp_path):
    """port -> ``export_state`` -> ``load_state`` into a state drawn from
    another seed -> port: every tensor (weights, spectral vectors, Adam's
    step and moments, lam) and the strikes and epoch equal bit for bit,
    the second export equals the first, and one more train step from
    either state gives the same loss and weights. ~3 s each."""
    trainer, state = _stepped(kind, tmp_path)
    data = convert.export_state(trainer, state)
    other = trainer.init_state(torch.Generator().manual_seed(1))
    convert.load_state(trainer, other, data)
    want, got = _tensors(trainer, state), _tensors(trainer, other)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]), k
    again = convert.export_state(trainer, other)
    assert again.keys() == data.keys()
    for k in data:
        assert data[k].dtype == again[k].dtype and np.array_equal(data[k], again[k]), k
    gen = getattr(state.crit_state, "generator", None)
    if gen is not None:     # the criterion's draws from one stream on both
        other.crit_state.generator.set_state(gen.get_state())
    batch = _torch_batch(_batch(6))
    assert torch.equal(trainer._train_step(state, batch), trainer._train_step(other, batch))
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


def test_export_of_a_fresh_state_loads_as_a_fresh_optimizer(tmp_path):
    """A state before its first step exports Adam as zeros at count 0,
    which ``load_state`` reads as no Adam state at all: what a fresh
    optimizer holds, so a fit from it steps as from a fresh one. ~2 s."""
    trainer = tt.Trainer(_config("w_cos", tmp_path), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    data = convert.export_state(trainer, state)
    assert int(data["pcrnet_adam/count"]) == 0 and int(data["crit/adam/count"]) == 0
    assert not any(np.any(v) for k, v in data.items() if "/mu/" in k or "/nu/" in k)
    other = trainer.init_state(torch.Generator().manual_seed(1))
    trainer._train_step(other, _torch_batch(_batch()))
    convert.load_state(trainer, other, data)
    assert not other.opt.state and not other.crit_state.opt.state


def _frames(n=8, seed=3):
    z = np.random.default_rng(seed).normal(size=(n, 3, 2))
    return np.linalg.qr(z)[0].astype(np.float32)


@pytest.mark.parametrize("kind", ["w_cos", "max_ssw", "pseudo_w_cos"])
def test_exported_state_gives_the_jax_pose_and_value(kind, tmp_path):
    """The JAX package's state read from the export (``replay_fit.
    jax_state``): its PCRNet pose and test-mode criterion value on a numpy
    batch equal the port's within test_torch_init_states.py's tolerances
    (pose rtol 1e-5 / atol 1e-6, value rtol 1e-5); max-SSW gets one set of
    numpy frames on both sides. ~5 s each."""
    trainer, state = _stepped(kind, tmp_path)
    data = convert.export_state(trainer, state)
    jtr = jt.Trainer(config_from_dict(json.loads(trainer.cfg.to_json())))
    jstate = replay_fit.jax_state(jtr, data)
    target, source, _, _ = _batch(7)
    target -= target.mean(1, keepdims=True)
    source -= source.mean(1, keepdims=True)
    frames = _frames()
    crit = replay_fit.harness.criterion_object(trainer)
    if kind == "max_ssw":
        crit.draw = lambda minibatch: (torch.from_numpy(frames), None)
    with torch.no_grad():
        pose = state.model(torch.from_numpy(target), torch.from_numpy(source), 2)
        (value, _, _), _ = trainer.crit_apply(state.crit_state, torch.from_numpy(target),
                                              torch.from_numpy(source), False)
    jpose = jtr.model.apply(jstate.params, jnp.asarray(target), jnp.asarray(source), 2)
    with replay_fit.handed_frames([jnp.asarray(frames)] if kind == "max_ssw" else []):
        (jvalue, _, _), _ = jtr.crit_apply(jstate.crit_state, jnp.asarray(target),
                                           jnp.asarray(source), False)
    np.testing.assert_allclose(pose.est_R.numpy(), np.asarray(jpose.est_R), **POSE_TOL)
    np.testing.assert_allclose(pose.est_t.numpy(), np.asarray(jpose.est_t), **POSE_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), **VALUE_TOL)


def _adam(chain):
    (adam,) = [s for s in chain if isinstance(s, optax.ScaleByAdamState)]
    return adam


@pytest.mark.parametrize("kind", ["w_cos", "max_ssw"])
def test_exported_layout_is_the_jax_states_flatten(kind, tmp_path):
    """A JAX state one train step in (Adam moments non-zero), loaded into
    the port through the loaders, exports to exactly the keys, dtypes and
    bits that ``write_init_states.flatten`` gives for that JAX state: so
    one reader (``stored_tree``) serves the JAX package's files and the
    port's records. ~6 s each."""
    cfg = _config(kind, tmp_path)
    jtr = jt.Trainer(config_from_dict(json.loads(cfg.to_json())))
    jstate = jtr.init_state(jax.random.PRNGKey(3))
    target, source, rot, trans = _batch()
    jbatch = jd.RegistrationBatch(*(jnp.asarray(a) for a in (target, source, rot, trans)))
    jstate, _ = jtr._train_step(jstate, jbatch, train=True)
    jstate = jstate._replace(epoch=jnp.asarray(7, jnp.int32))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731

    trainer = tt.Trainer(cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    adam = _adam(jstate.opt_state)
    convert.load_pcrnet(state.model, np_tree(jstate.params))
    convert.load_pcrnet_adam_state(state.opt, state.model, np_tree(adam.mu),
                                   np_tree(adam.nu), adam.count)
    jc, crit = jstate.crit_state, state.crit_state
    cadam = _adam(jc.opt_state)
    if kind == "w_cos":
        convert.load_phi(crit.phi, np_tree(jc.phi_params), np_tree(jc.phi_state))
        convert.load_adam_state(crit.opt, crit.phi, np_tree(cadam.mu), np_tree(cadam.nu),
                                cadam.count)
        with torch.no_grad():
            crit.lam.copy_(torch.from_numpy(np.array(jc.lam)))
        crit.strikes = int(jc.strikes)
    else:
        convert.load_chart(crit.phi, np_tree(jc.phi_params), np_tree(jc.phi_state))
        convert.load_max_ssw_adam_state(crit.opt, crit.phi, np_tree(cadam.mu),
                                        np_tree(cadam.nu), cadam.count)
    state.epoch = int(jstate.epoch)

    want = {**writer.flatten(jstate.params, "pcrnet"),
            **writer.flatten(adam, "pcrnet_adam"),
            **writer.flatten(jc.phi_params, "crit/phi_params"),
            **writer.flatten(jc.phi_state, "crit/phi_state"),
            **writer.flatten(cadam, "crit/adam"), "epoch": np.asarray(jstate.epoch)}
    if kind == "w_cos":
        want["crit/lam"], want["crit/strikes"] = np.asarray(jc.lam), np.asarray(jc.strikes)
    got = convert.export_state(trainer, state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
