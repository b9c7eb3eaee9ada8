"""The trainer's and the flow driver's fused execution on the CPU.

On the CPU the fused path runs the same step function on the same static
buffers as on the card, without capture (``utils.graphs.StepGraph``).
Held here: one fused epoch against the JAX package's ``fused_epoch=True``
trainer (its ``_epoch_scan`` and ``_eval_epoch_scan``) on the same inputs
and weights; fused against per-step bit for bit; which configurations
take which path; SHWD's lam as a 0-dim tensor against JAX; checkpoints
and converted JAX Adam states of capturable optimizers. Tiny sizes: B=4,
N=32, two pose iterations, one flow layer; PCRNet at its full widths.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import shwd_torch.data.dataset as td_dataset
from shwd_torch import data as td
from shwd_torch import train as tt
from shwd_torch.flows import make_flow as t_make_flow
from shwd_torch.losses import SHWDConfig as TSHWD
from shwd_torch.losses import TransportConfig as TTransport
from shwd_torch.losses import shwd as ts
from shwd_torch.train import flow_driver as tf
from shwd_torch.utils import load_checkpoint, save_checkpoint
from shwd_torch.utils.checkpoint import state_payload
from shwd_torch.utils.convert import (load_pcrnet, load_pcrnet_adam_state, load_phi,
                                      load_pseudo_phis, pcrnet_tree)
from shwd_torch.utils.graphs import StepGraph, preserved
from shwd_torch.utils.optim import init_adam_state, torch_adam
from shwd_tpu import data as jd
from shwd_tpu import train as jt
from shwd_tpu.flows import make_flow as j_make_flow
from shwd_tpu.losses import SHWDConfig as JSHWD
from shwd_tpu.losses import TransportConfig as JTransport
from shwd_tpu.losses import shwd as js

B, N = 4, 32
LR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(criterion, solver, tmp_path, **kw):
    tp = dict(cost="lp", p=2.0, solver=solver, eps=5e-3, num_iters=20, num_scales=3)
    sh = dict(max_iter=1, lam=1e-3, phi_lr=1e-3)
    ds = dict(source_point_num=N, target_point_num=N, num_synthetic=22, val_split=0.3,
              synthetic_kinds=("composite",), cache_dir=str(tmp_path / "mc"))
    common = dict(experiment="t", log_dir=str(tmp_path), criterion=criterion,
                  batch_size=B, pcr_iteration_num=2, phi_num_flow_layer=1, lr=LR,
                  pseudo_phi_num=2, **kw)
    jcfg = jt.TrainConfig(
        shwd=JSHWD(transport=JTransport(**tp), **sh),
        dataset=jd.DatasetConfig(transform=jd.TransformConfig(noise_sigma=0.01), **ds),
        **common)
    tcfg = tt.TrainConfig(
        shwd=TSHWD(transport=TTransport(**tp), **sh),
        dataset=td.DatasetConfig(transform=td.TransformConfig(noise_sigma=0.01), **ds),
        **common)
    return jcfg, tcfg


def _jax_draws(jds, indices, key, rng, tr, train):
    """The batches the JAX package's fused passes make inside their scans
    (``_train_one_epoch_fused``: shuffled rows, one split key per batch;
    ``eval_one_epoch``: full batches, then the tail with the last key),
    made here with the same keys, as numpy arrays."""
    idx = np.array(indices)
    make = jax.jit(jd.make_registration_batch, static_argnums=3)
    if train:
        rng.shuffle(idx)
        n = len(idx) // B
        keys = jax.random.split(key, n)
        rows = [idx[i * B:(i + 1) * B] for i in range(n)]
    else:
        n = len(idx) // B
        keys = jax.random.split(key, n + 1)
        rows = [idx[i * B:(i + 1) * B] for i in range(n)] + [idx[n * B:]]
    src, tgt = jnp.asarray(jds.sources), jnp.asarray(jds.targets)
    return [_np(make(k, tgt[r], src[r], tr)) for k, r in zip(keys, rows) if len(r)]


@pytest.mark.parametrize("criterion,solver", [
    ("w_cos", "sinkhorn"), ("w_cos", "hybrid"), ("cd", "sinkhorn"),
    ("pseudo_w_cos", "sinkhorn")])
def test_fused_epoch_matches_jax_fused_epoch(tmp_path, monkeypatch, criterion, solver):
    """One fused train epoch (4 steps at lr 1e-4) and the fused validation
    pass (a full batch and a tail of 2) of the port on the CPU against the
    JAX trainer with fused_epoch=True, from the JAX weights (converted) and
    on the JAX scans' own batches (handed to the port's batch draw). The
    epoch's mean train loss agrees to rtol 1e-4 and the validation loss,
    rotation and translation errors to rtol 1e-3 (f32 in another op order:
    four Adam steps move the weights whose gradient is rounding noise by
    +-lr with other signs). ~15-25 s each, most of it XLA compiling the
    two scans at PCRNet's full widths."""
    jcfg, tcfg = _configs(criterion, solver, tmp_path)
    jtr = jt.Trainer(jcfg)
    jstate = jtr.init_state(jax.random.PRNGKey(3))
    jds = jd.RegistrationDataset(jcfg.dataset, "train")
    tds = td.RegistrationDataset(tcfg.dataset, "train", device="cpu")
    assert np.array_equal(np.asarray(jds.sources), tds.sources.numpy())
    train_idx, val_idx = jds.train_val_indices(np.random.default_rng(0))
    assert len(train_idx) // B == 4 and len(val_idx) == B + 2

    ttr = tt.Trainer(tcfg, device="cpu")
    assert ttr.execution_path() == "fused"
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    load_pcrnet(tstate.model, _np(jstate.params))
    if criterion == "w_cos":
        load_phi(tstate.crit_state.phi, _np(jstate.crit_state.phi_params),
                 _np(jstate.crit_state.phi_state))
    elif criterion == "pseudo_w_cos":
        load_pseudo_phis(tstate.crit_state.phis, _np(jstate.crit_state.phi_params),
                         _np(jstate.crit_state.phi_state))
    before = jax.tree_util.tree_map(np.copy, pcrnet_tree(tstate.model))

    k_train, k_val = jax.random.split(jax.random.PRNGKey(11))
    tr = jcfg.dataset.transform
    feed = iter(_jax_draws(jds, train_idx, k_train, np.random.default_rng(5), tr, True)
                + _jax_draws(jds, val_idx, k_val, None, tr, False))

    def draw(generator, target, source, cfg):
        batch = next(feed)
        # the port gathered the same clouds: the shuffles agree
        assert np.array_equal(target.numpy(), batch.target)
        return td.RegistrationBatch(*(torch.from_numpy(np.array(a)) for a in batch))

    monkeypatch.setattr(td_dataset, "make_registration_batch", draw)
    jstate, jloss = jtr.train_one_epoch(jstate, jds, train_idx, k_train,
                                        np.random.default_rng(5))
    gen = torch.Generator().manual_seed(1)
    tstate, tloss = ttr.train_one_epoch(tstate, tds, train_idx, gen,
                                        np.random.default_rng(5))
    jval = jtr.eval_one_epoch(jstate, jds, val_idx, k_val)
    tval = ttr.eval_one_epoch(tstate, tds, val_idx, gen)
    assert next(feed, None) is None
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    np.testing.assert_allclose(tval, jval, rtol=1e-3)
    # the four Adam steps moved the model (each entry by up to lr a step)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(pcrnet_tree(tstate.model)),
        jax.tree_util.tree_leaves(before)))
    assert moved > 2 * LR


def _tiny(tmp_path, criterion, **kw):
    kw.setdefault("num_epochs", 2)
    return tt.TrainConfig(
        experiment="t", log_dir=str(tmp_path), criterion=criterion,
        dataset=td.DatasetConfig(source_point_num=24, target_point_num=24,
                                 num_synthetic=22, val_split=0.3,
                                 cache_dir=str(tmp_path / "mc"),
                                 transform=td.TransformConfig(noise_sigma=0.01)),
        batch_size=4, pcr_iteration_num=2,
        shwd=TSHWD(transport=TTransport(cost="lp", p=2.0, solver="sinkhorn",
                                        eps=0.05, num_iters=10, num_scales=2),
                   max_iter=1, lam=1e-4, phi_lr=1e-4, lam_decay=0.999),
        phi_num_flow_layer=1, **kw)


@pytest.mark.parametrize("criterion,solver", [
    ("w_cos", "sinkhorn"), ("w_cos", "hybrid"), ("w_cos", "ssw"), ("w1_cos", "sinkhorn"),
    ("cd", "sinkhorn"), ("sinkhorn", "sinkhorn"), ("pseudo_w_cos", "sinkhorn"),
    ("max_ssw", "sinkhorn")])
def test_fused_fit_equals_the_per_step_fit_bit_for_bit(tmp_path, criterion, solver):
    """Two epochs (4 train steps each, a full eval batch and a tail of 2)
    with fused_epoch True and False from the same seed: on the CPU the
    fused path calls the same step on static copies of the batch, so the
    histories and the final weights, phi and Adam state are equal bit for
    bit; the rows record the path."""
    base = _tiny(tmp_path, criterion)
    base = dataclasses.replace(base, shwd=dataclasses.replace(
        base.shwd, transport=dataclasses.replace(base.shwd.transport, solver=solver)))
    out = {}
    for fused in (True, False):
        cfg = dataclasses.replace(base, fused_epoch=fused, experiment=f"f{fused}")
        tr = tt.Trainer(cfg, device="cpu")
        out[fused] = tr.fit(td.RegistrationDataset(cfg.dataset, "train", device="cpu"),
                            verbose=False)
    fused, step = out[True], out[False]
    assert fused["path"] == "fused" and step["path"] == "per_step: fused_epoch=False"
    assert [r["path"] for r in fused["history"]] == ["fused", "fused"]
    keys = ("train_loss", "val_loss", "rot_error", "trans_error")
    assert [[r[k] for k in keys] for r in fused["history"]] == \
        [[r[k] for k in keys] for r in step["history"]]
    a, b = state_payload(fused["state"]), state_payload(step["state"])
    flat_a = jax.tree_util.tree_leaves(a, is_leaf=torch.is_tensor)
    flat_b = jax.tree_util.tree_leaves(b, is_leaf=torch.is_tensor)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
    graphs = {g["name"].split(" step")[0]: g["replays"] for g in fused["graphs"]}
    assert graphs == {"train": 8, "eval": 2}


def _rule(tmp_path, **kw):
    criterion = kw.pop("criterion", "w_cos")
    solver = kw.pop("solver", "sinkhorn")
    shwd = kw.pop("shwd", {})
    cfg = _tiny(tmp_path, criterion, **kw)
    cfg = dataclasses.replace(cfg, shwd=dataclasses.replace(
        cfg.shwd, transport=dataclasses.replace(cfg.shwd.transport, solver=solver),
        **shwd))
    return tt.Trainer(cfg, device="cpu")


@pytest.mark.parametrize("kw,path", [
    ({}, "fused"),
    ({"criterion": "cd"}, "fused"),
    ({"criterion": "pseudo_w_cos"}, "fused"),
    ({"criterion": "max_ssw"}, "fused"),
    ({"solver": "hybrid"}, "fused"),
    ({"solver": "ssw"}, "fused"),
    ({"shwd": {"early_stop_strikes": 2}}, "fused"),
    ({"fused_epoch": False}, "per_step: fused_epoch=False"),
    ({"nan_guard": True}, "per_step: nan_guard"),
    ({"solver": "exact"}, "per_step: the exact solver"),
    ({"criterion": "pseudo_w_cos", "solver": "exact"}, "per_step: the exact solver"),
    ({"shwd": {"refresh": True}}, "per_step: refresh"),
])
def test_path_rule(tmp_path, kw, path):
    """The JAX package's rule (fused_epoch and not nan_guard), less what a
    graph cannot hold: the host's exact solver and a new phi every call."""
    assert _rule(tmp_path, **kw).execution_path().startswith(path)


def test_path_rule_mesh(tmp_path):
    """A mesh takes the fused path: its collectives are captured with the
    step."""
    tr = _rule(tmp_path)
    tr.mesh = object()
    assert tr.execution_path() == "fused"


@pytest.mark.parametrize("method,fused", [
    ("SHWD", True), ("SWD", True), ("SSWD", True), ("CD", True), ("W2", True),
    ("GSWD_POLY", True), ("GSWD_CIRC", True), ("GSW_NN", True),
    ("MSWD", True), ("MGSWD_POLY", True), ("MGSWD_CIRC", True), ("ASWD", True),
    ("DSWD", True), ("MGSW_NN", True)])
def test_flow_path_rule(method, fused):
    """run_flow replays a captured step for every method (the inner
    ascents are functional Adams); only the host's exact solver and
    fused=False take the per-step loop."""
    path = tf.flow_path(tf.FlowConfig(method=method))
    assert (path == "fused") == fused
    assert tf.flow_path(tf.FlowConfig(shwd_solver="exact")).startswith("per_step")
    assert tf.flow_path(tf.FlowConfig(), fused=False) == "per_step: fused=False"


@pytest.mark.parametrize("method", ["SHWD", "SWD", "MSWD", "MGSWD_POLY", "MGSWD_CIRC",
                                    "ASWD", "DSWD", "MGSW_NN"])
def test_fused_flow_equals_the_per_step_flow_on_the_cpu(method):
    """run_flow's fused path on the CPU (the step called on the static path,
    the schedule stepped between calls) gives the per-step run's points and
    metric bit for bit, with a decaying learning rate; the adversarial
    methods run their inner ascents and carry their nets in place."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    rng = np.random.default_rng(0)
    src = sample_cube_surface(rng, 48).numpy()
    tgt = sample_cube_surface(rng, 48, biased=True).numpy()
    cfg = tf.FlowConfig(method=method, num_iterations=6, eval_interval=3, shwd_layers=1,
                        shwd_solver="hybrid", lr_decay_alpha=0.5, num_projections=16)
    fused = tf.run_flow(src, tgt, cfg, device="cpu")
    step = tf.run_flow(src, tgt, cfg, device="cpu", fused=False)
    assert fused.path == "fused" and fused.graph["replays"] == 6
    assert np.array_equal(fused.clouds, step.clouds)
    assert np.array_equal(fused.eval_values, step.eval_values)


def test_lam_is_a_device_tensor_decayed_in_place_like_jax():
    """SHWD with lam_decay=0.999 over 3 train calls (hybrid solver, B=1,
    N=48, 2 layers): lam stays the same 0-dim tensor, decayed in place, and
    equals the JAX state's f32 lam bit for bit after every call; the
    values agree to rtol 1e-5."""
    from shwd_torch.ops.sphere_sampling import sample_cube_surface
    tp = dict(cost="lp", p=2.0, solver="hybrid", eps=1e-5, num_iters=40, num_scales=8)
    kw = dict(max_iter=1, lam=0.1, phi_lr=1e-3, phi_weight_decay=0.1, lam_decay=0.999)
    jcrit = js.SHWDLoss(j_make_flow("Residual", 2),
                        js.SHWDConfig(transport=JTransport(**tp), **kw))
    jstate = jcrit.init(jax.random.PRNGKey(0))
    apply = jax.jit(lambda st, x, y: jcrit.apply(st, x, y, True))
    tcrit = ts.SHWDLoss(lambda g: t_make_flow("Residual", 2, generator=g),
                        ts.SHWDConfig(transport=TTransport(**tp), **kw))
    phi = load_phi(t_make_flow("Residual", 2), _np(jstate.phi_params),
                   _np(jstate.phi_state))
    tstate = tcrit.init(torch.Generator().manual_seed(0), phi=phi)
    lam = tstate.lam
    assert lam.shape == () and lam.dtype == torch.float32
    rng = np.random.default_rng(0)
    x = sample_cube_surface(rng, 48).numpy()[None]
    y = sample_cube_surface(rng, 48, biased=True).numpy()[None]
    for _ in range(3):
        (jw, _, _), jstate = apply(jstate, jnp.asarray(x), jnp.asarray(y))
        (tw, _, _), tstate = tcrit.apply(tstate, torch.from_numpy(x), torch.from_numpy(y))
        assert tstate.lam is lam
        assert float(lam) == float(jstate.lam)
        np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5)
    assert float(lam) == float(np.float32(0.1) * np.float32(0.999) * np.float32(0.999)
                               * np.float32(0.999))


def _capturable_state(tmp_path, gen_seed=0):
    cfg = _tiny(tmp_path, "w_cos")
    tr = tt.Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(gen_seed))
    # the card's optimizers: capturable, the step count on the parameters'
    # device (PyTorch refuses to step one on the CPU, so none steps here)
    state.opt = torch_adam(state.model.parameters(), cfg.lr, cfg.weight_decay,
                           capturable=True)
    phi = state.crit_state.phi
    state.crit_state.opt = torch_adam(phi.parameters(), 1e-4, 0.0, capturable=True)
    for opt in (state.opt, state.crit_state.opt):
        init_adam_state(opt)
    return tr, state


def test_checkpoint_round_trip_of_a_capturable_state(tmp_path):
    """A capturable state (Adam step counts on the parameters' device, a
    0-dim lam) saved and loaded into a fresh one: every tensor equal, the
    step counts float32 on the parameters' device, lam written into the
    fresh state's own tensor; a file with a float lam (written before lam
    was a tensor) loads into it too; a snapshot does not alias the live
    lam."""
    tr, state = _capturable_state(tmp_path)
    with torch.no_grad():
        for opt in (state.opt, state.crit_state.opt):
            for i, st in enumerate(opt.state.values()):
                st["step"].fill_(3 + i)
                st["exp_avg"].normal_()
                st["exp_avg_sq"].uniform_()
        state.crit_state.lam.fill_(0.25)
    snap = state_payload(state)
    state.crit_state.lam.mul_(0.5)
    assert float(snap["crit"]["lam"]) == 0.25
    save_checkpoint(tmp_path / "ck", snap, 7)
    _, fresh = _capturable_state(tmp_path, gen_seed=9)
    lam = fresh.crit_state.lam
    _, epoch = load_checkpoint(tmp_path / "ck", fresh)
    assert epoch == 7 and fresh.crit_state.lam is lam and float(lam) == 0.25
    for opt_a, opt_b in ((state.opt, fresh.opt), (state.crit_state.opt, fresh.crit_state.opt)):
        for p_a, p_b in zip(opt_a.param_groups[0]["params"], opt_b.param_groups[0]["params"]):
            a, b = opt_a.state[p_a], opt_b.state[p_b]
            assert b["step"].dtype == torch.float32 and b["step"].device == p_b.device
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a[k], b[k]), k
    old = torch.load(str(tmp_path / "ck.pt"), weights_only=True)
    old["crit"]["lam"] = 0.125
    torch.save(old, str(tmp_path / "old.pt"))
    (tmp_path / "old.json").write_text('{"epoch": 7}')
    load_checkpoint(tmp_path / "old", fresh)
    assert fresh.crit_state.lam is lam and float(lam) == 0.125


def test_converted_jax_adam_state_loads_into_a_capturable_optimizer(tmp_path):
    """optax's Adam state after a JAX train step, converted with
    ``load_pcrnet_adam_state`` into a capturable optimizer: the count is a
    float32 tensor on the parameters' device, the moments equal the JAX
    ones."""
    jcfg, _ = _configs("cd", "sinkhorn", tmp_path)
    jtr = jt.Trainer(jcfg)
    jstate = jtr.init_state(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    batch = jd.RegistrationBatch(
        jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32),
        jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32),
        jnp.eye(3, dtype=jnp.float32)[None].repeat(B, 0), jnp.zeros((B, 3), jnp.float32))
    jstate, _ = jtr._train_step(jstate, batch, train=True)
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    _, state = _capturable_state(tmp_path)
    load_pcrnet(state.model, _np(jstate.params))
    load_pcrnet_adam_state(state.opt, state.model, _np(adam.mu), _np(adam.nu),
                           np.asarray(adam.count))
    layers = list(state.model.feature_model.layers) + list(state.model.head)
    mu = list(adam.mu["feature"]) + list(adam.mu["head"])
    for layer, m in zip(layers, mu):
        st = state.opt.state[layer.w]
        assert st["step"].dtype == torch.float32 and st["step"].device == layer.w.device
        assert float(st["step"]) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(m["w"]))
    assert pcrnet_tree(state.model)["head"][0]["w"].shape == np.asarray(
        jstate.params["head"][0]["w"]).shape


def test_step_graph_on_the_cpu_calls_the_step_on_its_static_inputs():
    """On the CPU a StepGraph copies its arguments into its static buffers
    and calls the step; ``preserved`` puts a state's tensors, optimizer
    state and generator back after a warm-up step."""
    seen = []
    graph = StepGraph("t", lambda a: seen.append(a.clone()) or a * 2,
                      [torch.zeros(3)], device="cpu")
    out = graph(torch.arange(3.0))
    assert torch.equal(out, torch.tensor([0.0, 2.0, 4.0])) and graph.replays == 1
    assert graph.stats()["captured"] is False
    lin = torch.nn.Linear(3, 2)
    opt = init_adam_state(torch_adam(lin.parameters(), 0.1))
    gen = torch.Generator().manual_seed(0)
    before = [t.clone() for t in lin.parameters()]
    draw = torch.rand(2, generator=torch.Generator().manual_seed(0))
    with preserved({"lin": lin, "opt": opt, "gen": gen}):
        lin(torch.rand(4, 3, generator=gen)).sum().backward()
        opt.step()
    assert all(torch.equal(a, b) for a, b in zip(before, lin.parameters()))
    assert all(float(s["step"]) == 0 for s in opt.state.values())
    assert torch.equal(torch.rand(2, generator=gen), draw)
