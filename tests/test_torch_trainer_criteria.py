"""Port parity: one registration train step of ``pseudo_w_cos``,
``max_ssw`` and ``w_cos`` on the ``ssw`` solver vs
``shwd_tpu.train.Trainer._step``, under ``test_torch_trainer``'s rules
(B=4 clouds of 32 points, full-width PCRNet; the model's loss, gradients
and stepped parameters by ``_compare_model``; the criterion's state after
the step leaf by leaf).

Both sides get the same batch and the JAX init, converted. The frames
that the JAX criterion draws from its key are recomputed from the key
splits and handed to the port.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)
from torch_cpu import tmp_path  # noqa: F401  (removed once its test passes)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch import data as td
from shwd_torch import train as tt
from shwd_torch.flows import EncoderFlowChart, SphereChartMLP, make_flow
from shwd_torch.utils.convert import (load_chart, load_pcrnet, load_phi,
                                      load_pseudo_phis, phi_tree)
from shwd_tpu import data as jd
from shwd_tpu import train as jt
from shwd_tpu.ops.spherical import stiefel_frames as j_frames
from test_torch_trainer import _batch, _compare_model, _configs, _np


def _ssw_frames(key, max_iter, num_projections):
    """The frames of one SHWD or max-SSW train call: inner step i draws
    from split(key, max_iter + 1)[i] (max-SSW: its first half), the final
    solve from split(keys[-1])[0]."""
    keys = jax.random.split(key, max_iter + 1)
    return keys, np.asarray(j_frames(jax.random.split(keys[-1])[0], num_projections, 3))


def _one_step(criterion, solver, tmp_path, prepare):
    """(jax loss, grads, state after), (port state after, loss); ``prepare
    (crit, tstate, jstate)`` loads the JAX criterion state into the port's
    and installs the frames."""
    jcfg, tcfg = _configs(criterion, solver, tmp_path)
    arrays = _batch()
    jtr = jt.Trainer(jcfg)
    jstate = jtr.init_state(jax.random.PRNGKey(3))
    jbatch = jd.RegistrationBatch(*(jnp.asarray(a) for a in arrays))

    def loss_fn(params, crit_state):
        source, target, _ = jt.trainer._mean_subtract(jbatch)
        out = jtr.model.apply(params, target, source, jcfg.pcr_iteration_num)
        (loss, _, _), _ = jtr.crit_apply(crit_state, target, out.transformed_source, True)
        return loss

    jgrads = jax.jit(jax.grad(loss_fn))(jstate.params, jstate.crit_state)
    jnew, jloss = jtr._train_step(jstate, jbatch, train=True)

    ttr = tt.Trainer(tcfg, device="cpu")
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    load_pcrnet(tstate.model, _np(jstate.params))
    prepare(ttr.crit_apply.__self__, tstate, jstate)
    tloss = ttr._train_step(tstate, td.RegistrationBatch(*(torch.from_numpy(a)
                                                           for a in arrays)))
    return (jloss, jgrads, jnew), (tstate, tloss), jcfg


def _close_trees(port_leaves, jax_leaves, **tol):
    port_leaves, jax_leaves = list(port_leaves), list(jax_leaves)
    assert len(port_leaves) == len(jax_leaves)
    for a, b in zip(port_leaves, jax_leaves):
        np.testing.assert_allclose(a, b, **tol)


def test_pseudo_w_cos_train_step_matches_jax(tmp_path):
    """``pseudo_w_cos`` on the CPU path of the ``sinkhorn`` solver (cost
    matrix and eps-scaled Sinkhorn on both sides): loss and gradients at
    rtol 1e-3 (as the ``w_cos`` step); the frozen flows do not move."""
    def prepare(crit, tstate, jstate):
        load_pseudo_phis(tstate.crit_state.phis, _np(jstate.crit_state.phi_params),
                         _np(jstate.crit_state.phi_state))

    jside, tside, _ = _one_step("pseudo_w_cos", "sinkhorn", tmp_path, prepare)
    _compare_model(jside, tside, rtol=1e-3)
    (_, _, jnew), (tstate, _) = jside, tside
    # the flows after the step: the JAX ones, which are those before it
    want = [make_flow("Residual", 2) for _ in range(2)]
    load_pseudo_phis(want, _np(jnew.crit_state.phi_params), _np(jnew.crit_state.phi_state))
    for a, b in zip(tstate.crit_state.phis, want):
        _close_trees([t.numpy() for t in a.state_dict().values()],
                     [t.numpy() for t in b.state_dict().values()], rtol=0, atol=0)


def test_w_cos_ssw_train_step_matches_jax(tmp_path):
    """``w_cos`` with ``solver="ssw"``: the inner step and the final solve
    get the JAX criterion's frames. Loss and gradients at rtol 1e-3, phi
    after its inner step at rtol 1e-4 / atol 2e-5 (``_compare_step``)."""
    def prepare(crit, tstate, jstate):
        load_phi(tstate.crit_state.phi, _np(jstate.crit_state.phi_params),
                 _np(jstate.crit_state.phi_state))
        keys, final = _ssw_frames(jstate.crit_state.key, 1, 100)
        frames = iter([np.asarray(j_frames(keys[0], 100, 3)), final])
        inner = crit.transport

        def transport(sx, sy, *_, **__):
            return inner(sx, sy, frames=torch.tensor(next(frames)))
        crit.transport = transport

    jside, tside, _ = _one_step("w_cos", "ssw", tmp_path, prepare)
    _compare_model(jside, tside, rtol=1e-3)
    (_, _, jnew), (tstate, _) = jside, tside
    tp, ts = phi_tree(tstate.crit_state.phi)
    _close_trees(jax.tree_util.tree_leaves(tp),
                 jax.tree_util.tree_leaves(_np(jnew.crit_state.phi_params)),
                 rtol=1e-4, atol=2e-5)
    _close_trees(jax.tree_util.tree_leaves(ts),
                 jax.tree_util.tree_leaves(_np(jnew.crit_state.phi_state)), atol=5e-4)


def test_max_ssw_train_step_matches_jax(tmp_path):
    """``max_ssw`` with the mlp chart (``TrainConfig``'s knobs: 100
    projections, one inner step, lr 9.2e-5, p = 2): frames injected through
    the loss's ``draw`` hook. Loss and gradients at rtol 1e-3; the chart
    after its ascent step at rtol 1e-4 / atol 2e-5, its Adam moments too."""
    def prepare(crit, tstate, jstate):
        load_chart(tstate.crit_state.phi, _np(jstate.crit_state.phi_params),
                   _np(jstate.crit_state.phi_state))
        keys, final = _ssw_frames(jstate.crit_state.key, 1, 100)
        k_frames, _ = jax.random.split(keys[0])
        frames = iter([np.asarray(j_frames(k_frames, 100, 3)), final])
        crit.draw = lambda mb: (torch.tensor(next(frames)), None)

    jside, tside, jcfg = _one_step("max_ssw", "sinkhorn", tmp_path, prepare)
    _compare_model(jside, tside, rtol=1e-3)
    (_, _, jnew), (tstate, _) = jside, tside
    chart = tstate.crit_state.phi
    assert isinstance(chart, SphereChartMLP) and jcfg.max_ssw_chart == "mlp"
    want = load_chart(SphereChartMLP(), _np(jnew.crit_state.phi_params), ())
    _close_trees([p.detach().numpy() for p in chart.parameters()],
                 [p.detach().numpy() for p in want.parameters()], rtol=1e-4, atol=2e-5)
    adam = _np(jnew.crit_state.opt_state[0])
    mu = load_chart(SphereChartMLP(), adam.mu, ())
    opt = tstate.crit_state.opt
    _close_trees([opt.state[p]["exp_avg"].numpy() for p in chart.parameters()],
                 [p.detach().numpy() for p in mu.parameters()], rtol=1e-3, atol=1e-9)
    assert all(float(opt.state[p]["step"]) == float(adam.count) for p in chart.parameters())


@pytest.mark.parametrize("chart", ["mlp", "encoder_flow"])
def test_max_ssw_chart_option_builds_its_chart(tmp_path, chart):
    cfg = tt.TrainConfig(log_dir=str(tmp_path), criterion="max_ssw", max_ssw_chart=chart)
    tr = tt.Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    cls = EncoderFlowChart if chart == "encoder_flow" else SphereChartMLP
    assert type(state.crit_state.phi) is cls
