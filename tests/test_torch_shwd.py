"""Port parity: one SHWD criterion call (hybrid solver) vs shwd_tpu."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shwd_torch.flows import make_flow as t_make_flow
from shwd_torch.losses import shwd as ts
from shwd_torch.losses.transport import TransportConfig as TTransport
from shwd_torch.ops.sphere_sampling import sample_cube_surface
from shwd_torch.utils.convert import load_adam_state, load_phi, phi_tree
from shwd_tpu.flows import make_flow as j_make_flow
from shwd_tpu.losses import shwd as js
from shwd_tpu.losses.transport import TransportConfig as JTransport

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(max_iter=1, lam=0.1, phi_lr=1e-3, phi_weight_decay=0.1)
TP = dict(cost="lp", p=2.0, solver="hybrid", eps=1e-5, num_iters=40,
          num_scales=8)


def _clouds(n, seed=0):
    rng = np.random.default_rng(seed)
    x = sample_cube_surface(rng, n).numpy()[None]
    y = sample_cube_surface(rng, n, biased=True).numpy()[None]
    return x, y


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_pair(layers=2):
    """The JAX criterion and its initial state, shared by the tests (JAX
    state is immutable), with one jitted value-and-grad of ``apply`` per
    ``train`` flag, so each shape compiles once per session."""
    jcrit = js.SHWDLoss(j_make_flow("Residual", layers),
                        js.SHWDConfig(transport=JTransport(**TP), **KW))
    jstate = jcrit.init(jax.random.PRNGKey(0))

    def loss(xx, yy, st, train):
        (w, sx, sy), st = jcrit.apply(st, xx, yy, train)
        return w, (sx, sy, st)

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True), static_argnums=3)
    return jcrit, jstate, vg


@functools.lru_cache(maxsize=None)
def _skeleton(layers=2):
    return t_make_flow("Residual", layers)


def _port_phi(jstate, layers=2):
    return load_phi(copy.deepcopy(_skeleton(layers)), _np(jstate.phi_params),
                    _np(jstate.phi_state))


def _tcrit(layers=2, **extra):
    return ts.SHWDLoss(lambda g: t_make_flow("Residual", layers, generator=g),
                       ts.SHWDConfig(transport=TTransport(**TP), **KW, **extra))


def _pair(layers=2):
    jcrit, jstate, vg = _jax_pair(layers)
    tcrit = _tcrit(layers)
    tstate = tcrit.init(torch.Generator().manual_seed(0),
                        phi=_port_phi(jstate, layers))
    return vg, jstate, tcrit, tstate


def _jax_apply(vg, jstate, x, y, train=True):
    (w, (sx, sy, st)), gx = vg(jnp.asarray(x), jnp.asarray(y), jstate, train)
    return w, sx, sy, st, gx


def _torch_apply(tcrit, tstate, x, y, train=True):
    xt = torch.from_numpy(x).requires_grad_(True)
    (w, sx, sy), tstate = tcrit.apply(tstate, xt, torch.from_numpy(y), train)
    (gx,) = torch.autograd.grad(w, xt)
    return w, sx, sy, tstate, gx


def _compare(j, t):
    jw, jsx, jsy, jst, jgx = j
    tw, tsx, tsy, tst, tgx = t
    np.testing.assert_allclose(float(tw.detach()), float(jw), **TOL)
    np.testing.assert_allclose(tsx.detach().numpy(), np.asarray(jsx), **TOL)
    np.testing.assert_allclose(tsy.detach().numpy(), np.asarray(jsy), **TOL)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **TOL)
    tp, tsn = phi_tree(tst.phi)
    for a, b in zip(jax.tree_util.tree_leaves(_np((jst.phi_params, jst.phi_state))),
                    jax.tree_util.tree_leaves((tp, tsn))):
        np.testing.assert_allclose(b, a, **TOL)


def test_shwd_train_call_matches_jax():
    """B=1, N=64, 2 layers: w, phi(x), phi(y), the gradient wrt x and phi
    (params and u, v) after the inner Adam step + power iteration, all
    within rtol 1e-5 / atol 1e-5 (f32 in another op order; the exact
    permutations agree, so only rounding differs)."""
    x, y = _clouds(64)
    vg, jstate, tcrit, tstate = _pair()
    j = _jax_apply(vg, jstate, x, y)
    t = _torch_apply(tcrit, tstate, x, y)
    _compare(j, t)
    # phi did move in the inner step
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(_np(jstate.phi_params)),
        jax.tree_util.tree_leaves(phi_tree(t[3].phi)[0])))
    assert moved > 1e-4


def test_shwd_mid_run_call_with_converted_adam_state():
    """Run the JAX criterion two calls, convert phi and its Adam state
    (mu, nu, count), then compare the third call (same tolerances)."""
    x, y = _clouds(64, seed=1)
    vg, jstate, tcrit, _ = _pair()
    for _ in range(2):
        jstate = _jax_apply(vg, jstate, x, y)[3]
    adam = next(s for s in jstate.opt_state
                if isinstance(s, optax.ScaleByAdamState))
    phi = _port_phi(jstate)
    tstate = tcrit.init(torch.Generator().manual_seed(0), phi=phi)
    load_adam_state(tstate.opt, phi, _np(adam.mu), _np(adam.nu),
                    np.asarray(adam.count))
    _compare(_jax_apply(vg, jstate, x, y), _torch_apply(tcrit, tstate, x, y))


def test_shwd_eval_call_matches_jax():
    """train=False: no inner step, a cold final solve (same tolerances)."""
    x, y = _clouds(40, seed=2)
    vg, jstate, tcrit, tstate = _pair()
    _compare(_jax_apply(vg, jstate, x, y, False),
             _torch_apply(tcrit, tstate, x, y, False))


def test_lam_decay_and_early_stop():
    """lam decays per train call; past the strike limit phi stays put."""
    x, y = _clouds(32, seed=3)
    tcrit = _tcrit(lam_decay=0.5, early_stop_strikes=1)
    tstate = tcrit.init(torch.Generator().manual_seed(0),
                        phi=copy.deepcopy(_skeleton()))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tcrit.apply(tstate, xt, yt, True)
    assert tstate.lam == pytest.approx(0.05)
    tcrit.add_strike(tcrit.add_strike(tstate))
    before = [p.detach().clone() for p in tstate.phi.parameters()]
    tcrit.apply(tstate, xt, yt, True)
    assert all(torch.equal(a, b) for a, b in zip(before, tstate.phi.parameters()))


def test_unbatched_warm_path_drops_batch_dim():
    """Unbatched clouds give a 0-dim value even with reduce='none'."""
    x, y = _clouds(24, seed=4)
    crit = ts.SHWDLoss(lambda g: t_make_flow("Residual", 1, generator=g),
                       ts.SHWDConfig(transport=TTransport(**{**TP, "reduce": "none"}),
                                     **KW))
    state = crit.init(torch.Generator().manual_seed(0))
    (w, _, _), _ = crit.apply(state, torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    assert w.shape == ()


@pytest.mark.parametrize("solver", ["ssw", "exact"])
def test_ssw_and_exact_solvers_run_in_the_criterion(solver):
    """A train call on each solver moves phi and gives a finite value with
    a gradient to x; 'ssw' draws its frames from the state's generator,
    so two criteria from equal seeds agree."""
    x, y = _clouds(16, seed=6)
    vals = []
    for _ in range(2):
        crit = ts.SHWDLoss(lambda g: t_make_flow("Residual", 1, generator=g),
                           ts.SHWDConfig(transport=TTransport(solver=solver), **KW))
        state = crit.init(torch.Generator().manual_seed(0))
        before = [p.clone() for p in state.phi.parameters()]
        xt = torch.from_numpy(x).requires_grad_(True)
        (w, _, _), state = crit.apply(state, xt, torch.from_numpy(y), True)
        w.backward()
        assert bool(torch.isfinite(w)) and float(xt.grad.abs().max()) > 0
        assert not all(torch.equal(a, b) for a, b in zip(before, state.phi.parameters()))
        vals.append(float(w.detach()))
    assert vals[0] == vals[1]


@pytest.mark.parametrize("train", [True, False])
def test_batched_w1_cos_call_matches_jax(train):
    """The registration trainer's use: a (B, N, 3) batch on the sinkhorn
    solver with p=1 (w1_cos; the fused-kernel gate is closed, so both sides
    take cost_matrix + emd2_approx), train and eval. Value, phi(x) and the
    gradient wrt x within rtol 1e-3 / atol 1e-5 (60 Sinkhorn iterations)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 24, 3)).astype(np.float32) * 0.5
    y = x + 0.1 * rng.normal(size=(3, 24, 3)).astype(np.float32)
    tp = dict(cost="lp", p=1.0, solver="sinkhorn", eps=5e-3, num_iters=20,
              num_scales=3)
    kw = dict(max_iter=1, lam=1e-3, phi_lr=1e-3)
    jcrit = js.SHWDLoss(j_make_flow("Residual", 2),
                        js.SHWDConfig(transport=JTransport(**tp), **kw))
    jstate = jcrit.init(jax.random.PRNGKey(1))

    def loss(xx, yy, st):
        (w, sx, _), st = jcrit.apply(st, xx, yy, train)
        return w, (sx, st)

    (jw, (jsx, jst)), jgx = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x), jnp.asarray(y), jstate)
    tcrit = ts.SHWDLoss(lambda g: t_make_flow("Residual", 2, generator=g),
                        ts.SHWDConfig(transport=TTransport(**tp), **kw))
    tstate = tcrit.init(torch.Generator().manual_seed(0), phi=_port_phi(jstate))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tw, tsx, _), tstate = tcrit.apply(tstate, xt, torch.from_numpy(y), train)
    (tgx,) = torch.autograd.grad(tw, xt)
    tol = dict(rtol=1e-3, atol=1e-5)
    assert tw.shape == ()
    np.testing.assert_allclose(float(tw.detach()), float(jw), **tol)
    np.testing.assert_allclose(tsx.detach().numpy(), np.asarray(jsx), **tol)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **tol)
    moved = any(not np.allclose(a, b, atol=1e-6) for a, b in zip(
        jax.tree_util.tree_leaves(_np(jstate.phi_params)),
        jax.tree_util.tree_leaves(phi_tree(tstate.phi)[0])))
    assert moved == train
