"""Port parity: the Residual flow phi on weights converted from shwd_tpu."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.flows import make_flow as t_make_flow
from shwd_torch.utils.convert import load_phi, phi_tree
from shwd_tpu.flows import make_flow as j_make_flow


def _jax_phi(layers=2, seed=0, scale_last=True):
    """A JAX phi with numpy leaves. ``scale_last`` undoes the /1000 init of
    each block's last layer so the nonlinear part is not negligible."""
    flow = j_make_flow("Residual", layers)
    params, state = flow.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    if scale_last:
        params = tuple(block[:-1] + ({**block[-1], "w": block[-1]["w"] * 1000},)
                       for block in params)
    return flow, params, state


@pytest.fixture(scope="module")
def jax_phi():
    return _jax_phi()


@pytest.fixture(scope="module")
def skeleton():
    return t_make_flow("Residual", 2)


@pytest.fixture
def pair(jax_phi, skeleton):
    """(JAX flow, params, state, the port's flow loaded from them)."""
    jflow, params, state = jax_phi
    return jflow, params, state, load_phi(copy.deepcopy(skeleton),
                                          params, state)


def test_convert_round_trip(pair):
    _, params, state, tflow = pair
    p2, s2 = phi_tree(tflow)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((p2, s2))):
        np.testing.assert_array_equal(a, b)


def test_forward_matches_jax(pair):
    """phi(x) on converted weights, f32: atol 1e-6."""
    jflow, params, state, tflow = pair
    x = np.random.default_rng(0).normal(size=(2, 30, 3)).astype(np.float32)
    want = np.asarray(jflow(params, state, jnp.asarray(x)))
    got = tflow(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_parameter_gradients_match_jax(pair):
    """Gradient of a scalar loss wrt every parameter (w, b, beta of every
    layer): atol 1e-5 / rtol 1e-5 (f32 backward in another op order)."""
    jflow, params, state, tflow = pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 40, 3)).astype(np.float32)
    t = rng.normal(size=(1, 40, 3)).astype(np.float32)

    def jloss(p):
        return jnp.sum((jflow(p, state, jnp.asarray(x)) - t) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.asarray, params))
    loss = torch.sum((tflow(torch.from_numpy(x)) - torch.from_numpy(t)) ** 2)
    loss.backward()
    layers = [layer for block in tflow.flows for layer in block.net.layers]
    jflat = [layer for block in jgrads for layer in block]
    assert len(layers) == len(jflat) == 2 * 7
    for layer, jg in zip(layers, jflat):
        for name in ("w", "b", "beta"):
            np.testing.assert_allclose(getattr(layer, name).grad.numpy(),
                                       np.asarray(jg[name]),
                                       atol=1e-5, rtol=1e-5)


def test_power_iteration_matches_jax(pair):
    """One power-iteration update of every (u, v) in place: atol 1e-6."""
    jflow, params, state, tflow = pair
    params = tuple(tuple({**p, "w": p["w"] + 0.05} for p in block)
                   for block in params)     # move w so u, v must change
    load_phi(tflow, params, state)
    want = jax.jit(jflow.update_state, static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), 1)
    tflow.update_state(1)
    _, got = phi_tree(tflow)
    moved = 0.0
    for a, b, s0 in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(state)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0)
        moved = max(moved, float(np.abs(b - s0).max()))
    assert moved > 1e-4


def test_inverse_round_trip_and_matches_jax(pair):
    """inverse(phi(x)) == x (atol 1e-5, the fixed point's tolerance), and
    equals the JAX inverse (atol 1e-5)."""
    jflow, params, state, tflow = pair
    x = np.random.default_rng(2).normal(size=(25, 3)).astype(np.float32)
    y = tflow(torch.from_numpy(x)).detach()
    back = tflow.inverse(y).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5, rtol=0)
    jback = np.asarray(jflow.inverse(params, state, jnp.asarray(y.numpy())))
    np.testing.assert_allclose(back, jback, atol=1e-5, rtol=0)


def test_fresh_init_is_a_contraction_near_identity():
    """The port's own init: beta 0.5, u, v converged to the top singular
    pair, last weight ~zero, so phi starts as the identity plus the last
    layers' biases (a constant shift)."""
    g = torch.Generator().manual_seed(0)
    flow = t_make_flow("Residual", 3, generator=g)
    for block in flow.flows:
        for layer in block.net.layers:
            assert float(layer.beta.detach()) == 0.5
            sigma = torch.linalg.matrix_norm(layer.w.detach(), ord=2)
            est = layer.u @ (layer.w.detach() @ layer.v)
            np.testing.assert_allclose(float(est), float(sigma), rtol=1e-3)
    x = torch.randn(10, 3, generator=g)
    shift = (flow(x) - x).detach()
    assert float(torch.abs(shift - shift[0]).max()) < 1e-2


def test_make_flow_builds_planar_chains_and_rejects_unknown_names():
    g = torch.Generator().manual_seed(0)
    flow = t_make_flow("Planar", 4, generator=g)
    assert len(flow.flows) == 4
    x = torch.randn(5, 3, generator=g)
    y, ld = flow.forward_logdet(x, logdet=True)
    assert y.shape == (5, 3) and ld.shape == (5,) and bool(torch.isfinite(ld).all())
    with pytest.raises(ValueError, match="not valid"):
        t_make_flow("Glow", 2)


def _logdet_pair(layers=2):
    """A chain of Residual blocks with LipschitzMLP([3, 8, 3], 0.9) and no
    zero init, as ``tests/test_flows.py``'s log-det case: (JAX chain,
    params, state, the port's chain loaded from them)."""
    from shwd_torch.flows.base import FlowChain as TChain
    from shwd_torch.flows.lipschitz import LipschitzMLP as TMLP
    from shwd_torch.flows.residual import ResidualFlow as TRes
    from shwd_tpu.flows.base import FlowChain as JChain
    from shwd_tpu.flows.lipschitz import LipschitzMLP as JMLP
    from shwd_tpu.flows.residual import ResidualFlow as JRes
    jflow = JChain([JRes(JMLP([3, 8, 3], 0.9, init_zeros=False)) for _ in range(layers)])
    params, state = jax.tree_util.tree_map(np.asarray, jflow.init(jax.random.PRNGKey(0)))
    tflow = TChain([TRes(TMLP([3, 8, 3], 0.9, init_zeros=False)) for _ in range(layers)])
    return jflow, params, state, load_phi(tflow, params, state)


def test_residual_logdet_matches_jax_and_bruteforce():
    """FlowChain.forward_logdet(logdet=True) on a 2-block Residual chain:
    the per-point log|det| against the JAX package's (d JVPs + slogdet)
    and against torch.func.jacfwd of the whole map, atol 1e-4
    (tests/test_flows.py's tolerance); the mapped points equal the plain
    forward's."""
    jflow, params, state, tflow = _logdet_pair()
    x = np.random.default_rng(3).normal(size=(2, 9, 3)).astype(np.float32)
    _, want = jflow.apply(params, state, jnp.asarray(x), logdet=True)
    xt = torch.from_numpy(x)
    y, got = tflow.forward_logdet(xt, logdet=True)
    assert got.shape == (2, 9)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    jac = torch.func.vmap(torch.func.jacfwd(lambda p: tflow(p[None])[0]))(xt.reshape(-1, 3))
    brute = torch.linalg.slogdet(jac)[1].reshape(2, 9)
    np.testing.assert_allclose(got.detach().numpy(), brute.detach().numpy(), atol=1e-4)
    np.testing.assert_array_equal(y.detach().numpy(), tflow(xt).detach().numpy())
    assert float(got.detach().abs().max()) > 0.05


def test_residual_logdet_is_differentiable():
    """The log-det's gradient wrt the points and a layer's weight, against
    the JAX package's on the same weights (rtol 1e-4)."""
    jflow, params, state, tflow = _logdet_pair()
    x = np.random.default_rng(4).normal(size=(12, 3)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jflow.apply(p, state, xx, logdet=True)[1])

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tflow.forward_logdet(xt, logdet=True)[1].sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-6)
    w0 = tflow.flows[0].net.layers[0].w.grad.numpy()
    np.testing.assert_allclose(w0, np.asarray(gp[0][0]["w"]), rtol=1e-4, atol=1e-6)
