"""Port parity: the pseudo-max SHWD criterion (an ensemble of frozen random
flows) vs shwd_tpu.losses.pseudo, with the flows converted from the JAX
init.

B=2 clouds of N=16 points, phi_num=3 Residual flows of 2 layers whose last
layers are scaled out of their near-zero init, so the flows' values are
well apart. Value, the returned sphere clouds and the gradient wrt x and y
for every combine rule, on the 'sinkhorn' (the CPU path of both packages:
cost matrix and eps-scaled Sinkhorn with a batch-global eps0) and 'hybrid'
solvers; rtol 1e-5, except 5e-3 for the sinkhorn gradients (dual
differences of 1e-5 become 2e-3 in the plan at eps 5e-3).
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.flows import make_flow as t_make_flow
from shwd_torch.losses import pseudo as tp
from shwd_torch.losses.transport import TransportConfig as TTransport
from shwd_torch.utils.convert import load_pseudo_phis
from shwd_tpu.flows import make_flow as j_make_flow
from shwd_tpu.losses import pseudo as jp
from shwd_tpu.losses.transport import TransportConfig as JTransport

PHI_NUM, LAYERS = 3, 2
TP = dict(cost="lp", p=2.0, eps=5e-3, num_iters=20, num_scales=3)


def _clouds(seed=0):
    rng = np.random.default_rng(seed)
    x = (0.6 * rng.normal(size=(2, 16, 3))).astype(np.float32)
    y = (x + 0.2 * rng.normal(size=(2, 16, 3))).astype(np.float32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_side(solver, combine):
    crit = jp.PseudoSHWDLoss(j_make_flow("Residual", LAYERS), jp.PseudoSHWDConfig(
        transport=JTransport(solver=solver, **TP), phi_num=PHI_NUM, combine=combine))
    state = crit.init(jax.random.PRNGKey(2))
    # scale each block's last layer out of its /1000 init
    params = tuple(blk[:-1] + ({**blk[-1], "w": blk[-1]["w"] * 1000},)
                   for blk in state.phi_params)
    state = state._replace(phi_params=params)

    def f(x, y):
        (v, sx, sy), _ = crit.apply(state, x, y, True)
        return v, (sx, sy)

    x, y = _clouds()
    (v, (sx, sy)), (gx, gy) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jnp.asarray(y))
    np_tree = jax.tree_util.tree_map(np.asarray, (state.phi_params, state.phi_state))
    return np_tree, [np.asarray(a) for a in (v, sx, sy, gx, gy)]


def _port(solver, combine, tree):
    crit = tp.PseudoSHWDLoss(lambda g: t_make_flow("Residual", LAYERS, generator=g),
                             tp.PseudoSHWDConfig(transport=TTransport(solver=solver, **TP),
                                                 phi_num=PHI_NUM, combine=combine))
    state = crit.init(torch.Generator().manual_seed(0))
    load_pseudo_phis(state.phis, *tree)
    return crit, state


@pytest.mark.parametrize("combine", ["max", "mean", "softmax"])
@pytest.mark.parametrize("solver", ["sinkhorn", "hybrid"])
def test_pseudo_matches_jax(solver, combine):
    tree, (jv, jsx, jsy, jgx, jgy) = _jax_side(solver, combine)
    crit, state = _port(solver, combine, tree)
    x, y = _clouds()
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    (v, sx, sy), _ = crit.apply(state, tx, ty, True)
    v.backward()
    grad_tol = dict(rtol=5e-3, atol=5e-5) if solver == "sinkhorn" else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(sx.detach().numpy(), jsx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sy.detach().numpy(), jsy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, **grad_tol)
    np.testing.assert_allclose(ty.grad.numpy(), jgy, **grad_tol)


def test_pseudo_max_returns_the_argmax_flow_and_freezes_the_flows():
    """Under 'max' the sphere clouds are those of the flow with the largest
    value (picked on the device), the flows get no gradient, and a call
    changes no flow."""
    tree, _ = _jax_side("hybrid", "max")
    crit, state = _port("hybrid", "max", tree)
    x, y = (torch.from_numpy(a) for a in _clouds())
    before = [p.clone() for p in state.phis.parameters()]
    (v, sx, sy), _ = crit.apply(state, x.requires_grad_(True), y, True)
    with torch.no_grad():
        vals = torch.stack([crit.transport(phi(x), phi(y)) for phi in state.phis])
    k = int(torch.argmax(vals))
    assert float(v.detach()) == pytest.approx(float(vals.max()), rel=1e-6)
    np.testing.assert_allclose(sx.detach().numpy(),
                               state.phis[k](x).detach().numpy(), rtol=1e-6, atol=1e-7)
    assert all(not p.requires_grad for p in state.phis.parameters())
    assert all(torch.equal(a, b) for a, b in zip(before, state.phis.parameters()))


def test_pseudo_rejects_an_unknown_combine():
    with pytest.raises(ValueError, match="combine"):
        tp.PseudoSHWDLoss(lambda g: t_make_flow("Residual", 1, generator=g),
                          tp.PseudoSHWDConfig(combine="median"))
