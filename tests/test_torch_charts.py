"""Port parity: the Planar and ActNorm flows and the two sphere charts
(SphereChartMLP, EncoderFlowChart) on weights converted from shwd_tpu,
at rtol 1e-5."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.flows import ActNorm as TActNorm
from shwd_torch.flows import EncoderFlowChart as TEncoder
from shwd_torch.flows import FlowChain, PlanarFlow
from shwd_torch.flows import SphereChartMLP as TChart
from shwd_torch.flows import make_flow as t_make_flow
from shwd_torch.utils.convert import load_actnorm, load_chart, load_planar
from shwd_tpu.flows import ActNorm as JActNorm
from shwd_tpu.flows import EncoderFlowChart as JEncoder
from shwd_tpu.flows import SphereChartMLP as JChart
from shwd_tpu.flows import make_flow as j_make_flow

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _points(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def test_planar_chain_matches_jax():
    """Output, log-det and the gradient wrt the points of a 3-layer planar
    chain (make_flow("Planar")), b moved off zero."""
    jflow = j_make_flow("Planar", 3)
    params, state = jflow.init(jax.random.PRNGKey(0))
    params = tuple({**p, "b": jnp.asarray(0.3 * (i + 1))} for i, p in enumerate(params))
    x = _points((2, 20, 3), 1)
    jy, jld = jflow.apply(params, state, jnp.asarray(x), logdet=True)
    jg = jax.grad(lambda a: jnp.sum(jflow.apply(params, state, a)[0] ** 2))(jnp.asarray(x))
    tflow = t_make_flow("Planar", 3)
    assert isinstance(tflow, FlowChain) and all(isinstance(f, PlanarFlow) for f in tflow.flows)
    for block, p in zip(tflow.flows, _np(params)):
        load_planar(block, p)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, tld = tflow.forward_logdet(tx, logdet=True)
    (ty ** 2).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tld.detach().numpy(), np.asarray(jld), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_planar_keeps_w_dot_u_above_minus_one():
    g = torch.Generator().manual_seed(3)
    for _ in range(20):
        f = PlanarFlow(3, generator=g)
        with torch.no_grad():
            f.u.copy_(-5 * f.w)          # w.u far below -1 before the constraint
        assert float(torch.dot(f.w, f.constrained_u()).detach()) > -1.0


def test_actnorm_matches_jax():
    """Data init, output, log-det and inverse."""
    x = _points((3, 50, 3), 2, scale=2.5) + np.float32([1.0, -2.0, 0.5])
    jf = JActNorm(3)
    jp = jf.init_from_data(jf.init(jax.random.PRNGKey(0))[0], jnp.asarray(x))
    jy, jld = jf.apply(jp, {}, jnp.asarray(x), logdet=True)
    tf = TActNorm(3)
    tf.init_from_data(torch.from_numpy(x))
    np.testing.assert_allclose(tf.s.detach().numpy(), np.asarray(jp["s"]), **TOL)
    np.testing.assert_allclose(tf.t.detach().numpy(), np.asarray(jp["t"]), **TOL)
    ty, tld = tf.forward_logdet(torch.from_numpy(x), logdet=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tld.detach().numpy(), np.asarray(jld), **TOL)
    flat = ty.detach().reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), 0, atol=1e-5)
    np.testing.assert_allclose(flat.std(0), 1, atol=1e-5)
    np.testing.assert_allclose(tf.inverse(ty).detach().numpy(), x, rtol=1e-5, atol=1e-5)
    # converted parameters give the same map
    other = load_actnorm(TActNorm(3), _np(jp))
    np.testing.assert_allclose(other(torch.from_numpy(x)).detach().numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("chart", ["mlp", "encoder_flow"])
def test_chart_matches_jax(chart):
    """The chart's points on S^2 and the gradient of a loss wrt the points
    and wrt the chart's parameters, then (encoder_flow) one power
    iteration of its residual flows."""
    jc = JEncoder() if chart == "encoder_flow" else JChart()
    params, state = jc.init(jax.random.PRNGKey(4))
    if chart == "encoder_flow":
        # undo the near-zero init of each residual block's last layer
        params = {**params, "flow": tuple(
            blk[:-1] + ({**blk[-1], "w": blk[-1]["w"] * 1000},) for blk in params["flow"])}
    x = _points((2, 30, 3), 5)

    def loss(p, a):
        s, _ = jc.apply(p, state, a)
        return jnp.sum(s * jnp.asarray([0.3, -0.7, 1.1]))
    jy, _ = jc.apply(params, state, jnp.asarray(x))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tc = load_chart(TEncoder() if chart == "encoder_flow" else TChart(), _np(params),
                    _np(state))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tc(tx)
    (ty * torch.tensor([0.3, -0.7, 1.1])).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(ty, dim=-1).detach().numpy(), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    dense = tc.layers if chart == "mlp" else tc.encoder
    jdense = jgp if chart == "mlp" else jgp["encoder"]
    for layer, g in zip(dense, jdense):
        np.testing.assert_allclose(layer.w.grad.numpy(), np.asarray(g["w"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(layer.b.grad.numpy(), np.asarray(g["b"]), rtol=1e-5,
                                   atol=1e-5)
    if chart == "encoder_flow":
        jstate = jc.update_state(params, state, 1)
        tc.update_state(1)
        layers = [l for blk in tc.flow.flows for l in blk.net.layers]
        for layer, s in zip(layers, [s for blk in jstate["flow"] for s in blk]):
            np.testing.assert_allclose(layer.u.numpy(), np.asarray(s["u"]), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(layer.v.numpy(), np.asarray(s["v"]), rtol=1e-5,
                                       atol=1e-6)
        jy2, _ = jc.apply(params, jstate, jnp.asarray(x))
        np.testing.assert_allclose(tc(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jy2), **TOL)


def test_charts_draw_their_init_from_the_generator():
    for cls in (TChart, TEncoder):
        a = cls(generator=torch.Generator().manual_seed(1))
        b = cls(generator=torch.Generator().manual_seed(1))
        c = cls(generator=torch.Generator().manual_seed(2))
        pa, pb, pc = (list(m.parameters()) for m in (a, b, c))
        assert all(torch.equal(u, v) for u, v in zip(pa, pb))
        assert not all(torch.equal(u, v) for u, v in zip(pa, pc))
