"""Port parity: PointNet and PCRNet (full widths) vs shwd_tpu.models with
converted weights. Inputs and weights come from the JAX package's init and
a numpy seed; tolerances rtol 1e-4 / atol 1e-5 (f32 matrix products with
1024- and 2048-long sums in another order)."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import torch

from shwd_torch.models import PCRNet, PointNet, max_pool
from shwd_torch.utils.convert import (load_pcrnet, load_pcrnet_adam_state,
                                      pcrnet_tree)
from shwd_torch.utils.optim import torch_adam as t_adam
from shwd_tpu.utils.optim import torch_adam as j_adam
from shwd_tpu import models as jm

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clouds(b=3, n=40, seed=51):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    s = t + 0.1 * rng.normal(size=(b, n, 3)).astype(np.float32)
    return t, s


def _pair():
    jmodel = jm.PCRNet()
    params = jmodel.init(jax.random.PRNGKey(5))
    tmodel = load_pcrnet(PCRNet(generator=torch.Generator().manual_seed(0)),
                         _np(params))
    return jmodel, params, tmodel


def test_pointnet_matches_jax():
    jmodel, params, tmodel = _pair()
    t, _ = _clouds()
    want = jmodel.feature_model.apply(params["feature"], jnp.asarray(t))
    got = tmodel.feature_model(torch.from_numpy(t))
    assert got.shape == (3, 40, 1024)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(max_pool(got).detach().numpy(),
                               np.asarray(jm.max_pool(want)), **TOL)


def test_pcrnet_outputs_match_jax():
    """Every field of PCRNetOutput after 3 pose iterations."""
    jmodel, params, tmodel = _pair()
    t, s = _clouds()
    want = jmodel.apply(params, jnp.asarray(t), jnp.asarray(s), 3)
    got = tmodel(torch.from_numpy(t), torch.from_numpy(s), 3)
    for name in ("est_R", "est_t", "est_T", "r", "transformed_source"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
    assert got.est_T.shape == (3, 4, 4) and got.est_t.shape == (3, 1, 3)


def test_pcrnet_gradient_matches_jax():
    """d sum(transformed_source^2) / d params, leaf by leaf (rtol 1e-3 /
    atol 1e-5: a backward through 3 iterations of both networks)."""
    jmodel, params, tmodel = _pair()
    t, s = _clouds(2, 24, seed=52)
    jgrads = jax.grad(lambda p: jnp.sum(jmodel.apply(
        p, jnp.asarray(t), jnp.asarray(s), 3).transformed_source ** 2))(params)
    out = tmodel(torch.from_numpy(t), torch.from_numpy(s), 3)
    (out.transformed_source ** 2).sum().backward()
    for group in ("feature", "head"):
        layers = tmodel.feature_model.layers if group == "feature" else tmodel.head
        for layer, jg in zip(layers, jgrads[group]):
            for k in ("w", "b"):
                np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                           np.asarray(jg[k]), rtol=1e-3, atol=1e-5)


def test_init_statistics_and_tree_round_trip():
    """U(+-1/sqrt(fan_in)) from an explicit generator, (out, in) weights,
    and pcrnet_tree / load_pcrnet are inverse to each other."""
    a = PCRNet(generator=torch.Generator().manual_seed(3))
    b = PCRNet(generator=torch.Generator().manual_seed(3))
    c = PCRNet(generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.head[0].w, b.head[0].w)
    assert not torch.equal(a.head[0].w, c.head[0].w)
    assert a.head[0].w.shape == (1024, 2048)
    assert [tuple(l.w.shape) for l in a.feature_model.layers] == [
        (64, 3), (64, 64), (64, 64), (128, 64), (1024, 128)]
    bound = 1 / np.sqrt(2048)
    w = a.head[0].w.detach()
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.99 * bound
    assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.02 * bound
    tree = pcrnet_tree(a)
    assert len(tree["feature"]) == 5 and len(tree["head"]) == 6
    load_pcrnet(c, tree)
    for p, q in zip(a.parameters(), c.parameters()):
        assert torch.equal(p, q)


def test_pointnet_custom_widths():
    net = PointNet(emb_dims=32, widths=(3, 8), generator=torch.Generator().manual_seed(0))
    assert net(torch.zeros(2, 5, 3)).shape == (2, 5, 32)


def test_converted_adam_state_steps_like_optax():
    """Take one optax step on random gradients, convert the parameters and
    the Adam moments, then take the second step on both sides: rtol 1e-5."""
    import optax
    _, params, tmodel = _pair()
    rng = np.random.default_rng(53)

    def grads_like(tree):
        return jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), tree)

    opt = j_adam(1e-3, 1e-2)
    ostate = opt.init(params)
    updates, ostate = opt.update(grads_like(params), ostate, params)
    params = optax.apply_updates(params, updates)
    adam = next(s for s in ostate if isinstance(s, optax.ScaleByAdamState))
    load_pcrnet(tmodel, _np(params))
    topt = t_adam(tmodel.parameters(), 1e-3, 1e-2)
    load_pcrnet_adam_state(topt, tmodel, _np(adam.mu), _np(adam.nu),
                           np.asarray(adam.count))
    g2 = grads_like(params)
    updates, _ = opt.update(g2, ostate, params)
    want = optax.apply_updates(params, updates)
    for group in ("feature", "head"):
        layers = tmodel.feature_model.layers if group == "feature" else tmodel.head
        for layer, g in zip(layers, g2[group]):
            for k in ("w", "b"):
                getattr(layer, k).grad = torch.from_numpy(np.array(g[k]))
    topt.step()
    got = pcrnet_tree(tmodel)
    for a, b in zip(jax.tree_util.tree_leaves(_np(want)),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
