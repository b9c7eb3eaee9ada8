"""Port parity: PointNet and PCRNet (full widths) vs shwd_tpu.models with
converted weights. Inputs and weights come from the JAX package's init and
a numpy seed; tolerances rtol 1e-4 / atol 1e-5 (f32 matrix products with
1024- and 2048-long sums in another order)."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


LAW_SEEDS = range(16)
LAW_P = 1e-3


def _pcrnet_law(side: str) -> list:
    """Every weight and bias of PCRNet over 16 seeds divided by its bound
    1/sqrt(fan_in) (U(-1, 1) if the law holds), 2000 entries a layer and
    seed at fixed positions."""
    pick = np.random.default_rng(0)
    out = []
    for seed in LAW_SEEDS:
        if side == "jax":
            tree = _np(jm.PCRNet().init(jax.random.PRNGKey(seed)))
        else:
            tree = pcrnet_tree(PCRNet(generator=torch.Generator().manual_seed(seed)))
        for group in ("feature", "head"):
            for layer in tree[group]:
                bound = 1.0 / np.sqrt(layer["w"].shape[1])
                for leaf in (layer["w"], layer["b"]):
                    flat = leaf.ravel()
                    idx = pick.choice(flat.size, min(flat.size, 2000), replace=False)
                    out.append(flat[idx] / bound)
    return [np.concatenate(out)]


def _phi_shift_law(side: str) -> list:
    """phi(x) - x of the SHWD criterion's initial Residual phi (3 layers)
    on one fixed numpy cloud, per seed: its mean over the cloud (3
    components; the last layers' biases, shared by every point, so the
    points are not independent draws) and the log RMS of the rest."""
    from shwd_torch.flows import make_flow as t_make_flow
    from shwd_tpu.flows import make_flow as j_make_flow
    x = np.random.default_rng(7).uniform(-1, 1, size=(64, 3)).astype(np.float32)
    flow = j_make_flow("Residual", 3)
    j_shift = jax.jit(lambda key: flow(*flow.init(key), jnp.asarray(x)))
    means, spreads = [], []
    for seed in LAW_SEEDS:
        if side == "jax":
            y = np.asarray(j_shift(jax.random.PRNGKey(seed)))
        else:
            phi = t_make_flow("Residual", 3, generator=torch.Generator().manual_seed(seed))
            with torch.no_grad():
                y = phi(torch.from_numpy(x)).numpy()
        shift = (y - x).astype(np.float64)
        means.append(shift.mean(axis=0))
        spreads.append(np.log(np.sqrt(np.mean((shift - shift.mean(axis=0)) ** 2))))
    return [np.concatenate(means), np.asarray(spreads)]


def _pose_law(side: str) -> list:
    """(rotation angle in rad, translation's x) of 256 Euler-uniform poses
    a seed over 16 seeds; the translation's norm must be 1 on both sides."""
    from shwd_torch.data import transforms as t_transforms
    from shwd_tpu.data import transforms as j_transforms
    cfg = t_transforms.TransformConfig()
    out = []
    for seed in LAW_SEEDS:
        if side == "jax":
            pose = np.asarray(j_transforms.random_pose_7d(
                jax.random.PRNGKey(seed), 256, j_transforms.TransformConfig()))
        else:
            pose = t_transforms.random_pose_7d(torch.Generator().manual_seed(seed), 256,
                                               cfg).numpy()
        np.testing.assert_allclose(np.linalg.norm(pose[:, 4:], axis=-1), 1.0, rtol=1e-6)
        out.append(np.stack([2 * np.arccos(np.clip(np.abs(pose[:, 0]), 0, 1)), pose[:, 4]]))
    return list(np.concatenate(out, axis=1))


@pytest.mark.parametrize("what", ["pcrnet", "phi_shift", "pose"])
def test_initial_draws_follow_one_law_in_both_packages(what):
    """The two packages' starts differ in stream only, not in law: a
    two-sample Kolmogorov-Smirnov test of each package's draws against
    the other's, pooled over 16 seeds, at p > 1e-3 (a true shared law
    fails it once in a thousand). PCRNet's weights over their bound (2000
    a layer and seed), the initial phi's shift (its per-seed mean and
    spread), the pose's angle and translation (256 a seed). ~25 s for
    PCRNet (drawn 16 times a side), a few s for the others."""
    from scipy.stats import ks_2samp
    law = {"pcrnet": _pcrnet_law, "phi_shift": _phi_shift_law, "pose": _pose_law}[what]
    port, ref = law("torch"), law("jax")
    for a, b in zip(port, ref, strict=True):
        assert a.shape == b.shape
        assert np.std(b) > 0, f"{what}: the JAX draws are constant"
        assert ks_2samp(a, b).pvalue > LAW_P, f"{what}: KS p = {ks_2samp(a, b).pvalue}"
