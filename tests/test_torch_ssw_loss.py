"""Port parity: the max-SSW criterion (an Adam ascent of a sphere chart on
the summed spherical sliced-Wasserstein) vs shwd_tpu.losses.ssw_loss.

One ``apply`` with ``train=True`` and two inner steps. The JAX side's
frames and minibatch indices are recomputed from its key splits
(``split(state.key, max_iter + 1)``, then ``split(keys[i])`` into the
frames' and the subset's keys; the final solve ``split(keys[-1])[0]``) and
handed to the port through the loss's ``draw`` hook. The chart's
parameters after the ascent are held at rtol 1e-4, the final value at
rtol 1e-5, its gradient wrt the clouds at rtol 1e-4.

Where ``circle_ot`` bisects (p other than 1 and 2) the JAX side runs op
by op (``jax.disable_jit``): compiled by XLA on the CPU, the bisection
evaluates its cut arithmetic in another order, which moves slices whose
cost is ~1e-8 (nearby clouds at p = 3) by ~1e-9, 1e-4 of a summed value
of ~5e-5 (ROADMAP Queue 3). Run op by op, the two packages agree to 3e-7
on those slices.

The chart's lr is the trainer's (``TrainConfig.max_ssw``, 9.213e-5). Adam
divides each gradient entry by its own size, so an entry at rounding
level (|g| ~ 1e-7 against the packages' 1e-8 difference) moves the chart
by a different share of lr on each side; at the JAX default lr of 0.01
that shifts the final value by up to 5e-5 (relative) while the value at
equal parameters still agrees to 6e-7.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.flows import EncoderFlowChart as TEncoder
from shwd_torch.flows import SphereChartMLP as TChart
from shwd_torch.losses import ssw_loss as ts
from shwd_torch.utils.convert import load_chart, load_max_ssw_adam_state
from shwd_tpu.flows import EncoderFlowChart as JEncoder
from shwd_tpu.flows import SphereChartMLP as JChart
from shwd_tpu.losses import ssw_loss as js
from shwd_tpu.ops.spherical import stiefel_frames as j_frames

B, N, L = 4, 24, 16
LR = 9.213233310357477e-05


def _clouds():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    y = (x + 0.3 * rng.normal(size=(B, N, 3))).astype(np.float32)
    return x, y


def _jax_draws(key, cfg, b):
    """The frames and subsets the JAX loss draws in one train call."""
    keys = jax.random.split(key, cfg.max_iter + 1)
    draws = []
    for i in range(cfg.max_iter):
        k_frames, k_mb = jax.random.split(keys[i])
        idx = None
        if cfg.minibatch > 0:
            idx = np.asarray(jax.random.choice(k_mb, b, (cfg.minibatch,), replace=False))
        draws.append((np.asarray(j_frames(k_frames, cfg.num_projections, 3)), idx))
    k_final, _ = jax.random.split(keys[-1])
    draws.append((np.asarray(j_frames(k_final, cfg.num_projections, 3)), None))
    return draws


def _tree(c):
    return jax.tree_util.tree_map(np.asarray, c)


@pytest.mark.parametrize("chart,minibatch,p", [("mlp", 0, 2.0), ("mlp", 2, 3.0),
                                               ("encoder_flow", 0, 2.0),
                                               ("encoder_flow", 3, 1.0)])
def test_max_ssw_train_call_matches_jax(chart, minibatch, p):
    kw = dict(num_projections=L, p=p, max_iter=2, phi_lr=LR, minibatch=minibatch)
    jcrit = js.MaxSSWLoss(JEncoder() if chart == "encoder_flow" else JChart(),
                          js.MaxSSWConfig(**kw))
    jstate = jcrit.init(jax.random.PRNGKey(1))
    x, y = _clouds()

    def f(a, b):
        (v, _, _), st = jcrit.apply(jstate, a, b, True)
        return v, st
    vg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    if p in (1.0, 2.0):
        (jv, jnew), (jgx, jgy) = vg(jnp.asarray(x), jnp.asarray(y))
    else:
        with jax.disable_jit():
            (jv, jnew), (jgx, jgy) = vg(jnp.asarray(x), jnp.asarray(y))

    tcrit = ts.MaxSSWLoss(lambda g: None, ts.MaxSSWConfig(**kw))
    phi = load_chart(TEncoder() if chart == "encoder_flow" else TChart(),
                     _tree(jstate.phi_params), _tree(jstate.phi_state))
    tstate = tcrit.init(torch.Generator().manual_seed(0), phi=phi)
    draws = iter(_jax_draws(jstate.key, jcrit.cfg, B))

    def draw(mb):
        frames, idx = next(draws)
        assert (idx is None) == (mb == 0)
        return torch.tensor(frames), None if idx is None else torch.tensor(idx)

    tcrit.draw = draw
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    (tv, sx, sy), _ = tcrit.apply(tstate, tx, ty, True)
    tv.backward()
    assert next(draws, None) is None
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.vector_norm(sx, dim=-1).detach().numpy(), 1.0,
                               atol=1e-5)
    # the chart after the ascent: the same parameters, leaf for leaf
    skeleton = TEncoder if chart == "encoder_flow" else TChart
    want = load_chart(skeleton(), _tree(jnew.phi_params), _tree(jnew.phi_state))
    start = load_chart(skeleton(), _tree(jstate.phi_params), _tree(jstate.phi_state))
    for a, b in zip(tstate.phi.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4,
                                   atol=1e-6)
    moved = max(float((a - b).abs().max().detach()) for a, b in zip(want.parameters(),
                                                          start.parameters()))
    assert moved > LR
    for a, b in zip(tstate.phi.buffers(), want.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_max_ssw_eval_call_skips_the_ascent_and_draws_from_the_generator():
    crit = ts.MaxSSWLoss(lambda g: TChart(generator=g), ts.MaxSSWConfig(num_projections=L))
    state = crit.init(torch.Generator().manual_seed(0))
    before = [p.clone() for p in state.phi.parameters()]
    x, y = (torch.from_numpy(a) for a in _clouds())
    (v1, _, _), _ = crit.apply(state, x, y, False)
    (v2, _, _), _ = crit.apply(state, x, y, False)
    assert all(torch.equal(a, b) for a, b in zip(before, state.phi.parameters()))
    # fresh frames each call from the state's generator
    assert not torch.equal(v1, v2)
    # an unbatched cloud is one item
    (v3, sx, _), _ = crit.apply(state, x[0], y[0], False)
    assert v3.shape == () and sx.shape == (1, N, 3)


def test_max_ssw_carries_the_jax_adam_state():
    """A second train call from the JAX state after a first: the chart
    and its Adam moments (``load_max_ssw_adam_state``) converted, the
    second call's frames handed in; the chart after it at rtol 1e-4."""
    kw = dict(num_projections=L, p=2.0, max_iter=1, phi_lr=LR)
    jcrit = js.MaxSSWLoss(JChart(), js.MaxSSWConfig(**kw))
    x, y = _clouds()
    _, s1 = jcrit.apply(jcrit.init(jax.random.PRNGKey(6)), jnp.asarray(x), jnp.asarray(y), True)
    _, s2 = jcrit.apply(s1, jnp.asarray(x), jnp.asarray(y), True)

    tcrit = ts.MaxSSWLoss(lambda g: None, ts.MaxSSWConfig(**kw))
    state = tcrit.init(torch.Generator().manual_seed(0),
                       phi=load_chart(TChart(), _tree(s1.phi_params), ()))
    adam = _tree(s1.opt_state[0])
    load_max_ssw_adam_state(state.opt, state.phi, adam.mu, adam.nu, adam.count)
    draws = iter(_jax_draws(s1.key, jcrit.cfg, B))
    tcrit.draw = lambda mb: (lambda f, i: (torch.tensor(f), i))(*next(draws))
    tcrit.apply(state, torch.from_numpy(x), torch.from_numpy(y), True)
    want = load_chart(TChart(), _tree(s2.phi_params), ())
    for a, b in zip(state.phi.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4,
                                   atol=1e-6)
    assert all(float(state.opt.state[p]["step"]) == 2.0 for p in state.phi.parameters())
