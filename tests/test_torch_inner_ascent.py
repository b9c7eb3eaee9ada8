"""The functional inner ascent of the sliced zoo against the JAX package.

``sliced_zoo.adversarial_maximize`` is an optax-rule Adam unrolled in
Python (moments from zero inside the call, the bias corrections as Python
floats of the step index), so that a flow step of MSWD, MGSWD_POLY,
MGSWD_CIRC, ASWD, DSWD or MGSW_NN records into a CUDA graph. Here it runs
against the JAX ``adversarial_maximize`` (a ``lax.scan`` over
``optax.adam``) on the same numpy-seeded parameters and objective: MSWD's
direction (renormalised rows), MGSWD_POLY's coefficients (renormalised
columns) and an ASWD mapping (a tree, betas (0.5, 0.999)). The parameters
after 10 steps agree at rtol 1e-5, atol 1e-6. A few seconds on one worker.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from shwd_torch.losses import sliced_zoo as tz
from shwd_tpu.losses import sliced_zoo as jz


def _clouds(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (0.5 * rng.normal(size=(n, 3)) + 0.3).astype(np.float32)
    return x, y


def _unit(a, axis):
    return (a / np.linalg.norm(a, axis=axis, keepdims=True)).astype(np.float32)


def _case(name):
    """(initial parameters as a numpy tree, JAX objective, port objective,
    JAX projection, port projection, betas)."""
    x, y = _clouds()
    rng = np.random.default_rng(11)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    if name == "MSWD":
        theta0 = _unit(rng.normal(size=(1, 3)), -1)
        return (theta0,
                lambda t: jz._projected_w(jx @ t.T, jy @ t.T, 2),
                lambda t: tz._projected_w(tx @ t.T, ty @ t.T, 2),
                lambda t: t / jnp.linalg.norm(t, axis=-1, keepdims=True), tz._renorm_rows,
                (0.999, 0.999))
    if name == "MGSWD_POLY":
        dm = tz.poly_degree_matrix(3, 3)
        coeff0 = _unit(rng.normal(size=(dm.shape[0], 1)), 0)
        jf = [jz._poly_features(a, jnp.asarray(dm)) for a in (jx, jy)]
        tf = [tz._poly_features(a, torch.from_numpy(dm)) for a in (tx, ty)]
        return (coeff0,
                lambda c: jz._projected_w(jf[0] @ c, jf[1] @ c, 2),
                lambda c: tz._projected_w(tf[0] @ c, tf[1] @ c, 2),
                lambda c: c / jnp.linalg.norm(c, axis=0, keepdims=True), tz._renorm_cols,
                (0.999, 0.999))
    # ASWD: the augmented clouds' SWD along fixed directions, minus 0.5 x
    # their mean norm (the shape of the ASWD inner objective)
    params = {"w": rng.uniform(-0.5, 0.5, size=(3, 3)).astype(np.float32),
              "b": rng.uniform(-0.5, 0.5, size=(3,)).astype(np.float32)}
    proj = _unit(rng.normal(size=(16, 6)), -1)

    def objective(apply, norm, w, a, b, p):
        def obj(params):
            fa, fb = apply(params, a), apply(params, b)
            reg = 0.5 * (norm(fa).mean() + norm(fb).mean())
            return w(fa @ p.T, fb @ p.T, 2) - reg
        return obj

    return (params,
            objective(jz._mapping_apply, lambda f: jnp.linalg.norm(f, axis=1),
                      jz._projected_w, jx, jy, jnp.asarray(proj)),
            objective(tz._mapping_apply, lambda f: torch.linalg.vector_norm(f, dim=1),
                      tz._projected_w, tx, ty, torch.from_numpy(proj)),
            None, None, (0.5, 0.999))


@pytest.mark.parametrize("name", ["MSWD", "MGSWD_POLY", "ASWD"])
def test_functional_ascent_matches_jax(name):
    """10 ascent steps from the same parameters on the same objective: the
    returned parameters agree at rtol 1e-5, atol 1e-6, come back detached
    and are new tensors (the input is left as it was)."""
    params0, jobj, tobj, jproj, tproj, betas = _case(name)
    want = jz.adversarial_maximize(jobj, jax.tree_util.tree_map(jnp.asarray, params0),
                                   10, betas=betas, project=jproj)
    start = pytree.tree_map(lambda a: torch.from_numpy(a.copy()), params0)
    got = tz.adversarial_maximize(tobj, start, 10, betas=betas, project=tproj)
    # by key: the two pytrees order a dict's leaves differently
    keyed = (lambda t: t if isinstance(t, dict) else {"": t})
    got, want, start, params0 = (keyed(t) for t in (got, want, start, params0))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert not got[k].requires_grad
        assert np.array_equal(start[k].numpy(), params0[k])
    assert max(float(np.abs(got[k].numpy() - params0[k]).max()) for k in got) > 1e-3


def test_functional_ascent_keeps_no_step_count():
    """The ascent is the same computation whatever ran before it: two calls
    on the same inputs give the same bits (no optimizer state survives a
    call), and ``xs`` sets the number of steps."""
    params0, _, tobj, _, tproj, betas = _case("MSWD")
    a = tz.adversarial_maximize(tobj, torch.from_numpy(params0), 10, betas=betas,
                                project=tproj)
    b = tz.adversarial_maximize(tobj, torch.from_numpy(params0), 10, betas=betas,
                                project=tproj)
    assert torch.equal(a, b)
    seen = []
    c = tz.adversarial_maximize(lambda t, x: seen.append(x) or tobj(t),
                                torch.from_numpy(params0), 10, betas=betas,
                                project=tproj, xs=torch.arange(3.0))
    assert [float(v) for v in seen] == [0.0, 1.0, 2.0]
    assert not torch.equal(a, c)
