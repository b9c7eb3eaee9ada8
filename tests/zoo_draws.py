"""The random draws of the JAX package's flow methods, as the port's
``draws=`` keyword arguments.

The JAX package draws its directions from a key inside each function;
the port draws from a ``torch.Generator`` or takes them by name. These
helpers repeat the JAX functions' own use of the key, so the port can be
handed the very directions the JAX step used.
"""

import jax
import jax.numpy as jnp
import torch

from shwd_tpu.losses import sliced_zoo as jz
from shwd_tpu.ops.spherical import stiefel_frames


def _t(a):
    return torch.from_numpy(jax.device_get(a).copy())


def _unit_columns(key, shape):
    c = jax.random.normal(key, shape)
    return c / jnp.linalg.norm(c, axis=0, keepdims=True)


def jax_draws(method: str, key, num_projections: int = 100, max_iter: int = 10,
              poly_degree: int | None = None) -> dict:
    """The port's ``draws`` for one step of ``method`` under ``key``.
    ``poly_degree`` overrides the flow driver's degree (5 for GSWD_POLY,
    3 for MGSWD_POLY)."""
    L = num_projections
    if method == "SWD":
        return {"proj": _t(jz.rand_projections(key, 3, L))}
    if method in ("MSWD",):
        return {"theta0": _t(jz.rand_projections(key, 3, 1))}
    if method in ("SSWD", "SSWD_W1"):
        return {"frames": _t(stiefel_frames(key, L, 3))}
    if method == "GSWD_POLY":
        n = jz.poly_degree_matrix(poly_degree or 5, 3).shape[0]
        return {"coeff": _t(_unit_columns(key, (n, L)))}
    if method == "MGSWD_POLY":
        n = jz.poly_degree_matrix(poly_degree or 3, 3).shape[0]
        return {"coeff0": _t(_unit_columns(key, (n, 1)))}
    if method == "GSWD_POLY3":
        return {"theta": _t(jz.rand_projections(key, 4, L))}
    if method == "GSWD_CIRC":
        return {"theta": _t(jz.rand_projections(key, 3, L))}
    if method == "MGSWD_CIRC":
        return {"theta0": _t(jz.rand_projections(key, 3, 1))}
    if method == "ASWD":
        k1, k2 = jax.random.split(key)
        return {"proj_inner": _t(jz.rand_projections(k1, 6, L)),
                "proj_final": _t(jz.rand_projections(k2, 6, L))}
    if method == "DSWD":
        keys = jax.random.split(key, max_iter + 2)
        base = [jz.rand_projections(k, 3, L) for k in keys[:max_iter]]
        base.append(jz.rand_projections(keys[-1], 3, L))
        return {"base": _t(jnp.stack(base))}
    return {}                     # CD, W2, GSW_NN, MGSW_NN draw nothing
