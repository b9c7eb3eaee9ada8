"""The sliced-Wasserstein distance zoo of the gradient-flow comparison.

Counterpart of ``shwd_tpu/losses/sliced_zoo.py``: SWD, max-SWD,
generalized SWD (polynomial, circular, neural), augmented SWD (ASWD) and
distributional SWD (DSWD), the comparison methods of the gradient flow.

Every adversarial variant (max-*, ASWD, DSWD, max-GSW-NN) shares
``adversarial_maximize``: a functional Adam ascent (optax's rule,
unrolled) on detached copies of the parameters, returned detached (the JAX
package's ``stop_gradient``); it records into a CUDA graph as it is.
Learned components (the ASWD mapping, the DSWD transform net, the GSW MLP)
are explicit parameter trees of tensors: ``{"w", "b"}`` and a tuple of
them, as in the JAX package.

Random draws come from a ``torch.Generator``. Each function also takes its
draws explicitly (``proj=``, ``theta0=``, ``coeff=``, ...), so tests can
hand in the JAX package's draws; no function waits on the card.
"""

from __future__ import annotations

import functools
import math
from itertools import combinations
from typing import Callable

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils import _pytree as pytree


def rand_projections(generator: torch.Generator | None, dim: int,
                     num_projections: int = 100,
                     device: str | torch.device | None = None) -> torch.Tensor:
    """L uniform directions on S^{dim-1}, (L, dim)."""
    if device is None and generator is not None:
        device = generator.device
    p = torch.randn(num_projections, dim, generator=generator, device=device)
    return p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)


def _projected_w(xp: torch.Tensor, yp: torch.Tensor, p: float) -> torch.Tensor:
    """sum_i |sort(xp) - sort(yp)|^p per projection, then (mean over
    projections)^(1/p). xp, yp: (N, L)."""
    d = torch.abs(torch.sort(xp.T, dim=1).values - torch.sort(yp.T, dim=1).values)
    w = torch.sum(d ** p, dim=1)
    return torch.mean(w) ** (1.0 / p)


def sliced_wasserstein_distance(generator, x, y, num_projections: int = 100,
                                p: float = 2, proj: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Plain SWD; x, y: (N, 3). ``proj`` (L, 3) replaces the draw."""
    if proj is None:
        proj = rand_projections(generator, x.shape[-1], num_projections, x.device)
    return _projected_w(x @ proj.T, y @ proj.T, p)


# ---------------------------------------------------------------------------
# the generic inner maximisation
# ---------------------------------------------------------------------------

def adversarial_maximize(objective: Callable, params, max_iter: int = 10,
                         lr: float = 0.005, betas=(0.999, 0.999),
                         project: Callable | None = None, xs=None):
    """``max_iter`` Adam ascent steps on ``objective(params)`` (maximised),
    re-projecting the parameters after each step when ``project`` is given.

    ``params`` is a tensor or a tree (dicts, tuples) of tensors; the result
    is a detached tree of new tensors. With ``xs`` (indexed on its leading
    axis, e.g. per-step random directions) the objective is called as
    ``objective(params, x=xs[i])`` and ``len(xs)`` steps run.

    The Adam is functional and follows optax's ``scale_by_adam``: moments
    that start at zero inside the call, ``m / (1 - b1^t)`` over
    ``sqrt(v / (1 - b2^t)) + eps`` (eps 1e-8 outside the square root). The
    steps are unrolled in Python, as ``lax.scan`` unrolls at trace time, and
    the bias corrections are Python floats of the step index: no step count
    lives on the host or the device, so the ascent records into a CUDA graph
    as it is.
    """
    b1, b2 = betas
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach() for t in leaves]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    steps = max_iter if xs is None else len(xs)
    for i in range(steps):
        with torch.enable_grad():
            q = [t.detach().requires_grad_(True) for t in leaves]
            tree = pytree.tree_unflatten(q, spec)
            obj = objective(tree) if xs is None else objective(tree, x=xs[i])
            grads = torch.autograd.grad(-obj, q)
        bc1, bc2 = 1.0 - b1 ** (i + 1), 1.0 - b2 ** (i + 1)
        with torch.no_grad():
            mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, mu)]
            nu = [(1.0 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu)]
            leaves = [t + (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) * -lr
                      for t, m, v in zip(leaves, mu, nu)]
            if project is not None:
                leaves = pytree.tree_flatten(project(pytree.tree_unflatten(leaves, spec)))[0]
    return pytree.tree_unflatten([t.detach() for t in leaves], spec)


def _renorm_rows(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def _renorm_cols(c: torch.Tensor) -> torch.Tensor:
    return c / torch.linalg.vector_norm(c, dim=0, keepdim=True)


def max_sliced_wasserstein_distance(generator, x, y, p: float = 2,
                                    max_iter: int = 10,
                                    theta0: torch.Tensor | None = None
                                    ) -> torch.Tensor:
    """Max-SWD: one direction (1, 3) ascended by Adam from ``theta0``."""
    if theta0 is None:
        theta0 = rand_projections(generator, x.shape[-1], 1, x.device)
    xd, yd = x.detach(), y.detach()

    def obj(theta):
        return _projected_w(xd @ theta.T, yd @ theta.T, p)

    theta = adversarial_maximize(obj, theta0, max_iter, project=_renorm_rows)
    return _projected_w(x @ theta.T, y @ theta.T, p)


# ---------------------------------------------------------------------------
# generalized SWD: polynomial and circular defining functions
# ---------------------------------------------------------------------------

def poly_degree_matrix(degree: int, dim: int) -> np.ndarray:
    """Exponent matrix of all degree-``degree`` monomials in ``dim``
    variables (stars and bars), (n_monomials, dim) f32. A numpy copy of the
    JAX package's function."""
    comb = list(combinations(np.arange(1, degree + dim), dim - 1))
    out = np.zeros((len(comb), dim), dtype=np.float32)
    for i, c in enumerate(comb):
        c = list(c) + [degree + dim]
        for j, index in enumerate(c):
            out[i, j] = index - 1 if j == 0 else index - c[j - 1] - 1
    return out


def _poly_features(samples: torch.Tensor, degree_matrix: torch.Tensor) -> torch.Tensor:
    """(N, d) -> (N, n_monomials): prod_k x_k^{e_k} per monomial row.

    The gradient of x^0 at x = 0 is 0 (``pow``'s backward masks zero
    exponents). The product is taken factor by factor: ``torch.prod``'s
    backward asks the host whether any factor is zero, a sync with the
    card."""
    factors = samples[:, None, :] ** degree_matrix[None, :, :]
    out = factors[..., 0]
    for k in range(1, factors.shape[-1]):
        out = out * factors[..., k]
    return out


@functools.lru_cache(maxsize=None)
def _degree_matrix(degree: int, dim: int, device: torch.device) -> torch.Tensor:
    """The exponent matrix on ``device``, copied there once: a copy from
    the host inside a step would wait on the card."""
    return torch.from_numpy(poly_degree_matrix(degree, dim)).to(device)


def gswd_polynomial(generator, x, y, num_projections: int = 100, degree: int = 5,
                    p: float = 2, coeff: torch.Tensor | None = None) -> torch.Tensor:
    """GSWD with a random homogeneous-polynomial defining function;
    ``coeff`` (n_monomials, L) replaces the draw."""
    dm = _degree_matrix(degree, x.shape[-1], x.device)
    if coeff is None:
        coeff = _renorm_cols(torch.randn(dm.shape[0], num_projections,
                                         generator=generator, device=x.device))
    return _projected_w(_poly_features(x, dm) @ coeff, _poly_features(y, dm) @ coeff, p)


def max_gswd_polynomial(generator, x, y, degree: int = 3, p: float = 2,
                        max_iter: int = 10, coeff0: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """max-GSWD-polynomial: one coefficient column (n_monomials, 1) ascended
    from ``coeff0``."""
    dm = _degree_matrix(degree, x.shape[-1], x.device)
    if coeff0 is None:
        coeff0 = _renorm_cols(torch.randn(dm.shape[0], 1, generator=generator,
                                          device=x.device))
    fx, fy = _poly_features(x.detach(), dm), _poly_features(y.detach(), dm)

    def obj(c):
        return _projected_w(fx @ c, fy @ c, p)

    coeff = adversarial_maximize(obj, coeff0, max_iter, project=_renorm_cols)
    return _projected_w(_poly_features(x, dm) @ coeff, _poly_features(y, dm) @ coeff, p)


def _cubic_2d(s: torch.Tensor) -> torch.Tensor:
    a, b = s[:, 0], s[:, 1]
    return torch.stack([b ** 3, a * b ** 2, a ** 2 * b, a ** 3], dim=-1)


def gswd_polynomial3_2d(generator, x, y, num_projections: int = 100, p: float = 2,
                        theta: torch.Tensor | None = None) -> torch.Tensor:
    """The homogeneous cubic in the first two coordinates, features
    (y^3, x y^2, x^2 y, x^3); ``theta`` (L, 4) replaces the draw."""
    if theta is None:
        theta = rand_projections(generator, 4, num_projections, x.device)
    return _projected_w(_cubic_2d(x) @ theta.T, _cubic_2d(y) @ theta.T, p)


def _circular_features(samples, theta, r):
    """Distances to the anchors theta * r, (N, L)."""
    d2 = torch.sum((samples[:, None, :] - (theta * r)[None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp_min(d2, 1e-20))


def gswd_circular(generator, x, y, num_projections: int = 100, r: float = 1.0,
                  p: float = 2, theta: torch.Tensor | None = None) -> torch.Tensor:
    """GSWD with circular defining functions; ``theta`` (L, 3) replaces the
    draw."""
    if theta is None:
        theta = rand_projections(generator, x.shape[-1], num_projections, x.device)
    return _projected_w(_circular_features(x, theta, r),
                        _circular_features(y, theta, r), p)


def max_gswd_circular(generator, x, y, r: float = 1.0, p: float = 2,
                      max_iter: int = 10, theta0: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """max-GSWD-circular: one anchor direction (1, 3) ascended from
    ``theta0``."""
    if theta0 is None:
        theta0 = rand_projections(generator, x.shape[-1], 1, x.device)
    xd, yd = x.detach(), y.detach()

    def obj(t):
        return _projected_w(_circular_features(xd, t, r), _circular_features(yd, t, r), p)

    theta = adversarial_maximize(obj, theta0, max_iter, project=_renorm_rows)
    return _projected_w(_circular_features(x, theta, r),
                        _circular_features(y, theta, r), p)


# ---------------------------------------------------------------------------
# learned linear maps: the ASWD mapping and the DSWD transform net
# ---------------------------------------------------------------------------

def _uniform(generator, shape, bound: float, device) -> torch.Tensor:
    return (torch.rand(*shape, generator=generator, device=device) * 2 - 1) * bound


def init_mapping(generator: torch.Generator, dim: int = 3,
                 device: str | torch.device | None = None) -> dict:
    """One linear layer {"w" (dim, dim), "b" (dim,)}, U(-1/sqrt(dim),
    1/sqrt(dim)); its output is concatenated to the input."""
    if device is None:
        device = generator.device
    bound = 1.0 / math.sqrt(dim)
    return {"w": _uniform(generator, (dim, dim), bound, device),
            "b": _uniform(generator, (dim,), bound, device)}


def _mapping_apply(params, x):
    return torch.cat([x, x @ params["w"].T + params["b"]], dim=-1)


def augmented_sliced_wasserstein_distance(generator, x, y, mapping_params,
                                          num_projections: int = 100,
                                          p: float = 2, max_iter: int = 10,
                                          lam=20.0, lr: float = 0.005,
                                          proj_inner: torch.Tensor | None = None,
                                          proj_final: torch.Tensor | None = None):
    """ASWD: maximise the SWD of the augmented clouds [x, Wx + b] minus
    ``lam`` times their mean norm, then the SWD through the new map.
    ``lam`` may be a tensor. The inner steps share one set of directions
    (``proj_inner``), the final value draws another (``proj_final``), both
    (L, 2 * dim). Returns (distance, new_mapping_params)."""
    dim2 = 2 * x.shape[-1]
    if proj_inner is None:
        proj_inner = rand_projections(generator, dim2, num_projections, x.device)
    if proj_final is None:
        proj_final = rand_projections(generator, dim2, num_projections, x.device)
    xd, yd = x.detach(), y.detach()
    n_scale = 512.0 / x.shape[0]

    def obj(params):
        fx = _mapping_apply(params, xd)
        fy = _mapping_apply(params, yd)
        reg = lam * torch.mean(torch.linalg.vector_norm(fx, dim=1)
                               + torch.linalg.vector_norm(fy, dim=1))
        d = torch.abs(torch.sort((fx @ proj_inner.T).T, dim=1).values
                      - torch.sort((fy @ proj_inner.T).T, dim=1).values)
        w = torch.mean(torch.sum(d ** p, dim=1) * n_scale) ** (1.0 / p)
        return w - reg

    new_params = adversarial_maximize(obj, mapping_params, max_iter, lr=lr,
                                      betas=(0.5, 0.999))
    fx = _mapping_apply(new_params, x)
    fy = _mapping_apply(new_params, y)
    return _projected_w(fx @ proj_final.T, fy @ proj_final.T, p), new_params


def init_transform_net(generator: torch.Generator, dim: int = 3,
                       device: str | torch.device | None = None) -> dict:
    """A linear layer {"w", "b"} whose output is renormalised to the sphere
    (the same draw as ``init_mapping``)."""
    return init_mapping(generator, dim, device)


def _transform_net_apply(params, pro):
    out = pro @ params["w"].T + params["b"]
    return out / torch.linalg.vector_norm(out, dim=1, keepdim=True)


def distributional_sliced_wasserstein_distance(generator, x, y, net_params,
                                               num_projections: int = 100,
                                               p: float = 2, max_iter: int = 10,
                                               lam: float = 1.0, lr: float = 0.005,
                                               base: torch.Tensor | None = None):
    """DSWD: random directions pushed through a learned sphere map, the
    SWD along them minus ``lam`` times their mean absolute cosine. The
    directions are redrawn in every inner step and once more for the final
    value: ``base`` (max_iter + 1, L, dim) replaces the draws. Returns
    (distance, new_net_params)."""
    dim = x.shape[-1]
    if base is None:
        base = torch.stack([rand_projections(generator, dim, num_projections, x.device)
                            for _ in range(max_iter + 1)])
    xd, yd = x.detach(), y.detach()

    def obj(params, x):
        proj = _transform_net_apply(params, x)
        norms = torch.linalg.vector_norm(proj, dim=1, keepdim=True)
        cosd = torch.mean(torch.abs(proj @ proj.T / torch.clamp_min(norms * norms.T, 1e-8)))
        return _projected_w(xd @ proj.T, yd @ proj.T, p) - lam * cosd

    params = adversarial_maximize(obj, net_params, lr=lr, betas=(0.5, 0.999),
                                  xs=base[:max_iter])
    proj = _transform_net_apply(params, base[max_iter])
    return _projected_w(x @ proj.T, y @ proj.T, p), params


# ---------------------------------------------------------------------------
# neural GSW (MLP defining function)
# ---------------------------------------------------------------------------

def init_gsw_mlp(generator: torch.Generator, din: int = 3, dout: int = 10,
                 num_filters: int = 32, depth: int = 3,
                 device: str | torch.device | None = None) -> tuple:
    """depth x (linear + leaky ReLU) + a linear head: a tuple of
    {"w" (out, in), "b" (out,)}, each U(-1/sqrt(in), 1/sqrt(in))."""
    if device is None:
        device = generator.device
    widths = [din] + [num_filters] * depth + [dout]
    layers = []
    for i in range(len(widths) - 1):
        bound = 1.0 / math.sqrt(widths[i])
        layers.append({"w": _uniform(generator, (widths[i + 1], widths[i]), bound, device),
                       "b": _uniform(generator, (widths[i + 1],), bound, device)})
    return tuple(layers)


def _gsw_mlp_apply(params, x):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"].T + layer["b"]
        if i < len(params) - 1:
            h = F.leaky_relu(h, 0.01)
    return h


def gsw_nn(x, y, net_params, p: float = 2) -> torch.Tensor:
    """SWD through a fixed neural defining function."""
    return _projected_w(_gsw_mlp_apply(net_params, x), _gsw_mlp_apply(net_params, y), p)


def max_gsw_nn(x, y, net_params, p: float = 2, max_iter: int = 10,
               lr: float = 0.005):
    """Train the defining net adversarially, then the SWD through it.
    Returns (distance, new_net_params)."""
    xd, yd = x.detach(), y.detach()

    def obj(params):
        return _projected_w(_gsw_mlp_apply(params, xd), _gsw_mlp_apply(params, yd), p)

    new_params = adversarial_maximize(obj, net_params, max_iter, lr=lr,
                                      betas=(0.5, 0.999))
    return gsw_nn(x, y, new_params, p), new_params
