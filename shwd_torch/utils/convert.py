"""Load phi and PCRNet weights and Adam state from the JAX package's layout.

The JAX package keeps phi as ``(params, state)`` pytrees: a tuple over
flows of a tuple over layers of ``{"w", "b", "beta"}`` (params) and
``{"u", "v"}`` (state); and PCRNet as ``{"feature": tuple of {"w", "b"},
"head": tuple of {"w", "b"}}``. These helpers take those trees with NUMPY
leaves (callers apply ``np.asarray`` to the JAX leaves), so this module
needs no JAX.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..flows.base import FlowChain
from ..models.pcrnet import PCRNet


def _layers(flow: FlowChain):
    for block in flow.flows:
        yield from block.net.layers


def _flat(tree: Sequence[Sequence[dict]]):
    for block in tree:
        yield from block


@torch.no_grad()
def load_phi(flow: FlowChain, params, state) -> FlowChain:
    """Copy ``(params, state)`` into ``flow`` in place; returns ``flow``."""
    layers = list(_layers(flow))
    p_flat, s_flat = list(_flat(params)), list(_flat(state))
    if not (len(layers) == len(p_flat) == len(s_flat)):
        raise ValueError(f"phi has {len(layers)} layers, the trees "
                         f"{len(p_flat)} and {len(s_flat)}")
    for layer, p, s in zip(layers, p_flat, s_flat):
        for name, src in (("w", p["w"]), ("b", p["b"]), ("beta", p["beta"]),
                          ("u", s["u"]), ("v", s["v"])):
            dst = getattr(layer, name)
            val = torch.tensor(np.asarray(src), dtype=dst.dtype)
            if val.shape != dst.shape:
                raise ValueError(f"{name}: shape {tuple(val.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(val)
    return flow


def phi_tree(flow: FlowChain):
    """The JAX layout of ``flow``'s (params, state), as numpy leaves."""
    params, state = [], []
    for block in flow.flows:
        ps, ss = [], []
        for layer in block.net.layers:
            ps.append({k: getattr(layer, k).detach().cpu().numpy()
                       for k in ("w", "b", "beta")})
            ss.append({k: getattr(layer, k).detach().cpu().numpy()
                       for k in ("u", "v")})
        params.append(tuple(ps))
        state.append(tuple(ss))
    return tuple(params), tuple(state)


def load_adam_state(opt: torch.optim.Adam, flow: FlowChain, mu, nu,
                    count: Any) -> None:
    """Set ``opt``'s per-parameter state from an optax ``ScaleByAdamState``
    (``mu``/``nu`` in the params layout, ``count`` the step), so a mid-run
    step can be compared. ``opt`` must optimise ``flow``'s parameters."""
    step = float(np.asarray(count))
    layers = list(_layers(flow))
    for layer, m, v in zip(layers, _flat(mu), _flat(nu)):
        for name in ("w", "b", "beta"):
            p = getattr(layer, name)
            opt.state[p] = {
                "step": torch.tensor(step),
                "exp_avg": torch.tensor(np.asarray(m[name]), dtype=p.dtype,
                                        device=p.device),
                "exp_avg_sq": torch.tensor(np.asarray(v[name]), dtype=p.dtype,
                                           device=p.device),
            }


def _pcrnet_layers(model: PCRNet):
    """(layer, group, index) in the order of the JAX tree's leaves."""
    for i, layer in enumerate(model.feature_model.layers):
        yield layer, "feature", i
    for i, layer in enumerate(model.head):
        yield layer, "head", i


@torch.no_grad()
def load_pcrnet(model: PCRNet, params) -> PCRNet:
    """Copy the JAX ``params`` tree into ``model`` in place; returns it."""
    for layer, group, i in _pcrnet_layers(model):
        for name in ("w", "b"):
            dst = getattr(layer, name)
            val = torch.tensor(np.asarray(params[group][i][name]), dtype=dst.dtype)
            if val.shape != dst.shape:
                raise ValueError(f"{group}[{i}].{name}: shape "
                                 f"{tuple(val.shape)} != {tuple(dst.shape)}")
            dst.copy_(val)
    return model


def pcrnet_tree(model: PCRNet):
    """The JAX layout of ``model``'s parameters, as numpy leaves."""
    tree = {"feature": [], "head": []}
    for layer, group, _ in _pcrnet_layers(model):
        tree[group].append({k: getattr(layer, k).detach().cpu().numpy()
                            for k in ("w", "b")})
    return {k: tuple(v) for k, v in tree.items()}


def load_pcrnet_adam_state(opt: torch.optim.Adam, model: PCRNet, mu, nu,
                           count: Any) -> None:
    """Set the model optimizer's state from an optax ``ScaleByAdamState``
    (``mu``/``nu`` in the params layout, ``count`` the step)."""
    step = float(np.asarray(count))
    for layer, group, i in _pcrnet_layers(model):
        for name in ("w", "b"):
            p = getattr(layer, name)
            opt.state[p] = {
                "step": torch.tensor(step),
                "exp_avg": torch.tensor(np.asarray(mu[group][i][name]),
                                        dtype=p.dtype, device=p.device),
                "exp_avg_sq": torch.tensor(np.asarray(nu[group][i][name]),
                                           dtype=p.dtype, device=p.device),
            }
