"""Load phi, chart and PCRNet weights and Adam state from the JAX
package's layout.

The JAX package keeps phi as ``(params, state)`` pytrees: a tuple over
flows of a tuple over layers of ``{"w", "b", "beta"}`` (params) and
``{"u", "v"}`` (state) for a Residual chain, a tuple over flows of
``{"u", "w", "b"}`` for a Planar chain; the pseudo criterion stacks
``phi_num`` such trees on a leading axis; the charts are a tuple of
``{"w", "b"}`` (``SphereChartMLP``) or ``{"encoder": ..., "flow": ...}``
(``EncoderFlowChart``); PCRNet is ``{"feature": tuple of {"w", "b"},
"head": tuple of {"w", "b"}}``; the sliced zoo's nets are ``{"w", "b"}``
(the ASWD mapping, the DSWD transform net) and a tuple of them (the GSW
MLP), which the port keeps as the same trees of tensors. These helpers take those trees with NUMPY
leaves (callers apply ``np.asarray`` to the JAX leaves), so this module
needs no JAX.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..flows.actnorm import ActNorm
from ..flows.base import FlowChain
from ..flows.chart import EncoderFlowChart, SphereChartMLP
from ..flows.planar import PlanarFlow
from ..models.pcrnet import PCRNet


def _layers(flow: FlowChain):
    for block in flow.flows:
        yield from block.net.layers


def _flat(tree: Sequence[Sequence[dict]]):
    for block in tree:
        yield from block


def _assign(dst: torch.Tensor, src, name: str) -> None:
    val = torch.tensor(np.asarray(src), dtype=dst.dtype)
    if val.shape != dst.shape:
        raise ValueError(f"{name}: shape {tuple(val.shape)} != {tuple(dst.shape)}")
    dst.copy_(val)


@torch.no_grad()
def load_phi(flow: FlowChain, params, state) -> FlowChain:
    """Copy a Residual chain's ``(params, state)`` into ``flow`` in place;
    returns ``flow``."""
    layers = list(_layers(flow))
    p_flat, s_flat = list(_flat(params)), list(_flat(state))
    if not (len(layers) == len(p_flat) == len(s_flat)):
        raise ValueError(f"phi has {len(layers)} layers, the trees "
                         f"{len(p_flat)} and {len(s_flat)}")
    for layer, p, s in zip(layers, p_flat, s_flat):
        for name, src in (("w", p["w"]), ("b", p["b"]), ("beta", p["beta"]),
                          ("u", s["u"]), ("v", s["v"])):
            _assign(getattr(layer, name), src, name)
    return flow


@torch.no_grad()
def load_planar(flow: PlanarFlow, params) -> PlanarFlow:
    """Copy one planar flow's ``{"u", "w", "b"}`` in place."""
    for name in ("u", "w", "b"):
        _assign(getattr(flow, name), params[name], name)
    return flow


@torch.no_grad()
def load_actnorm(flow: ActNorm, params) -> ActNorm:
    """Copy one ActNorm's ``{"s", "t"}`` in place."""
    for name in ("s", "t"):
        _assign(getattr(flow, name), params[name], name)
    return flow


def _index(tree, i: int):
    """The i-th slice of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return np.asarray(tree)[i]


def load_pseudo_phis(phis: Sequence[FlowChain], params, state) -> None:
    """Copy the pseudo criterion's stacked ensemble (leading ``phi_num``
    axis on every leaf) into ``phis``, flow i from slice i; Residual or
    Planar chains."""
    for i, phi in enumerate(phis):
        p_i, s_i = _index(params, i), _index(state, i)
        if isinstance(phi.flows[0], PlanarFlow):
            for block, p in zip(phi.flows, p_i):
                load_planar(block, p)
        else:
            load_phi(phi, p_i, s_i)


def _chart_pairs(chart, params):
    """(parameter, numpy leaf) of a chart, with the leaf's name."""
    dense = chart.layers if isinstance(chart, SphereChartMLP) else chart.encoder
    tree = params if isinstance(chart, SphereChartMLP) else params["encoder"]
    for layer, p in zip(dense, tree):
        yield layer.w, p["w"], "w"
        yield layer.b, p["b"], "b"
    if isinstance(chart, EncoderFlowChart):
        for layer, p in zip(_layers(chart.flow), _flat(params["flow"])):
            for name in ("w", "b", "beta"):
                yield getattr(layer, name), p[name], name


@torch.no_grad()
def load_chart(chart, params, state):
    """Copy a ``SphereChartMLP``'s or ``EncoderFlowChart``'s JAX
    ``(params, state)`` into ``chart`` in place; returns ``chart``."""
    for dst, src, name in _chart_pairs(chart, params):
        _assign(dst, src, name)
    if isinstance(chart, EncoderFlowChart):
        for layer, s in zip(_layers(chart.flow), _flat(state["flow"])):
            for name in ("u", "v"):
                _assign(getattr(layer, name), s[name], name)
    return chart


def _capturable(opt: torch.optim.Adam, p: torch.Tensor) -> bool:
    for group in opt.param_groups:
        if any(q is p for q in group["params"]):
            return bool(group["capturable"] or group["fused"])
    raise ValueError("the optimizer does not hold this parameter")


def _set_adam_entry(opt: torch.optim.Adam, p: torch.Tensor, step: float, m, v) -> None:
    """One parameter's Adam state from an optax count and moments. The step
    count is a float32 tensor on the parameter's device for a capturable
    (or fused) optimizer, on the CPU otherwise, as ``torch.optim.Adam``
    keeps it."""
    opt.state[p] = {
        "step": torch.tensor(step, dtype=torch.float32,
                             device=p.device if _capturable(opt, p) else "cpu"),
        "exp_avg": torch.tensor(np.asarray(m), dtype=p.dtype, device=p.device),
        "exp_avg_sq": torch.tensor(np.asarray(v), dtype=p.dtype, device=p.device)}


def load_max_ssw_adam_state(opt: torch.optim.Adam, chart, mu, nu, count: Any) -> None:
    """Set the max-SSW chart optimizer's state from an optax
    ``ScaleByAdamState`` (``mu``/``nu`` in the chart's params layout,
    ``count`` the step)."""
    step = float(np.asarray(count))
    for (p, m, _), (_, v, _) in zip(_chart_pairs(chart, mu), _chart_pairs(chart, nu)):
        _set_adam_entry(opt, p, step, m, v)


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
            _set_adam_entry(opt, getattr(layer, name), step, m[name], v[name])


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
            _set_adam_entry(opt, getattr(layer, name), step, mu[group][i][name],
                            nu[group][i][name])


def _zoo_linear(p, out_dim: int, in_dim: int, name: str, device) -> dict:
    layer = {}
    for key, shape in (("w", (out_dim, in_dim)), ("b", (out_dim,))):
        val = torch.tensor(np.asarray(p[key]), dtype=torch.float32, device=device)
        if tuple(val.shape) != shape:
            raise ValueError(f"{name}.{key}: shape {tuple(val.shape)} != {shape}")
        layer[key] = val
    return layer


def load_mapping(params, dim: int = 3, device: str | torch.device = "cpu") -> dict:
    """The JAX ``init_mapping`` (ASWD) or ``init_transform_net`` (DSWD)
    tree ``{"w" (dim, dim), "b" (dim,)}`` as the port's tree of tensors."""
    return _zoo_linear(params, dim, dim, "mapping", device)


def load_gsw_mlp(params, din: int = 3, dout: int = 10, num_filters: int = 32,
                 depth: int = 3, device: str | torch.device = "cpu") -> tuple:
    """The JAX ``init_gsw_mlp`` tree (a tuple of ``{"w" (out, in), "b"
    (out,)}``) as the port's tuple of tensor dicts."""
    widths = [din] + [num_filters] * depth + [dout]
    if len(params) != len(widths) - 1:
        raise ValueError(f"gsw mlp: {len(params)} layers, expected {len(widths) - 1}")
    return tuple(_zoo_linear(p, widths[i + 1], widths[i], f"gsw_mlp[{i}]", device)
                 for i, p in enumerate(params))
