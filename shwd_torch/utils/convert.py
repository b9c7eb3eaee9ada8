"""Move phi, chart and PCRNet weights and Adam states between the port
and the JAX package's layout, both ways.

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
needs no JAX. The ``*_tree`` functions are the loaders' inverses, and
``export_state``/``load_state`` move a whole trainer state through one
flat ``{path: array}`` dict, the key layout of ``tools/init_states_jax.npz``
(a path is the tree's keys and indices joined by ``/``; ``stored_tree``
reads it back into nested trees).
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


# -- the port's state in the JAX layout ----------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (on the CPU ``.numpy()`` would share the tensor's memory)."""
    return np.array(t.detach().cpu().numpy(), copy=True)


def chart_tree(chart):
    """A ``SphereChartMLP``'s or ``EncoderFlowChart``'s params in the JAX
    layout, as numpy copies (the inverse of ``load_chart``'s params)."""
    dense = chart.layers if isinstance(chart, SphereChartMLP) else chart.encoder
    layers = tuple({"w": _np(layer.w), "b": _np(layer.b)} for layer in dense)
    if isinstance(chart, SphereChartMLP):
        return layers
    flow = tuple(tuple({k: _np(getattr(layer, k)) for k in ("w", "b", "beta")}
                       for layer in block.net.layers) for block in chart.flow.flows)
    return {"encoder": layers, "flow": flow}


def chart_state_tree(chart):
    """A chart's JAX state: ``{}`` for ``SphereChartMLP``, the flow's
    spectral vectors for ``EncoderFlowChart``."""
    if isinstance(chart, SphereChartMLP):
        return {}
    return {"flow": tuple(tuple({k: _np(getattr(layer, k)) for k in ("u", "v")}
                                for layer in block.net.layers)
                          for block in chart.flow.flows)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return tuple(_stack(list(t)) for t in zip(*trees))
    return np.stack(trees)


def pseudo_phis_tree(phis: Sequence[FlowChain]):
    """The pseudo criterion's frozen flows as the JAX package's stacked
    ``(params, state)`` (leading ``phi_num`` axis on every leaf; the
    inverse of ``load_pseudo_phis``)."""
    if isinstance(phis[0].flows[0], PlanarFlow):
        params = [tuple({k: _np(getattr(f, k)) for k in ("u", "w", "b")} for f in phi.flows)
                  for phi in phis]
        return _stack(params), tuple({} for _ in phis[0].flows)
    trees = [phi_tree(phi) for phi in phis]     # np.stack copies the leaves
    return _stack([p for p, _ in trees]), _stack([s for _, s in trees])


def _adam_leaves(opt: torch.optim.Adam, params):
    """(mu, nu, count) of ``params``: the optax ``ScaleByAdamState``
    fields as lists in the parameters' order, zeros and count 0 where
    Adam has made no state yet."""
    counts, mu, nu = set(), [], []
    for p in params:
        st = opt.state.get(p)
        if st:
            counts.add(int(float(st["step"])))
            mu.append(_np(st["exp_avg"]))
            nu.append(_np(st["exp_avg_sq"]))
        else:
            counts.add(0)
            mu.append(np.zeros(tuple(p.shape), np.float32))
            nu.append(np.zeros(tuple(p.shape), np.float32))
    if len(counts) != 1:
        raise ValueError(f"the optimizer's parameters sit at different steps {sorted(counts)}")
    return mu, nu, np.asarray(counts.pop(), np.int32)


def pcrnet_adam_tree(opt: torch.optim.Adam, model: PCRNet):
    """(mu, nu, count) of the model optimizer in PCRNet's JAX layout (the
    inverse of ``load_pcrnet_adam_state``)."""
    layers = list(_pcrnet_layers(model))
    mu, nu, count = _adam_leaves(opt, [getattr(layer, n) for layer, _, _ in layers
                                       for n in ("w", "b")])

    def tree(leaves):
        it = iter(leaves)
        out = {"feature": [], "head": []}
        for _, group, _ in layers:
            out[group].append({n: next(it) for n in ("w", "b")})
        return {k: tuple(v) for k, v in out.items()}
    return tree(mu), tree(nu), count


def adam_tree(opt: torch.optim.Adam, flow: FlowChain):
    """(mu, nu, count) of phi's optimizer in the Residual chain's params
    layout (the inverse of ``load_adam_state``)."""
    names = ("w", "b", "beta")
    params = [getattr(layer, n) for layer in _layers(flow) for n in names]
    mu, nu, count = _adam_leaves(opt, params)

    def tree(leaves):
        it = iter(leaves)
        return tuple(tuple({n: next(it) for n in names} for _ in block.net.layers)
                     for block in flow.flows)
    return tree(mu), tree(nu), count


def max_ssw_adam_tree(opt: torch.optim.Adam, chart):
    """(mu, nu, count) of the chart's optimizer in the chart's params
    layout (the inverse of ``load_max_ssw_adam_state``)."""
    template = chart_tree(chart)
    mu, nu, count = _adam_leaves(opt, [p for p, _, _ in _chart_pairs(chart, template)])
    dense = template if isinstance(chart, SphereChartMLP) else template["encoder"]

    def tree(leaves):
        # _chart_pairs' order: each dense layer's w, b, then each flow
        # layer's w, b, beta
        it = iter(leaves)
        enc = tuple({n: next(it) for n in ("w", "b")} for _ in dense)
        if isinstance(chart, SphereChartMLP):
            return enc
        return {"encoder": enc,
                "flow": tuple(tuple({n: next(it) for n in ("w", "b", "beta")} for _ in block)
                              for block in template["flow"])}
    return tree(mu), tree(nu), count


def flatten_tree(tree, prefix: str) -> dict:
    """``{prefix/path: numpy copy of the leaf}`` of a tree of dicts, tuples
    and lists (dict keys in sorted order, as JAX flattens them); the key
    layout of ``tests/write_init_states.py::flatten``. An empty dict or
    tuple has no leaves."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.array(tree)    # a copy: CPU trees share the tensors' memory
    return out


def stored_tree(data, prefix: str):
    """The tree stored under ``prefix/`` in a flat ``{path: array}`` dict
    or npz (``flatten_tree``'s layout): a node whose keys are all indices
    is a tuple; () where nothing is stored (a chart without state)."""
    root: dict = {}
    keys = data.files if hasattr(data, "files") else list(data)
    for key in keys:
        if key.startswith(prefix + "/"):
            *parts, leaf = key[len(prefix) + 1:].split("/")
            node = root
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = data[key]

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return tuple(build(node[k]) for k in sorted(node, key=int))
        return {k: build(v) for k, v in node.items()}
    return build(root)


def _adam_dict(mu, nu, count) -> dict:
    return {"count": count, "mu": mu, "nu": nu}


def export_state(trainer, state) -> dict:
    """A trainer state (``shwd_torch.train.TrainState``) as one flat
    ``{path: numpy array}`` dict in the JAX layout, copies throughout:

      - ``pcrnet/...``: PCRNet's params (``pcrnet_tree``);
      - ``pcrnet_adam/{count,mu/...,nu/...}``: its Adam as optax's
        ``ScaleByAdamState`` (count int32; zeros at count 0);
      - ``crit/phi_params/...``, ``crit/phi_state/...``: SHWD's phi, the
        pseudo criterion's stacked frozen flows, or max-SSW's chart;
      - ``crit/adam/...``: phi's or the chart's Adam (SHWD, max-SSW);
      - ``crit/lam`` (f32) and ``crit/strikes`` (int32): SHWD's scalars;
      - ``epoch`` (int32): epochs done.

    ``load_state`` reads it back; ``stored_tree`` gives any subtree."""
    out = flatten_tree(pcrnet_tree(state.model), "pcrnet")
    out.update(flatten_tree(_adam_dict(*pcrnet_adam_tree(state.opt, state.model)),
                            "pcrnet_adam"))
    crit, name = state.crit_state, trainer.cfg.criterion
    if name in ("w_cos", "w1_cos"):
        params, fstate = phi_tree(crit.phi)
        out.update(flatten_tree(_adam_dict(*adam_tree(crit.opt, crit.phi)), "crit/adam"))
        out["crit/lam"] = np.asarray(_np(crit.lam), np.float32)
        out["crit/strikes"] = np.asarray(crit.strikes, np.int32)
    elif name == "max_ssw":
        params, fstate = chart_tree(crit.phi), chart_state_tree(crit.phi)
        out.update(flatten_tree(_adam_dict(*max_ssw_adam_tree(crit.opt, crit.phi)),
                                "crit/adam"))
    elif name == "pseudo_w_cos":
        params, fstate = pseudo_phis_tree(crit.phis)
    else:
        params, fstate = (), ()
    out.update(flatten_tree(params, "crit/phi_params"))
    out.update(flatten_tree(fstate, "crit/phi_state"))
    out["epoch"] = np.asarray(state.epoch, np.int32)
    return out


def _load_adam(data, prefix: str, opt: torch.optim.Adam, load) -> None:
    """Adam's state from ``prefix/{count,mu,nu}``; at count 0 none, as a
    fresh optimizer has (its first step makes it)."""
    count = int(data[f"{prefix}/count"])
    if count == 0:
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state.pop(p, None)
        return
    load(stored_tree(data, f"{prefix}/mu"), stored_tree(data, f"{prefix}/nu"), count)


def load_state(trainer, state, data):
    """Copy an ``export_state`` dict (or its npz) into ``state`` in place;
    returns ``state``."""
    load_pcrnet(state.model, stored_tree(data, "pcrnet"))
    _load_adam(data, "pcrnet_adam", state.opt, lambda mu, nu, count:
               load_pcrnet_adam_state(state.opt, state.model, mu, nu, count))
    crit, name = state.crit_state, trainer.cfg.criterion
    params = stored_tree(data, "crit/phi_params")
    fstate = stored_tree(data, "crit/phi_state")
    if name in ("w_cos", "w1_cos"):
        load_phi(crit.phi, params, fstate)
        _load_adam(data, "crit/adam", crit.opt, lambda mu, nu, count:
                   load_adam_state(crit.opt, crit.phi, mu, nu, count))
        with torch.no_grad():
            crit.lam.copy_(torch.from_numpy(np.asarray(data["crit/lam"], np.float32)))
        crit.strikes = int(data["crit/strikes"])
    elif name == "max_ssw":
        load_chart(crit.phi, params, fstate or {})
        _load_adam(data, "crit/adam", crit.opt, lambda mu, nu, count:
                   load_max_ssw_adam_state(crit.opt, crit.phi, mu, nu, count))
    elif name == "pseudo_w_cos":
        load_pseudo_phis(crit.phis, params, fstate)
    state.epoch = int(data["epoch"])
    return state
