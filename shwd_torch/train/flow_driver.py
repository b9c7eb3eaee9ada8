"""Wasserstein gradient flow: deform a point cloud to minimise a distance.

Counterpart of ``shwd_tpu/train/flow_driver.py``: the evolving cloud's
coordinates are the parameters, Adam descends the chosen distance toward
a fixed target, and exact W2 (or, with ``eval_metric="cd"``, the Chamfer
distance) is recorded every ``eval_interval`` iterations. Every method of
the JAX package's zoo runs: SHWD and the sliced distances of
``losses/sliced_zoo.py``, the spherical SSW, Chamfer and the entropic W2.

The step runs on the device without host syncs. Before the timed window
``run_flow`` loads the path's kernels and runs one step on copies of the
state; each interval ends in ``torch.cuda.synchronize()``, so
``interval_seconds`` covers the steps and not the eval or any build.

Fused execution (the default): the JAX package scans ``eval_interval``
jitted steps as one program; here one step is captured as a CUDA graph
(that warm-up step is the capture's warm-up, on the capture's stream) and
replayed ``eval_interval`` times per interval, the learning-rate schedule
stepped between replays. On the CPU the same step function is called
directly. Every method is captured: the adversarial ones ascend with the
functional Adam of ``sliced_zoo.adversarial_maximize`` and write their
learned net back into the state's own tensors. Only SHWD on the host
``exact`` solver runs op by op; ``flow_path`` says which path a config
takes.

Spans (``utils.profiling``): ``flow.run`` around the call, and inside it
``flow.build`` (the method's state, phi's construction included, the
points and their optimiser), ``flow.capture`` (the warm-up step, its
seconds as ``warmup_s``, and the capture), one ``flow.interval`` per timed
interval (``interval_seconds`` reads them) and ``flow.eval`` (the host
copy and ``eval_fn``, at the start and after each interval). Inside the
captured step the points' backward and Adam step are the device marks
``backward`` and ``adam``; the graph's marks are collected after each
interval's sync.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import _kernels
from ..device import resolve_device
from ..flows import make_flow
from ..losses import sliced_zoo
from ..losses.shwd import SHWDConfig, SHWDLoss
from ..losses.transport import TransportConfig
from ..ops.chamfer import chamfer, chamfer_tiled
from ..ops.costs import cost_matrix
from ..ops.sinkhorn import emd2_approx
from ..ops.spherical import sliced_wasserstein_sphere
from ..utils import profiling
from ..utils.flops import flow_step_flops
from ..utils.graphs import StepGraph, step_generators
from ..utils.optim import init_adam_state, torch_adam


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    # SHWD | SWD | MSWD | SSWD | SSWD_W1 | ASWD | DSWD | CD | W2 |
    # GSWD_POLY | GSWD_POLY3 | MGSWD_POLY | GSWD_CIRC | MGSWD_CIRC |
    # GSW_NN | MGSW_NN
    method: str = "SHWD"
    num_iterations: int = 400
    eval_interval: int = 5
    lr: float = 0.01
    num_projections: int = 100
    # SHWD knobs
    shwd_layers: int = 5
    shwd_lam: float = 0.1
    shwd_max_iter: int = 1
    shwd_phi_lr: float = 0.001
    shwd_phi_wd: float = 0.1
    shwd_solver: str = "sinkhorn"  # EMD surrogate used inside SHWD
    shwd_eps: float = 1e-5
    shwd_num_iters: int = 150
    shwd_num_scales: int = 10
    # hybrid dual warm-up depth: the auction makes the permutation exact
    # regardless, so this schedule only trades Sinkhorn time for sweeps
    hybrid_warmup_iters: int = 40
    hybrid_warmup_scales: int = 8
    eval_metric: str = "w2"        # 'w2' exact EMD | 'cd' chamfer
    # cosine-decay the point LR to lr * lr_decay_alpha over the run
    # (1.0 = constant LR)
    lr_decay_alpha: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class FlowResult:
    clouds: np.ndarray             # final evolved cloud
    eval_values: np.ndarray        # metric every eval_interval iters
    eval_iters: np.ndarray
    interval_seconds: np.ndarray   # wall time per reporting interval
    steps_per_second: float
    # SHWD: one step's FLOPs by the analytic model at the run's points,
    # solver and depth (utils.flops.flow_step_flops); NaN for the methods
    # it does not model
    flops_per_step: float = float("nan")
    # 'fused' or 'per_step: <reason>' (flow_path), and the step graph's
    # StepGraph.stats() on the fused path
    path: str = "per_step"
    graph: Optional[dict] = None


# the CUDA kernels each SHWD solver's path may launch
_SOLVER_KERNELS = {"hybrid": ("emd2_warmup", "auction"), "auction": ("auction",),
                   "sinkhorn": ("sinkhorn_points",)}
_PLAIN = ("SWD", "MSWD", "SSWD", "SSWD_W1", "CD", "W2", "GSWD_POLY", "GSWD_POLY3",
          "MGSWD_POLY", "GSWD_CIRC", "MGSWD_CIRC")
# the methods that keep a learned net across steps
_STATEFUL = ("ASWD", "DSWD", "GSW_NN", "MGSW_NN")


def flow_path(cfg: "FlowConfig", fused: bool = True) -> str:
    """'fused' when ``run_flow`` replays a captured step for ``cfg``, else
    'per_step: <reason>'."""
    if not fused:
        return "per_step: fused=False"
    if cfg.method == "SHWD" and cfg.shwd_solver == "exact":
        return "per_step: the exact solver runs on the host"
    return "fused"


def path_kernels(cfg: FlowConfig) -> tuple[str, ...]:
    """The CUDA kernel sources a run of ``cfg`` may launch, the eval
    metric's included."""
    names = _SOLVER_KERNELS.get(cfg.shwd_solver, ()) if cfg.method == "SHWD" else ()
    return names + (("chamfer",) if cfg.eval_metric == "cd" else ())


def _make_point_opt(cfg: FlowConfig, points: torch.Tensor):
    """Adam on the coordinates, with optax's cosine decay when asked
    (lr * ((1 - alpha) * (1 + cos(pi * t / T)) / 2 + alpha)). On the card
    the optimizer is capturable, and a decaying lr is a device tensor the
    scheduler fills between graph replays."""
    lr = cfg.lr
    if points.is_cuda and cfg.lr_decay_alpha < 1.0:
        lr = torch.full((), cfg.lr, dtype=torch.float32, device=points.device)
    opt = torch_adam([points], lr, 0.0, b1=0.9, b2=0.999)
    if cfg.lr_decay_alpha >= 1.0:
        return opt, None
    T, a = cfg.num_iterations, cfg.lr_decay_alpha

    def factor(t):
        t = min(t, T)
        return (1 - a) * 0.5 * (1 + math.cos(math.pi * t / T)) + a

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def _descend(points, state, loss) -> torch.Tensor:
    """One Adam step of the coordinates on ``loss``; no gradient reaches
    any learned net."""
    state["opt"].zero_grad(set_to_none=True)
    with profiling.device_span("backward"):
        loss.backward(inputs=[points])
    with profiling.device_span("adam"):
        state["opt"].step()
    if state.get("sched") is not None:
        state["sched"].step()
    return loss.detach()


def _plain_loss(cfg: FlowConfig, pts, target, gen, draws):
    """The stateless methods. ``draws`` (a dict) hands in the random
    directions the method would draw from ``gen``."""
    L, m = cfg.num_projections, cfg.method
    if m == "SWD":
        return sliced_zoo.sliced_wasserstein_distance(gen, pts, target, L, **draws)
    if m == "MSWD":
        return sliced_zoo.max_sliced_wasserstein_distance(gen, pts, target, **draws)
    if m in ("SSWD", "SSWD_W1"):
        return sliced_wasserstein_sphere(gen, pts, target, L, p=2 if m == "SSWD" else 1,
                                         **draws)
    if m == "CD":
        return chamfer(pts[None], target[None])
    if m == "W2":
        # eps-scaled log-Sinkhorn towards the exact plan, the plan held
        # constant in the gradient (envelope)
        c = cost_matrix(pts[None], target[None], "lp", 2.0)
        return emd2_approx(c, eps=5e-3, num_iters=50, num_scales=4)[0]
    if m == "GSWD_POLY":
        return sliced_zoo.gswd_polynomial(gen, pts, target, L, degree=5, **draws)
    if m == "GSWD_POLY3":
        return sliced_zoo.gswd_polynomial3_2d(gen, pts, target, L, **draws)
    if m == "MGSWD_POLY":
        return sliced_zoo.max_gswd_polynomial(gen, pts, target, degree=3, **draws)
    if m == "GSWD_CIRC":
        return sliced_zoo.gswd_circular(gen, pts, target, L, **draws)
    if m == "MGSWD_CIRC":
        return sliced_zoo.max_gswd_circular(gen, pts, target, **draws)
    raise ValueError(f"unknown flow method {m!r}")


def _stateful_init(cfg: FlowConfig, gen):
    if cfg.method == "ASWD":
        return sliced_zoo.init_mapping(gen, 3)
    if cfg.method == "DSWD":
        return sliced_zoo.init_transform_net(gen, 3)
    return sliced_zoo.init_gsw_mlp(gen, 3)


def _stateful_loss(cfg: FlowConfig, pts, target, gen, phi, draws):
    """(loss, new phi) of the methods with a learned net; an inner Adam
    ascent from zero moments runs in every step (not GSW_NN)."""
    L, m = cfg.num_projections, cfg.method
    if m == "ASWD":
        return sliced_zoo.augmented_sliced_wasserstein_distance(
            gen, pts, target, phi, num_projections=L, max_iter=10,
            lam=0.05 / torch.mean(torch.abs(target)), **draws)
    if m == "DSWD":
        return sliced_zoo.distributional_sliced_wasserstein_distance(
            gen, pts, target, phi, num_projections=L, max_iter=10, **draws)
    if m == "GSW_NN":
        return sliced_zoo.gsw_nn(pts, target, phi), phi
    return sliced_zoo.max_gsw_nn(pts, target, phi, max_iter=10)


def _make_loss_step(cfg: FlowConfig, device: torch.device):
    """Returns (init_state, step(points, target, state, draws=None) -> loss).

    ``init_state(generator, phi=None)`` builds the method's state: the
    generator every draw comes from, SHWD's criterion state or the learned
    net of ASWD, DSWD, GSW_NN and MGSW_NN (``phi`` replaces the fresh one,
    e.g. converted JAX weights). ``step`` updates the state and ``points``
    in place and returns the loss tensor (not synced to the host).
    ``draws`` hands in the step's random directions by name (tests).
    """
    if cfg.method == "SHWD":
        hybrid = cfg.shwd_solver == "hybrid"
        crit = SHWDLoss(
            lambda g: make_flow("Residual", cfg.shwd_layers, generator=g).to(device),
            SHWDConfig(
                transport=TransportConfig(
                    cost="lp", p=2.0, solver=cfg.shwd_solver, eps=cfg.shwd_eps,
                    num_iters=cfg.hybrid_warmup_iters if hybrid else cfg.shwd_num_iters,
                    num_scales=cfg.hybrid_warmup_scales if hybrid else cfg.shwd_num_scales,
                    num_projections=cfg.num_projections),
                max_iter=cfg.shwd_max_iter, lam=cfg.shwd_lam,
                phi_lr=cfg.shwd_phi_lr, phi_weight_decay=cfg.shwd_phi_wd))

        def init_state(generator, phi=None):
            return {"gen": generator, "crit": crit.init(generator, phi)}

        def step(points, target, state, draws=None):
            (w, _, _), state["crit"] = crit.apply(state["crit"], points[None],
                                                  target[None], train=True)
            return _descend(points, state, w)

        return init_state, step

    if cfg.method in _STATEFUL:
        def init_state(generator, phi=None):
            return {"gen": generator,
                    "phi": _stateful_init(cfg, generator) if phi is None else phi}

        def step(points, target, state, draws=None):
            loss, phi = _stateful_loss(cfg, points, target, state["gen"], state["phi"],
                                       draws or {})
            if phi is not state["phi"]:
                # in place: a replay reads and writes the same buffers
                with torch.no_grad():
                    for old, new in zip(pytree.tree_leaves(state["phi"]),
                                        pytree.tree_leaves(phi)):
                        old.copy_(new)
            return _descend(points, state, loss)

        return init_state, step

    if cfg.method not in _PLAIN:
        raise ValueError(f"unknown flow method {cfg.method!r}")

    def init_state(generator, phi=None):
        return {"gen": generator}

    def step(points, target, state, draws=None):
        loss = _plain_loss(cfg, points, target, state["gen"], draws or {})
        return _descend(points, state, loss)

    return init_state, step


def step_flops(cfg: FlowConfig, n_points: int) -> float:
    """One SHWD step's FLOPs by ``utils.flops.flow_step_flops`` at
    ``n_points``, the solver's dual iterations and the inner steps; NaN
    for the other methods."""
    if cfg.method != "SHWD":
        return float("nan")
    hybrid = cfg.shwd_solver == "hybrid"
    return flow_step_flops(
        n_points, layers=cfg.shwd_layers, solver=cfg.shwd_solver,
        max_iter=cfg.shwd_max_iter,
        sink_iters=cfg.hybrid_warmup_iters if hybrid else cfg.shwd_num_iters,
        sink_scales=cfg.hybrid_warmup_scales if hybrid else cfg.shwd_num_scales,
        num_projections=cfg.num_projections)


def _warm_up(cfg: FlowConfig, step, state, points, target, dev) -> float:
    """Build and load the path's kernels, then run one step on copies of
    the points, the method's state and the point optimiser, restoring the
    generator afterwards: the run's trajectory is the one it would be
    without this. Returns its seconds."""
    t0 = time.perf_counter()
    if dev.type == "cuda":
        names = path_kernels(cfg)
        _kernels.build_all(names)
        for name in names:
            _kernels.load(name)
    gen = state["gen"]
    saved = gen.get_state()
    w_points = points.detach().clone().requires_grad_(True)
    # the generator is shared, not copied: its state is restored below
    w_state = copy.deepcopy({k: v for k, v in state.items() if k not in ("opt", "sched")},
                            {id(gen): gen})
    w_state["opt"], w_state["sched"] = _make_point_opt(cfg, w_points)
    step(w_points, target, w_state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gen.set_state(saved)
    return time.perf_counter() - t0


def _step_graph(cfg, step, state, points, target, dev):
    """The flow step as a ``StepGraph`` (no static inputs: the points and
    the state are updated in place) and the warm-up step's seconds. The
    captured step leaves the schedule to the caller. On the card the
    warm-up is ``_warm_up`` on the capture's stream, and the graph is
    captured here, before any timed interval."""
    for opt in (state["opt"], getattr(state.get("crit"), "opt", None)):
        if opt is not None and dev.type == "cuda":
            init_adam_state(opt)
    unscheduled = {**state, "sched": None}
    seconds = []

    def fn():
        return step(points, target, unscheduled)

    def warmup():
        seconds.append(_warm_up(cfg, step, state, points, target, dev))

    name = f"flow step of {cfg.method}" + (f"/{cfg.shwd_solver}" if cfg.method == "SHWD"
                                           else "")
    graph = StepGraph(name, fn, (), device=dev, warmup=warmup,
                      generators=step_generators(state))
    if dev.type == "cuda":
        graph.capture()
    else:
        warmup()
    return graph, seconds[0]


def run_flow(source, target, cfg: FlowConfig,
             eval_fn: Optional[Callable] = None, verbose: bool = False,
             device: str | torch.device | None = None,
             fused: bool = True) -> FlowResult:
    """Evolve ``source`` toward ``target``; record the eval metric per
    interval. Runs on the card unless ``device="cpu"``. ``fused`` replays
    a captured step where ``flow_path`` allows it; False dispatches every
    step op by op.

    ``eval_fn(points, target) -> float`` (numpy arguments) defaults to exact
    W2 (the scipy assignment on the host), or for ``eval_metric="cd"`` to
    the Chamfer distance on the device. The metric needs no gradient, so it
    is the forward-only tiled Chamfer (the CUDA kernel on the card).
    """
    with profiling.span("flow.run", method=cfg.method):
        return _run_flow(source, target, cfg, eval_fn, verbose,
                         resolve_device(device), fused)


def _run_flow(source, target, cfg, eval_fn, verbose, dev, fused) -> FlowResult:
    if eval_fn is None:
        if cfg.eval_metric == "cd":
            def eval_fn(p, t):
                p, t = (torch.as_tensor(a, dtype=torch.float32, device=dev)[None]
                        for a in (p, t))
                return float(chamfer_tiled(p, t))
        elif cfg.eval_metric == "w2":
            from ..ops.emd_exact import w2_exact
            eval_fn = w2_exact
        else:
            raise ValueError(f"unknown eval metric {cfg.eval_metric!r}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host(t):
        return t.detach().cpu().numpy()

    with profiling.span("flow.build"):
        init_state, step = _make_loss_step(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        state = init_state(gen)
        points = torch.as_tensor(np.asarray(source), dtype=torch.float32,
                                 device=dev).clone().requires_grad_(True)
        tgt = torch.as_tensor(np.asarray(target), dtype=torch.float32, device=dev)
        state["opt"], state["sched"] = _make_point_opt(cfg, points)
        target_np = host(tgt)
    with profiling.span("flow.eval"):
        evals = [eval_fn(host(points), target_np)]
    iters = [0]
    times = []
    path = flow_path(cfg, fused)
    graph = None
    # the warm-up step and, on the fused path, the capture
    with profiling.span("flow.capture") as capture:
        if path == "fused":
            graph, warmup_s = _step_graph(cfg, step, state, points, tgt, dev)
        else:
            warmup_s = _warm_up(cfg, step, state, points, tgt, dev)
        capture.attrs["warmup_s"] = warmup_s
    for it in range(cfg.num_iterations // cfg.eval_interval):
        sync()
        with profiling.span("flow.interval") as interval:
            for _ in range(cfg.eval_interval):
                if graph is None:
                    step(points, tgt, state)
                    continue
                graph()
                if state["sched"] is not None:
                    state["sched"].step()
            sync()
        times.append(interval.seconds)
        if graph is not None:
            graph.collect()
        with profiling.span("flow.eval"):
            metric = eval_fn(host(points), target_np)
        evals.append(metric)
        iters.append((it + 1) * cfg.eval_interval)
        if verbose:
            print(f"iter {iters[-1]:5d}  {cfg.eval_metric}={metric:.6f}  "
                  f"interval={times[-1] * 1000:.1f} ms")

    times_arr = np.asarray(times)
    return FlowResult(
        clouds=host(points),
        eval_values=np.asarray(evals),
        eval_iters=np.asarray(iters),
        interval_seconds=times_arr,
        steps_per_second=cfg.eval_interval / max(float(times_arr.mean()), 1e-12)
        if len(times) else float("nan"),
        flops_per_step=step_flops(cfg, points.shape[0]),
        path=path,
        graph=None if graph is None else graph.stats(),
    )
