"""Wasserstein gradient flow: deform a point cloud to minimise a distance.

Counterpart of ``shwd_tpu/train/flow_driver.py`` for ``method="SHWD"``:
the evolving cloud's coordinates are the parameters, Adam descends SHWD
toward a fixed target, and exact W2 (or, with ``eval_metric="cd"``, the
Chamfer distance) is recorded every ``eval_interval`` iterations. The step runs on the device without host syncs; each interval
ends in ``torch.cuda.synchronize()`` so ``interval_seconds`` covers the
steps and not the eval.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..flows import make_flow
from ..losses.shwd import SHWDConfig, SHWDLoss
from ..losses.transport import TransportConfig
from ..ops.chamfer import chamfer_tiled


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    # the JAX package's method zoo; this port runs "SHWD"
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
    flops_per_step: float = float("nan")   # not counted by the port yet


def _make_point_opt(cfg: FlowConfig, points: torch.Tensor):
    """Adam on the coordinates, with optax's cosine decay when asked
    (lr * ((1 - alpha) * (1 + cos(pi * t / T)) / 2 + alpha))."""
    opt = torch.optim.Adam([points], lr=cfg.lr, betas=(0.9, 0.999))
    if cfg.lr_decay_alpha >= 1.0:
        return opt, None
    T, a = cfg.num_iterations, cfg.lr_decay_alpha

    def factor(t):
        t = min(t, T)
        return (1 - a) * 0.5 * (1 + math.cos(math.pi * t / T)) + a

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def _make_loss_step(cfg: FlowConfig, device: torch.device):
    """Returns (init_state, step(points, target, state) -> loss).

    ``init_state(generator, phi=None)`` builds the criterion state;
    ``step`` updates the criterion state and ``points`` in place and
    returns the loss tensor (not synced to the host).
    """
    if cfg.method != "SHWD":
        raise NotImplementedError(
            f"flow method {cfg.method!r} is ported in a later slice")
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
        return {"crit": crit.init(generator, phi)}

    def step(points, target, state):
        (w, _, _), state["crit"] = crit.apply(state["crit"], points[None],
                                              target[None], train=True)
        state["opt"].zero_grad(set_to_none=True)
        w.backward(inputs=[points])      # no gradient into phi's weights
        state["opt"].step()
        if state.get("sched") is not None:
            state["sched"].step()
        return w.detach()

    return init_state, step


def run_flow(source, target, cfg: FlowConfig,
             eval_fn: Optional[Callable] = None, verbose: bool = False,
             device: str | torch.device | None = None) -> FlowResult:
    """Evolve ``source`` toward ``target``; record the eval metric per
    interval. Runs on the card unless ``device="cpu"``.

    ``eval_fn(points, target) -> float`` (numpy arguments) defaults to exact
    W2 (the scipy assignment on the host), or for ``eval_metric="cd"`` to
    the Chamfer distance on the device. The metric needs no gradient, so it
    is the forward-only tiled Chamfer (the CUDA kernel on the card).
    """
    dev = resolve_device(device)
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

    init_state, step = _make_loss_step(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = init_state(gen)
    points = torch.as_tensor(np.asarray(source), dtype=torch.float32,
                             device=dev).clone().requires_grad_(True)
    tgt = torch.as_tensor(np.asarray(target), dtype=torch.float32, device=dev)
    state["opt"], state["sched"] = _make_point_opt(cfg, points)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host(t):
        return t.detach().cpu().numpy()

    target_np = host(tgt)
    evals = [eval_fn(host(points), target_np)]
    iters = [0]
    times = []
    for it in range(cfg.num_iterations // cfg.eval_interval):
        sync()
        t0 = time.perf_counter()
        for _ in range(cfg.eval_interval):
            step(points, tgt, state)
        sync()
        times.append(time.perf_counter() - t0)
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
    )
