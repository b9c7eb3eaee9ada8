"""Adversarial spherical sliced-Wasserstein loss (max-SSW).

Counterpart of ``shwd_tpu/losses/ssw_loss.py``:

    max_phi  sum_b SSW_p(phi(X_b), phi(Y_b))

phi is a sphere chart (``flows.chart``) or any flow. Per train call,
``max_iter`` Adam ascent steps on phi against the detached clouds (a sum
over the batch, not a mean; with ``minibatch > 0`` each step sees a subset
drawn without replacement), each followed by ``power_iter_per_step``
power iterations; then the final SSW sum, whose gradient reaches x and y.
Every step and the final solve draw fresh frames from the state's
generator (the JAX package's key splits).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..flows.base import Flow
from ..ops.spherical import sliced_cost_sphere, stiefel_frames
from ..parallel.mesh import group_rank, group_size, reduce_gradients
from ..utils.optim import torch_adam


@dataclasses.dataclass(frozen=True)
class MaxSSWConfig:
    num_projections: int = 100
    p: float = 2.0
    max_iter: int = 10
    phi_lr: float = 0.01
    phi_b1: float = 0.5
    phi_b2: float = 0.999
    minibatch: int = 0          # >0: each inner step sees a random subset
    power_iter_per_step: int = 1


@dataclasses.dataclass
class MaxSSWState:
    phi: Flow
    opt: torch.optim.Adam
    generator: torch.Generator | None = None


class MaxSSWLoss:
    """Usage:

        crit = MaxSSWLoss(lambda g: SphereChartMLP(generator=g), cfg)
        state = crit.init(torch.Generator(device).manual_seed(0))
        (ssw, sphere_x, sphere_y), state = crit.apply(state, x, y, train=True)

    ``draw`` is None except in tests: a callable ``draw(minibatch)`` ->
    (frames, indices or None) that replaces the generator's draws, so the
    JAX package's frames and subsets can be handed in.
    """

    def __init__(self, make_phi: Callable[[Optional[torch.Generator]], Flow],
                 cfg: MaxSSWConfig = MaxSSWConfig()):
        self.make_phi = make_phi
        self.cfg = cfg
        self.draw: Optional[Callable] = None

    def init(self, generator: torch.Generator, phi: Flow | None = None) -> MaxSSWState:
        """A fresh state; ``phi`` (e.g. converted weights) replaces the
        freshly drawn chart when given."""
        c = self.cfg
        phi = self.make_phi(generator) if phi is None else phi
        # Adam without weight decay (optax.adam)
        opt = torch_adam(phi.parameters(), c.phi_lr, 0.0, b1=c.phi_b1, b2=c.phi_b2)
        return MaxSSWState(phi=phi, opt=opt, generator=generator)

    def _draw(self, state: MaxSSWState, x: torch.Tensor, minibatch: int):
        if self.draw is not None:
            return self.draw(minibatch)
        frames = stiefel_frames(state.generator, self.cfg.num_projections,
                                x.shape[-1], device=x.device)
        idx = None
        if minibatch > 0:
            # a uniform subset without replacement, made on the device. In a
            # data-parallel fit the keys are drawn for the global batch on
            # every rank, and a rank keeps the picked rows it holds
            b = x.shape[0]
            keys = torch.rand(b * group_size(), generator=state.generator,
                              device=x.device)
            idx = torch.argsort(keys)[:minibatch]
            if group_size() > 1:
                lo = group_rank() * b
                idx = idx[(idx >= lo) & (idx < lo + b)] - lo
        return frames, idx

    def _ssw_sum(self, phi: Flow, x, y, frames):
        sx, sy = phi(x), phi(y)
        return torch.sum(sliced_cost_sphere(sx, sy, frames, p=self.cfg.p)), sx, sy

    def apply(self, state: MaxSSWState, x: torch.Tensor, y: torch.Tensor,
              train: bool = True):
        """x, y: (B, N, 3) (or one cloud (N, 3)). Returns
        ((ssw, sphere_x, sphere_y), state)."""
        cfg = self.cfg
        if x.ndim == 2:
            x, y = x[None], y[None]
        if train:
            xd, yd = x.detach(), y.detach()
            for _ in range(cfg.max_iter):
                frames, idx = self._draw(state, xd, cfg.minibatch)
                xi, yi = (xd, yd) if idx is None else (xd[idx], yd[idx])
                state.opt.zero_grad(set_to_none=True)
                (-self._ssw_sum(state.phi, xi, yi, frames)[0]).backward()
                # a data-parallel fit: the sum's gradient adds up over ranks
                reduce_gradients(state.phi.parameters(), "sum")
                state.opt.step()
                if cfg.power_iter_per_step > 0:
                    state.phi.update_state(cfg.power_iter_per_step)
        frames, _ = self._draw(state, x, 0)
        ssw, sx, sy = self._ssw_sum(state.phi, x, y, frames)
        return (ssw, sx, sy), state
