"""Pseudo-max SHWD: an ensemble of frozen random flows, no inner ascent.

Counterpart of ``shwd_tpu/losses/pseudo.py``: ``phi_num`` random flows
drawn once and never trained (no ascent, no power iteration); each
flow's value is its transport value of the whole batch (after the batch
reduction), and the values combine by max, mean or softmax weights. The
returned sphere clouds are the argmax flow's under 'max' and the last
flow's otherwise.

The transport runs once per flow: on the card the default 'sinkhorn'
solver launches the fused kernel ``phi_num`` times per call. Stacking
the flows into one launch would mix their batches in the CPU path's
batch-global eps0 and gains nothing on the card (2 x 128 items are two
waves of the kernel's one-CTA-per-item grid).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.spherical import stiefel_frames
from ..parallel.mesh import all_reduce
from .transport import TransportConfig, make_transport

COMBINES = ("max", "mean", "softmax")


@dataclasses.dataclass(frozen=True)
class PseudoSHWDConfig:
    transport: TransportConfig = TransportConfig(cost="lp", p=2.0)
    phi_num: int = 2
    combine: str = "max"        # one of COMBINES


@dataclasses.dataclass
class PseudoSHWDState:
    """The frozen flows, and the generator that draws the frames of an
    'ssw' transport (one set per call, shared by the flows)."""
    phis: nn.ModuleList
    generator: torch.Generator | None = None


class PseudoSHWDLoss:
    def __init__(self, make_phi, cfg: PseudoSHWDConfig = PseudoSHWDConfig()):
        if cfg.combine not in COMBINES:
            raise ValueError(f"combine must be max|mean|softmax, got {cfg.combine!r}")
        self.make_phi = make_phi
        self.cfg = cfg
        self.transport = make_transport(cfg.transport)

    def init(self, generator: torch.Generator) -> PseudoSHWDState:
        """``phi_num`` flows drawn from ``generator``."""
        phis = nn.ModuleList(self.make_phi(generator)
                             for _ in range(self.cfg.phi_num)).requires_grad_(False)
        return PseudoSHWDState(phis=phis, generator=generator)

    def apply(self, state: PseudoSHWDState, x: torch.Tensor, y: torch.Tensor,
              train: bool = True):
        """Returns ((value, sphere_x, sphere_y), state); ``train`` changes
        nothing (no flow is trained). Gradients reach x and y."""
        tp = self.cfg.transport
        frames = None
        if tp.solver == "ssw":
            frames = stiefel_frames(state.generator, tp.num_projections,
                                    x.shape[-1], device=x.device)
        n = x.shape[-2]
        vals, sxs, sys = [], [], []
        for phi in state.phis:
            # one pass over both clouds: phi is per-point, the split is exact
            s = phi(torch.cat([x, y], dim=-2))
            sx, sy = s[..., :n, :], s[..., n:, :]
            vals.append(self.transport(sx, sy, frames=frames))
            sxs.append(sx)
            sys.append(sy)
        # a data-parallel fit combines each flow's value over the whole batch
        vals = all_reduce(torch.stack(vals), "sum" if tp.reduce == "sum" else "mean")
        c = self.cfg.combine
        if c == "max":
            value = torch.max(vals)
            # picked on the device: no host sync
            idx = torch.argmax(vals).reshape(1)
            sx = torch.index_select(torch.stack(sxs), 0, idx)[0]
            sy = torch.index_select(torch.stack(sys), 0, idx)[0]
            return (value, sx, sy), state
        if c == "mean":
            value = torch.mean(vals)
        else:
            value = torch.sum(torch.softmax(vals, dim=0) * vals)
        return (value, sxs[-1], sys[-1]), state
