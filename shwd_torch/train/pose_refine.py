"""Pose refinement: per-object SE(3) poses fitted by gradient descent.

Counterpart of ``shwd_tpu/train/pose_refine.py``: given B (source, target)
cloud pairs, Adam optimises each object's raw 7-vector (quaternion and
translation, the parameterisation PCRNet regresses) against a
differentiable cloud distance. Objects are independent: the objective is
the sum over the batch, so gradients never mix.

Losses: ``"cd"`` (Chamfer both ways), ``"ssw"`` (spherical sliced
Wasserstein on fresh frames each step) and ``"sinkhorn"`` (``emd2_points``:
on the card the fused Sinkhorn kernel K3 with its envelope gradient, one
launch per step and one for the final per-object loss).

``refine_model_output`` seeds the poses from a registration model's
estimate (coarse network, fine refinement). The step loop runs on the
device without host syncs; the loss trace stays on the device.

Fused execution (the default), the JAX package's one jitted program (a
``lax.scan`` over Adam steps): the refine step (objective, backward, the
Adam step on ``raw``, the loss written into a ``(num_steps,)`` trace at an
index held in a device counter) is captured once as a CUDA graph and
replayed ``num_steps`` times, the final per-object objective as a second
graph (``utils.graphs.StepGraph``). The graphs, their static inputs and
their state are cached across calls by configuration and shape, as
``jax.jit`` caches its programs; each call copies its clouds in, resets
``raw``, the Adam state and the counter in place, and returns copies. On
the CPU the same step functions are called directly on the same buffers.
``fused=False`` runs the same steps op by op on fresh buffers.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops.chamfer import chamfer_directional
from ..ops.quaternion import (
    create_pose_7d, pose_translation, quat_to_matrix, quaternion_transform,
)
from ..ops.sinkhorn_fused import emd2_points
from ..ops.spherical import sliced_cost_sphere, stiefel_frames
from ..parallel.mesh import active_group
from ..utils.graphs import StepGraph, preserved
from ..utils.optim import init_adam_state, torch_adam


@dataclasses.dataclass(frozen=True)
class PoseRefineConfig:
    loss: str = "cd"            # 'cd' | 'ssw' | 'sinkhorn'
    num_steps: int = 100
    lr: float = 0.01
    p: float = 2.0
    num_projections: int = 64   # ssw
    eps: float = 5e-3           # sinkhorn
    num_iters: int = 30
    num_scales: int = 3


class PoseRefineResult(NamedTuple):
    pose_7d: torch.Tensor          # (B, 7) normalised quaternion + translation
    est_R: torch.Tensor            # (B, 3, 3)
    est_t: torch.Tensor            # (B, 3)
    losses: torch.Tensor           # (num_steps,) summed objective trace
    per_object_loss: torch.Tensor  # (B,) final per-object loss


def _per_object_loss(cfg: PoseRefineConfig, moved, target, generator, frames=None):
    """(B,) loss of the moved clouds; ``frames`` (L, 3, 2) replaces the
    ``ssw`` draw."""
    if cfg.loss == "cd":
        return chamfer_directional(moved, target) + chamfer_directional(target, moved)
    if cfg.loss == "ssw":
        if frames is None:
            frames = stiefel_frames(generator, cfg.num_projections, moved.shape[-1],
                                    device=moved.device)
        return sliced_cost_sphere(moved, target, frames, p=cfg.p)
    if cfg.loss == "sinkhorn":
        return emd2_points(moved, target, "lp", cfg.p, eps=cfg.eps,
                           num_iters=cfg.num_iters, num_scales=cfg.num_scales)
    raise ValueError(f"unknown refine loss {cfg.loss!r}")


class _Refinement:
    """The buffers and state of one refinement shape: the static clouds (and
    the handed-in ``ssw`` frames), ``raw`` and its Adam, the loss trace and
    its device counter. ``step`` and ``final`` are what the graphs
    capture; the per-step path calls them directly."""

    def __init__(self, cfg: PoseRefineConfig, source, target, frames,
                 generator: Optional[torch.Generator]):
        dev, dtype = source.device, source.dtype
        self.cfg = cfg
        self.source = torch.empty_like(source)
        self.target = torch.empty_like(target)
        self.frames = None if frames is None else torch.empty_like(frames)
        self.generator = generator
        self.raw = torch.zeros(source.shape[0], 7, dtype=dtype,
                               device=dev).requires_grad_(True)
        # capturable on the card: the step count and bias corrections live there
        self.opt = init_adam_state(torch_adam([self.raw], cfg.lr))
        self.losses = torch.zeros(cfg.num_steps, dtype=dtype, device=dev)
        self.count = torch.zeros(1, dtype=torch.long, device=dev)
        self.graphs: Optional[tuple[StepGraph, StepGraph]] = None

    def load(self, source, target, frames, init_pose) -> None:
        """Copy a call's inputs in; ``raw`` to the initial pose (the
        identity when None), Adam's moments, its step and the counter to 0."""
        with torch.no_grad():
            self.source.copy_(source)
            self.target.copy_(target)
            if frames is not None:
                self.frames.copy_(frames)
            if init_pose is None:
                self.raw.zero_()
                self.raw[:, 0] = 1.0
            else:
                self.raw.copy_(init_pose)
            for state in self.opt.state.values():
                for t in state.values():
                    t.zero_()
            self.count.zero_()

    def _objective(self, raw, frames):
        moved = quaternion_transform(self.source, create_pose_7d(raw))
        per_obj = _per_object_loss(self.cfg, moved, self.target, self.generator, frames)
        return torch.sum(per_obj), per_obj

    def step(self) -> None:
        """One Adam step on ``raw``; the objective goes into the trace at the
        counter, which then moves on."""
        frames = None if self.frames is None else self.frames.index_select(0, self.count)[0]
        with torch.enable_grad():
            total, _ = self._objective(self.raw, frames)
            (grad,) = torch.autograd.grad(total, [self.raw])
        self.raw.grad = grad
        self.opt.step()
        self.losses.index_copy_(0, self.count, total.detach().reshape(1))
        self.count.add_(1)

    @torch.no_grad()
    def final(self):
        """The refined pose and each object's loss at it."""
        frames = None if self.frames is None else self.frames[self.cfg.num_steps]
        _, per_obj = self._objective(self.raw, frames)
        return create_pose_7d(self.raw), per_obj

    def result(self) -> PoseRefineResult:
        pose, per_obj = self.final()
        return _result(pose, self.losses, per_obj)

    def captured(self) -> tuple[StepGraph, StepGraph]:
        """The step and final graphs, made at the first call (captured at
        their first replay on the card). Each warm-up runs its function
        once on the real buffers and puts every tensor and the generator
        back."""
        if self.graphs is None:
            state = (self.raw, self.opt, self.losses, self.count, self.generator)

            def warm(fn):
                def warmup():
                    with preserved(*state):
                        fn()
                return warmup

            gens = [] if self.generator is None else [self.generator]
            shape = tuple(self.source.shape)
            self.graphs = tuple(
                StepGraph(f"refine {what} of {self.cfg.loss} at {shape}", fn, (),
                          device=self.source.device, warmup=warm(fn), generators=gens)
                for what, fn in (("step", self.step), ("final", self.final)))
        return self.graphs


def _result(pose, losses, per_obj) -> PoseRefineResult:
    return PoseRefineResult(pose_7d=pose, est_R=quat_to_matrix(pose[..., :4]),
                            est_t=pose_translation(pose), losses=losses,
                            per_object_loss=per_obj)


# the fused path's refinements by (config, shapes, dtype, device, frames'
# shape, the active data group), least recently used first
_CACHE: "collections.OrderedDict[tuple, _Refinement]" = collections.OrderedDict()
_CACHE_SIZE = 8


def clear_cache() -> None:
    """Drop every cached refinement, its graphs and their memory."""
    _CACHE.clear()


def cached_graphs() -> list[dict]:
    """``StepGraph.stats()`` of every cached graph, the step's before the
    final one's, least recently used refinement first."""
    return [g.stats() for r in _CACHE.values() if r.graphs for g in r.graphs]


def _cached(cfg, source, target, frames, needs_generator) -> _Refinement:
    key = (cfg, tuple(source.shape), tuple(target.shape), source.dtype, source.device,
           None if frames is None else tuple(frames.shape), active_group())
    ref = _CACHE.get(key)
    if ref is None:
        gen = torch.Generator(device=source.device) if needs_generator else None
        ref = _CACHE[key] = _Refinement(cfg, source, target, frames, gen)
        while len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    _CACHE.move_to_end(key)
    return ref


def refine_poses(source: torch.Tensor, target: torch.Tensor,
                 cfg: PoseRefineConfig = PoseRefineConfig(),
                 generator: Optional[torch.Generator] = None,
                 init_pose: Optional[torch.Tensor] = None,
                 frames: Optional[torch.Tensor] = None,
                 fused: bool = True) -> PoseRefineResult:
    """Optimise per-object poses aligning source -> target.

    source (B, N, 3), target (B, M, 3), on the card or the CPU.
    ``init_pose``: optional (B, 7) raw pose (e.g. PCRNet's output), the
    identity by default. ``generator`` draws the ``ssw`` frames (a fresh
    one seeded 0 on the clouds' device when not given); ``frames``
    (num_steps + 1, L, 3, 2) replaces those draws, the last for the final
    per-object loss. ``fused`` replays the cached graphs (see the module
    docstring); False runs every step op by op. Both give the same numbers.
    """
    if cfg.loss not in ("cd", "ssw", "sinkhorn"):
        raise ValueError(f"unknown refine loss {cfg.loss!r}")
    source, target = source.detach(), target.detach()
    draws = cfg.loss == "ssw" and frames is None
    if not fused:
        if generator is None and draws:
            generator = torch.Generator(device=source.device).manual_seed(0)
        ref = _Refinement(cfg, source, target, frames, generator)
        ref.load(source, target, frames, init_pose)
        for _ in range(cfg.num_steps):
            ref.step()
        return ref.result()
    ref = _cached(cfg, source, target, frames, draws)
    ref.load(source, target, frames, init_pose)
    if draws:
        if generator is None:
            ref.generator.manual_seed(0)
        else:
            ref.generator.set_state(generator.get_state())
    step, final = ref.captured()
    for _ in range(cfg.num_steps):
        step()
    pose, per_obj = final()
    if draws and generator is not None:
        # the caller's generator moves on as the per-step draws move it
        generator.set_state(ref.generator.get_state())
    # copies: the next call overwrites the graphs' buffers
    return _result(pose.clone(), ref.losses.clone(), per_obj.clone())


def refine_model_output(source: torch.Tensor, target: torch.Tensor,
                        est_R: torch.Tensor, est_t: torch.Tensor,
                        cfg: PoseRefineConfig = PoseRefineConfig(),
                        generator: Optional[torch.Generator] = None,
                        frames: Optional[torch.Tensor] = None,
                        fused: bool = True) -> PoseRefineResult:
    """Polish a learned registration estimate (coarse to fine).

    Takes PCRNet's est_R (B, 3, 3) and est_t (B, 1, 3) or (B, 3) and
    refines from there. The rotation becomes the initial quaternion through
    the JAX package's branchless form, clamps included (exact for rotations
    with trace > -1).
    """
    r = est_R.detach()
    t = est_t.detach().reshape(est_t.shape[0], 3)
    m00, m11, m22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    w = torch.sqrt(torch.clamp_min(1.0 + m00 + m11 + m22, 1e-12)) / 2.0
    den = torch.clamp_min(4.0 * w, 1e-8)
    x = (r[..., 2, 1] - r[..., 1, 2]) / den
    y = (r[..., 0, 2] - r[..., 2, 0]) / den
    z = (r[..., 1, 0] - r[..., 0, 1]) / den
    init = torch.cat([torch.stack([w, x, y, z], -1), t], dim=-1)
    return refine_poses(source, target, cfg, generator, init_pose=init, frames=frames,
                        fused=fused)
