"""The adversarial Sphere-Homeomorphic Wasserstein Distance (SHWD).

Counterpart of ``shwd_tpu/losses/shwd.py``:

    SHWD(X, Y) = max_phi  W_p(phi(X), phi(Y))
                 s.t. phi(X), phi(Y) ~ on S^2  (L1 sphere regularizer)

Per train call: ``max_iter`` inner ascent steps on phi against detached
clouds (Adam on phi, then a power iteration), then a final forward whose
gradient flows to X and Y. Options: ``lam_decay`` (lam *= decay after each
train call), ``early_stop_strikes`` (skip the inner steps after that many
strikes) and ``refresh`` (re-initialise phi every call).

State is explicit but mutable: ``SHWDState`` holds the phi module, its
optimizer, lam and the strike count; ``apply`` updates phi in place and
returns the state. Everything a train call changes is changed in place on
the device (phi, its Adam state with the step count, lam), so the call can
be recorded into a CUDA graph and replayed (``utils.graphs``). The strike
count stays on the host: it moves only between epochs, and it decides
whether a call runs the inner steps at all (``inner_gate``), so a graph is
captured per value of that gate. Inside a captured step, phi's passes
(``phi_forward``) and its inner update (``phi_update``: the objective's
backward, Adam and the power iteration) are device marks
(``utils.profiling.device_span``). On the hybrid solver the loss keeps the
solves of its last train call (``train_solves``): inside a captured step
they are the graph's own buffers, which every replay rewrites.
"""

from __future__ import annotations

import dataclasses

import torch

from ..flows.base import FlowChain
from ..ops.auction import hybrid_assignment_warm
from ..ops.costs import cost_matrix
from ..parallel.mesh import reduce_gradients
from ..utils.optim import torch_adam
from ..utils.profiling import device_span
from .transport import TransportConfig, make_transport, reduce_batch


@dataclasses.dataclass(frozen=True)
class SHWDConfig:
    transport: TransportConfig = TransportConfig(cost="lp", p=2.0)
    max_iter: int = 1
    lam: float = 0.1
    phi_lr: float = 1e-3
    phi_weight_decay: float = 0.0
    phi_b1: float = 0.9
    phi_b2: float = 0.999
    lam_decay: float = 1.0          # 0.999 reproduces the legacy decay variant
    early_stop_strikes: int = 0     # >0 enables early-stop gating
    refresh: bool = False
    power_iter_per_step: int = 1    # spectral-norm refresh cadence (0 = frozen)


@dataclasses.dataclass
class SHWDState:
    """What the criterion carries across calls. ``generator`` draws a
    fresh phi for ``refresh`` and the frames of every ``ssw`` solve (the
    JAX package's ``key``)."""
    phi: FlowChain
    opt: torch.optim.Adam
    lam: torch.Tensor               # 0-dim, on phi's device, decayed in place
    strikes: int = 0
    generator: torch.Generator | None = None


def inner_gate(cfg: SHWDConfig, strikes: int) -> bool:
    """Whether a train call runs the inner ascent steps: always, or, with
    ``early_stop_strikes``, while the strikes have not passed the limit."""
    return cfg.early_stop_strikes <= 0 or strikes <= cfg.early_stop_strikes


def sphere_regularizer(x: torch.Tensor) -> torch.Tensor:
    """sum | ||x|| - 1 | / (B * N)."""
    norms = torch.linalg.vector_norm(x, dim=-1)
    return torch.sum(torch.abs(norms - 1.0)) / norms.numel()


class SHWDLoss:
    """Callable criterion. Usage:

        crit = SHWDLoss(lambda g: make_flow("Residual", 3, generator=g), cfg)
        state = crit.init(torch.Generator(device).manual_seed(0))
        (loss, sphere_x, sphere_y), state = crit.apply(state, x, y, train=True)

    ``make_phi(generator)`` builds a freshly initialised phi.
    """

    def __init__(self, make_phi, cfg: SHWDConfig = SHWDConfig()):
        self.make_phi = make_phi
        self.cfg = cfg
        self.transport = make_transport(cfg.transport)
        # hybrid exact-EMD solver: the inner-ascent solve and the final
        # forward see the same clouds through phi one Adam step apart, so
        # the second solve warm-restarts from the first's matching + duals
        self._warm_hybrid = cfg.transport.solver == "hybrid"
        # the hybrid solves of the last train call, in order (the inner
        # ones, then the final one): dicts of ``assign`` (the permutation
        # the value was gathered at, (B, N) int32), ``unassigned`` (the
        # auction's matching, -1 where the sweep cap left a person),
        # ``sweeps`` (B,), ``prices`` (B, N), and ``x`` and ``y``, the
        # mapped clouds the solve's cost was built from, as that call
        # made them
        self.train_solves: list[dict] | None = None

    def _new_opt(self, phi: FlowChain) -> torch.optim.Adam:
        c = self.cfg
        return torch_adam(phi.parameters(), c.phi_lr, c.phi_weight_decay,
                          b1=c.phi_b1, b2=c.phi_b2)

    def init(self, generator: torch.Generator, phi: FlowChain | None = None
             ) -> SHWDState:
        """A fresh state; ``phi`` (e.g. converted weights) replaces the
        freshly drawn one when given."""
        phi = self.make_phi(generator) if phi is None else phi
        dev = next(phi.parameters()).device
        lam = torch.full((), self.cfg.lam, dtype=torch.float32, device=dev)
        return SHWDState(phi=phi, opt=self._new_opt(phi), lam=lam,
                         strikes=0, generator=generator)

    # -- internals ---------------------------------------------------------

    def _transport_warm(self, sx, sy, warm):
        """Hybrid transport with the warm matching threaded through.
        ``warm`` is None for a cold solve, else (assign, prices) of the
        previous solve. The value and reduction match make_transport's
        hybrid branch; the envelope gradient (plan/N) comes from
        differentiating the gather at the detached optimal permutation.

        The JAX package picks cold or warm on the device from
        ``any(assign0 >= 0)``. Here the caller knows: the first solve of a
        call is cold, every later one warm; so the branch is chosen at the
        call site and the step never syncs with the host. The warm matching
        and prices live only within a call: inside a captured step they are
        buffers of the graph's own pool, written by every replay. Returns
        (value, warm state for the next solve, the solve's record).
        """
        tp = self.cfg.transport
        batched = sx.ndim == 3
        if not batched:
            sx, sy = sx[None], sy[None]
        c = cost_matrix(sx, sy, tp.cost, tp.p)
        assign0, prices0 = warm if warm is not None else (None, None)
        assign_value, assign, prices, sweeps = hybrid_assignment_warm(
            c, assign0, prices0, use_warm=warm is not None, eps_final=1e-7,
            sink_eps=tp.eps, sink_iters=tp.num_iters,
            sink_scales=tp.num_scales)
        val = c.gather(-1, assign_value.long()[..., None])[..., 0].mean(-1)
        val = torch.clamp_min(val, 1e-30) ** (1.0 / tp.p)
        # unbatched input: drop the batch dim and skip the reduction, as the
        # transport path does (the JAX package keeps a (1,) result here)
        val = reduce_batch(val, tp.reduce) if batched else val[0]
        solve = {"assign": assign_value, "unassigned": assign, "sweeps": sweeps,
                 "prices": prices, "x": sx.detach(), "y": sy.detach()}
        return val, (assign, prices.detach()), solve

    def _flow_pair(self, phi, x, y):
        """One phi pass over both clouds (concatenated along the point
        axis); phi is per-point, so the split is exact."""
        n = x.shape[-2]
        with device_span("phi_forward"):
            s = phi(torch.cat([x, y], dim=-2))
        return s[..., :n, :], s[..., n:, :]

    def _inner_objective(self, phi, x, y, lam, warm, generator, solves):
        """phi's ascent objective lam * reg - W, and the new warm state; a
        hybrid solve's record is appended to ``solves``."""
        sx, sy = self._flow_pair(phi, x, y)
        if self._warm_hybrid:
            w, warm, solve = self._transport_warm(sx, sy, warm)
            solves.append(solve)
        else:
            w = self.transport(sx, sy, generator)
        reg = lam * (sphere_regularizer(sx) + sphere_regularizer(sy))
        return reg - w, warm

    def _inner_steps(self, state: SHWDState, x, y, solves):
        """max_iter adversarial Adam steps on phi against detached clouds."""
        xd, yd = x.detach(), y.detach()
        cfg = self.cfg
        warm = None
        for _ in range(cfg.max_iter):
            state.opt.zero_grad(set_to_none=True)
            obj, warm = self._inner_objective(state.phi, xd, yd, state.lam, warm,
                                              state.generator, solves)
            with device_span("phi_update"):
                obj.backward()
                # a data-parallel fit: the batch mean's gradient is the
                # ranks' mean, or phi drifts apart across ranks
                reduce_gradients(state.phi.parameters(), "mean")
                state.opt.step()
                if cfg.power_iter_per_step > 0:
                    state.phi.update_state(cfg.power_iter_per_step)
        return warm

    # -- public ------------------------------------------------------------

    def apply(self, state: SHWDState, x: torch.Tensor, y: torch.Tensor,
              train: bool = True):
        """Returns ((w, sphere_x, sphere_y), state)."""
        cfg = self.cfg
        warm = None
        solves = []
        if train:
            if cfg.refresh:
                state.phi = self.make_phi(state.generator)
                state.opt = self._new_opt(state.phi)
            # once the strike limit is hit the inner work is skipped, and
            # the final solve starts cold
            if inner_gate(cfg, state.strikes):
                warm = self._inner_steps(state, x, y, solves)
            if cfg.lam_decay != 1.0:
                state.lam.mul_(cfg.lam_decay)
        # final (undetached) forward: the gradient path to x and y
        sx, sy = self._flow_pair(state.phi, x, y)
        if self._warm_hybrid:
            w, _, solve = self._transport_warm(sx, sy, warm)
            if train:
                self.train_solves = solves + [solve]
        else:
            w = self.transport(sx, sy, state.generator)
        return (w, sx, sy), state

    def add_strike(self, state: SHWDState) -> SHWDState:
        """Count a non-improving epoch for the early-stop variant."""
        state.strikes += 1
        return state
