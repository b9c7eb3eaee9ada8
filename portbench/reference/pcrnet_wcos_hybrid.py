"""Plain reference of the ``pcrnet_wcos_hybrid`` configuration: PCRNet
trained with the adversarial SHWD criterion on the exact EMD, as the
upstream's ``train_W_COS.py`` computes it with ``ot.emd2``.

Everything but the transport is ``pcrnet_wcos``'s (the batches, PCRNet,
phi, its inner ascent and both Adams, imported from there). The transport
of a solve: the squared-distance cost of the two mapped clouds in float32;
scipy's optimal assignment on that cost built in float64 from the same
points; W = sqrt(mean_i C[i, perm(i)]) per item, averaged over the batch,
whose gradient is the gather at ``perm``: the envelope gradient of the
exact EMD, which ``ot.emd2`` returns.

``perm`` is the reference's own optimum, or, where the caller hands one in
(``assignments``: per train step, one (B, N) assignment per solve, phi's
inner solves first and the final one last), the assignment given. An
optimal value does not depend on which of several optimal plans is taken;
its gradient does. Taken at the program's own assignments, the reference's
gradients test the program's arithmetic, and each solve's record tests the
assignment: whether it is a permutation, its mean cost on the float64 cost
above scipy's optimum (``gap``), and whether it is scipy's (``flip``). The
validation pass always takes the reference's own assignment.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (Adam, exact_assignment, phi_forward, power_iterations, precision,
                     sphere_regularizer, sq_cost)
from .pcrnet_wcos import (Criterion, _centre, draw_batch, pcrnet, rotation_error_deg,
                          translation_error)


def is_permutation(assign: torch.Tensor) -> torch.Tensor:
    """(B,) bool: each row of a (B, N) assignment holds every object once."""
    n = assign.shape[-1]
    ranged = (assign >= 0) & (assign < n)
    seen = torch.zeros(assign.shape[0], n + 1, dtype=torch.int64, device=assign.device)
    seen.scatter_add_(1, torch.where(ranged, assign, n).long(), torch.ones_like(
        assign, dtype=torch.int64))
    return ranged.all(-1) & (seen[:, :n] == 1).all(-1)


def solve_record(c64: torch.Tensor, used: torch.Tensor, best: torch.Tensor) -> dict:
    """Of one solve: the items whose assignment is not a permutation, the
    largest gap of an item's mean cost at ``used`` above its optimum
    ``best`` on the float64 cost, and the items whose assignment differs
    from ``best``."""
    perm = is_permutation(used)
    mean_at = lambda a: c64.gather(-1, a.clamp(0, c64.shape[-1] - 1).long()[..., None]
                                   )[..., 0].mean(-1)
    gap = mean_at(used) - mean_at(best)
    return {"non_permutations": int((~perm).sum()),
            "gap": float(gap.max()),
            "flips": int((used != best).any(-1).sum()),
            "items": int(used.shape[0])}


class ExactCriterion(Criterion):
    """SHWD on the exact EMD with phi's state and its Adam; each solve's
    assignment is the one handed in, or scipy's."""

    def __init__(self, phi: dict, cfg: dict):
        super().__init__(phi, cfg)
        self.solves: list[dict] = []
        self.used: list[torch.Tensor] = []

    def value(self, x, y, perm=None):
        n = x.shape[1]
        s = phi_forward(self.phi, torch.cat([x, y], dim=1), self.blocks, self.layers,
                        self.cfg["lipschitz_coeff"])
        sx, sy = s[:, :n], s[:, n:]
        c = sq_cost(sx, sy)
        c64 = sq_cost(sx.detach().double(), sy.detach().double())
        best = exact_assignment(c64)
        used = best if perm is None else perm.to(best.device)
        self.solves.append(solve_record(c64, used, best))
        self.used.append(used)
        ot = c.gather(-1, used.long()[..., None])[..., 0].mean(-1)
        return torch.mean(torch.clamp_min(ot, 1e-30) ** 0.5), sx, sy

    def ascend(self, x, y, perm=None):
        params = {k: self.phi[k].detach().requires_grad_(True) for k in self.names}
        self.phi.update(params)
        w, sx, sy = self.value(x.detach(), y.detach(), perm)
        obj = self.cfg["lam"] * (sphere_regularizer(sx) + sphere_regularizer(sy)) - w
        grads = torch.autograd.grad(obj, [params[k] for k in self.names])
        with torch.no_grad():
            self.phi.update({k: params[k].detach() for k in self.names})
            self.opt.step({k: self.phi[k] for k in self.names}, dict(zip(self.names, grads)))
        power_iterations(self.phi, self.blocks, self.layers, 1)


def follow(weights: dict, phi: dict, bank: torch.Tensor, plan: dict, cfg: dict,
           tf32: bool = False, half: bool = False, assignments=None) -> dict:
    """``pcrnet_wcos.follow``'s readings on the exact EMD, plus ``solves``
    (each train step's solves' records, in order) and ``assignments`` (the
    assignment each train solve used, per step). ``assignments`` hands in
    the assignment of each train solve (None: scipy's); ``tf32`` and
    ``half`` are ``pcrnet_wcos.follow``'s."""
    with precision(tf32):
        return _follow(weights, phi, bank, plan, cfg, half, assignments)


def _follow(weights, phi, bank, plan, cfg, half, assignments):
    dev = bank.device
    gen = torch.Generator(device=dev).manual_seed(plan["generator_seed"])
    w = {k: v.clone() for k, v in weights.items()}
    w0 = {k: v.clone() for k, v in w.items()}
    crit = ExactCriterion(phi, cfg)
    phi0 = {k: crit.phi[k].clone() for k in crit.names}
    opt = Adam(w, cfg["lr"], cfg["weight_decay"])
    iters = cfg["pose_iterations"]
    sums = np.zeros(3)
    count = 0
    with torch.no_grad():
        for rows in plan["val"]:
            target, source, rot, trans = draw_batch(
                gen, bank[torch.as_tensor(rows, device=dev)], cfg["transform"])
            target, source, trans = _centre(target, source, trans)
            est_r, est_t, moved = pcrnet(w, target, source, iters)
            loss, _, _ = crit.value(target, moved)
            b = len(rows)
            sums += b * np.array([float(loss),
                                  float(rotation_error_deg(rot, est_r).mean()),
                                  float(translation_error(rot, trans, est_t[:, 0]).mean())])
            count += b
    crit.solves, crit.used = [], []
    losses = []
    for step, rows in enumerate(plan["steps"]):
        target, source, _, trans = draw_batch(gen, bank[torch.as_tensor(rows, device=dev)],
                                              cfg["transform"])
        target, source, _ = _centre(target, source, trans)
        if half:
            target, source = target[:len(rows) // 2], source[:len(rows) // 2]
        inner, final = (None, None) if assignments is None else assignments[step]
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        _, _, moved = pcrnet(leaves, target, source, iters)
        crit.ascend(target, moved, inner)
        loss, _, _ = crit.value(target, moved, final)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        opt.step(w, dict(zip(leaves, grads)))
        if len(losses) == 1:
            first_phi = crit.opt.first_grad
    used = crit.used
    return {
        "losses": losses,
        "first_grad": {**{f"model.{k}": v for k, v in opt.first_grad.items()},
                       **{f"phi.{k}": v for k, v in first_phi.items()}},
        "change": {**{f"model.{k}": w[k] - w0[k] for k in w},
                   **{f"phi.{k}": crit.phi[k] - phi0[k] for k in crit.names}},
        "val": (sums / count).tolist(),
        "solves": [crit.solves[2 * k:2 * k + 2] for k in range(len(plan["steps"]))],
        "assignments": [used[2 * k:2 * k + 2] for k in range(len(plan["steps"]))],
    }
