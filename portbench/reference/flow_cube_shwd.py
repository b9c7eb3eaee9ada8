"""Plain reference of the ``flow_cube_shwd`` configuration: the SHWD
Wasserstein gradient flow on the exact (hybrid) solver.

One step of the flow, as the method defines it:

- phi's inner ascent: phi (residual Lipschitz blocks) maps both clouds,
  the exact optimal assignment of the squared-distance cost between them
  gives W = sqrt(mean assigned cost); one Adam step (coupled L2) on
  lam * sphere regularizer - W, then one power iteration;
- the point update: W again through the updated phi, its gradient with
  respect to the points (the envelope gradient: the cost gathered at the
  optimal assignment), one Adam step on the coordinates.

The hybrid solver reaches the optimal assignment through annealed Sinkhorn
duals and an auction; here the assignment is solved exactly on the host.
phi's initial weights are drawn from the flow's seed with the same draws
as the program's residual flow, since the flow takes no weights from its
caller.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (Adam, exact_assignment, phi_draw, phi_forward, phi_layer_names,
                     power_iterations, precision, sphere_regularizer, sq_cost)


def _w(phi, x, y, cfg, matmul_cost):
    n = x.shape[1]
    s = phi_forward(phi, torch.cat([x, y], dim=1), cfg["blocks"], cfg["layers"],
                    cfg["lipschitz_coeff"])
    sx, sy = s[:, :n], s[:, n:]
    c = sq_cost(sx, sy, matmul=matmul_cost)
    assign = exact_assignment(c)
    val = c.gather(-1, assign[..., None])[..., 0].mean(-1)
    return torch.mean(torch.clamp_min(val, 1e-30) ** 0.5), sx, sy


def follow(source: np.ndarray, target: np.ndarray, seed: int, cfg: dict, steps: int,
           device, tf32: bool = False, matmul_cost: bool = False,
           half: bool = False) -> np.ndarray:
    """The points after ``steps`` flow steps from ``source`` toward
    ``target`` (numpy, (N, 3)). ``tf32`` and ``matmul_cost`` give the
    control: TF32 products, and the cost through a product; ``half`` (a
    planted fault) moves the first half of the points toward the first
    half of the target and leaves the rest out."""
    with precision(tf32):
        gen = torch.Generator(device=device).manual_seed(seed)
        channels = [3] + [cfg["hidden"]] * (cfg["layers"] - 1) + [3]
        phi = phi_draw(gen, cfg["blocks"], channels)
        names = [f"{n}.{p}" for n in phi_layer_names(cfg["blocks"], cfg["layers"])
                 for p in ("w", "b", "beta")]
        phi_opt = Adam({k: phi[k] for k in names}, cfg["phi_lr"], cfg["phi_wd"])
        keep = len(source) // 2 if half else len(source)
        out = np.array(source, np.float32)
        pts = torch.as_tensor(out[:keep], device=device)[None].clone()
        tgt = torch.as_tensor(target[:keep], dtype=torch.float32, device=device)[None]
        pt_opt = Adam({"points": pts}, cfg["lr"], 0.0)
        for _ in range(steps):
            for _ in range(cfg["inner_steps"]):
                leaves = {k: phi[k].detach().requires_grad_(True) for k in names}
                phi.update(leaves)
                w, sx, sy = _w(phi, pts, tgt, cfg, matmul_cost)
                obj = cfg["lam"] * (sphere_regularizer(sx) + sphere_regularizer(sy)) - w
                grads = torch.autograd.grad(obj, [leaves[k] for k in names])
                phi.update({k: leaves[k].detach() for k in names})
                phi_opt.step({k: phi[k] for k in names}, dict(zip(names, grads)))
                power_iterations(phi, cfg["blocks"], cfg["layers"], 1)
            live = pts.detach().requires_grad_(True)
            w, _, _ = _w({k: v.detach() for k, v in phi.items()}, live, tgt, cfg,
                         matmul_cost)
            (grad,) = torch.autograd.grad(w, [live])
            pt_opt.step({"points": pts}, {"points": grad})
        out[:keep] = pts[0].cpu().numpy()
        return out
