"""Plain reference of the ``pcrnet_wcos`` configuration: PCRNet trained
with the adversarial SHWD criterion on the ``sinkhorn`` solver.

``follow`` takes the benchmark's inputs (the initial weights, the shape
bank, the seed of the batch draws and the plan of which rows go into which
step) and runs the first train steps and one validation pass the way the
method defines them:

- each batch: the bank's rows in the plan's order, Gaussian noise on the
  source, then a random rigid pose (Euler angles uniform in +-45 degrees,
  order xyz; a unit translation direction), all drawn from one generator
  seeded as the program's feed is;
- PCRNet: PointNet 3-64-64-64-128-1024 with a max-pool, the pose head
  2048-1024-1024-512-512-256-7, poses composed over the pose iterations;
- the criterion: phi's inner ascent (one Adam step on
  lam * sphere regularizer - W, then one power iteration), then W between
  phi of both clouds, W = sqrt(<P, C>) per item with the annealed
  log-Sinkhorn plan, averaged over the batch; the model's gradient is the
  envelope gradient through the live cost;
- Adam with coupled L2 on PCRNet.

It returns the readings that the benchmark compares: each step's loss,
each leaf's first gradient (as Adam receives it), each leaf's change over
the steps, and the validation loss and pose errors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (Adam, mm, phi_forward, phi_layer_names, power_iterations, precision,
                     sinkhorn_cost, sphere_regularizer)


# -- quaternions and poses --------------------------------------------------------

def qmul(q, r):
    w1, x1, y1, z1 = torch.unbind(q, -1)
    w2, x2, y2, z2 = torch.unbind(r, -1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def qrot(q, v):
    """Rotate points v (B, N, 3) by unit quaternions q (B, 4)."""
    qv = q[:, None, 1:].expand_as(v)
    uv = torch.linalg.cross(qv, v)
    return v + 2.0 * (q[:, None, :1] * uv + torch.linalg.cross(qv, uv))


def quat_to_matrix(q):
    w, x, y, z = torch.unbind(q, -1)
    r = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def unit_quat(q):
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)


def euler_xyz_quaternion(e):
    """Quaternion of intrinsic x-y-z Euler angles, sign-flipped (the
    right-handed orders' convention of the reference code)."""
    half = e / 2
    zeros = torch.zeros_like(half[:, 0])

    def axis(i):
        parts = [torch.cos(half[:, i]), zeros, zeros, zeros]
        parts[1 + i] = torch.sin(half[:, i])
        return torch.stack(parts, dim=-1)

    return -qmul(qmul(axis(0), axis(1)), axis(2))


def draw_batch(generator, clouds, transform: dict):
    """(target, source, R, t) of one batch: noise on the source, then a
    random pose applied to it."""
    b = clouds.shape[0]
    noisy = clouds + (transform["noise_mean"] + transform["noise_sigma"] * torch.randn(
        clouds.shape, generator=generator, device=clouds.device, dtype=clouds.dtype))
    max_rot = math.radians(transform["angle_range_deg"])
    u = torch.rand((b, 3), generator=generator, device=clouds.device)
    quat = euler_xyz_quaternion(-max_rot + 2 * max_rot * u)
    trans = -1.0 + 2.0 * torch.rand((b, 3), generator=generator, device=clouds.device)
    trans = (math.sqrt(transform["translation_range"]) * trans
             / torch.linalg.vector_norm(trans, dim=-1, keepdim=True))
    quat = unit_quat(quat)
    return clouds, qrot(quat, noisy) + trans[:, None, :], quat_to_matrix(quat), trans


def rotation_error_deg(rot, est_rot):
    err = rot @ est_rot
    tr = err[:, 0, 0] + err[:, 1, 1] + err[:, 2, 2]
    axis = torch.stack([err[:, 2, 1] - err[:, 1, 2], err[:, 0, 2] - err[:, 2, 0],
                        err[:, 1, 0] - err[:, 0, 1]], dim=-1)
    sin = torch.linalg.vector_norm(axis, dim=-1) / 2.0
    return torch.abs(torch.rad2deg(torch.atan2(sin, (tr - 1.0) / 2.0)))


def translation_error(rot, trans, est_trans):
    target = -torch.einsum("bji,bj->bi", rot, trans)
    return torch.sqrt(torch.sum((target - est_trans) ** 2, dim=-1))


# -- PCRNet -----------------------------------------------------------------------

def pointnet(w, x):
    for i in range(5):
        x = torch.relu(mm(x, w[f"feature_model.layers.{i}.w"].T)
                       + w[f"feature_model.layers.{i}.b"])
    return torch.amax(x, dim=-2)


def pcrnet(w, template, source, iterations):
    """(est_R, est_t, transformed source) after ``iterations`` poses."""
    b = template.shape[0]
    est_r = torch.eye(3, device=template.device).expand(b, 3, 3)
    est_t = template.new_zeros(b, 1, 3)
    tfeat = pointnet(w, template)
    for _ in range(iterations):
        y = torch.cat([tfeat, pointnet(w, source)], dim=-1)
        for i in range(6):
            y = mm(y, w[f"head.{i}.w"].T) + w[f"head.{i}.b"]
            if i < 5:
                y = torch.relu(y)
        quat = unit_quat(y[:, :4])
        r = quat_to_matrix(quat)
        t = y[:, 4:]
        est_t = torch.einsum("bij,bkj->bki", r, est_t) + t[:, None, :]
        est_r = r @ est_r
        source = qrot(quat, source) + t[:, None, :]
    return est_r, est_t, source


# -- the criterion ------------------------------------------------------------------

class Criterion:
    """SHWD on the ``sinkhorn`` solver with phi's state and its Adam."""

    def __init__(self, phi: dict, cfg: dict):
        self.cfg = cfg
        self.blocks, self.layers = cfg["phi_blocks"], cfg["phi_layers"]
        self.names = [f"{n}.{p}" for n in phi_layer_names(self.blocks, self.layers)
                      for p in ("w", "b", "beta")]
        self.phi = {k: v.clone() for k, v in phi.items()}
        self.opt = Adam({k: self.phi[k] for k in self.names}, cfg["phi_lr"], cfg["phi_wd"])

    def value(self, x, y):
        n = x.shape[1]
        s = phi_forward(self.phi, torch.cat([x, y], dim=1), self.blocks, self.layers,
                        self.cfg["lipschitz_coeff"])
        sx, sy = s[:, :n], s[:, n:]
        tr = self.cfg["transport"]
        ot = sinkhorn_cost(sx, sy, tr["eps"], tr["num_iters"], tr["num_scales"])
        return torch.mean(torch.clamp_min(ot, 1e-30) ** 0.5), sx, sy

    def ascend(self, x, y):
        params = {k: self.phi[k].detach().requires_grad_(True) for k in self.names}
        self.phi.update(params)
        w, sx, sy = self.value(x.detach(), y.detach())
        obj = self.cfg["lam"] * (sphere_regularizer(sx) + sphere_regularizer(sy)) - w
        grads = torch.autograd.grad(obj, [params[k] for k in self.names])
        with torch.no_grad():
            self.phi.update({k: params[k].detach() for k in self.names})
            self.opt.step({k: self.phi[k] for k in self.names}, dict(zip(self.names, grads)))
        power_iterations(self.phi, self.blocks, self.layers, 1)


def _centre(target, source, trans):
    sm = source.mean(1, keepdim=True)
    return target - target.mean(1, keepdim=True), source - sm, trans - sm[:, 0, :]


def follow(weights: dict, phi: dict, bank: torch.Tensor, plan: dict, cfg: dict,
           tf32: bool = False, half: bool = False) -> dict:
    """The readings of a validation pass and of the first
    ``len(plan['steps'])`` train steps after it (see the module docstring). ``weights``:
    PCRNet's initial tensors by the program's names; ``phi``: phi's
    initial tensors with u and v already power-iterated; ``plan``:
    ``generator_seed`` and the row indices of each step and of the
    validation batches, in order. ``tf32`` computes every product with
    TF32 factors (the control); ``half`` trains on the first half of each
    batch only (a planted fault)."""
    with precision(tf32):
        return _follow(weights, phi, bank, plan, cfg, half)


def _follow(weights, phi, bank, plan, cfg, half):
    dev = bank.device
    gen = torch.Generator(device=dev).manual_seed(plan["generator_seed"])
    w = {k: v.clone() for k, v in weights.items()}
    w0 = {k: v.clone() for k, v in w.items()}
    crit = Criterion(phi, cfg)
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
    losses = []
    for rows in plan["steps"]:
        target, source, _, trans = draw_batch(gen, bank[torch.as_tensor(rows, device=dev)],
                                              cfg["transform"])
        target, source, _ = _centre(target, source, trans)
        if half:
            target, source = target[:len(rows) // 2], source[:len(rows) // 2]
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        _, _, moved = pcrnet(leaves, target, source, iters)
        crit.ascend(target, moved)
        loss, _, _ = crit.value(target, moved)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        opt.step(w, dict(zip(leaves, grads)))
        if len(losses) == 1:
            first_phi = crit.opt.first_grad
    return {
        "losses": losses,
        "first_grad": {**{f"model.{k}": v for k, v in opt.first_grad.items()},
                       **{f"phi.{k}": v for k, v in first_phi.items()}},
        "change": {**{f"model.{k}": w[k] - w0[k] for k in w},
                   **{f"phi.{k}": crit.phi[k] - phi0[k] for k in crit.names}},
        "val": (sums / count).tolist(),
    }
