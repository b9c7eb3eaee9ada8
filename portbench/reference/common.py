"""Plain PyTorch pieces of the references: the residual flow phi, the
log-domain Sinkhorn of the ``sinkhorn`` solver, Adam with coupled L2, the
exact assignment, and the precision switch of the controls.

Written from the methods' definitions, in float32 with TF32 off unless a
control asks for TF32. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


_TF32 = {"on": False}


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products (TF32 off), or for a control TF32 products: the
    factors of every product rounded to TF32's 10-bit mantissa (``mm``),
    on the card and on the CPU alike. Restores the setting afterwards."""
    saved = (_TF32["on"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _TF32["on"] = tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (_TF32["on"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits (the low 13
    bits cleared); the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32, or with TF32 factors under a control."""
    if _TF32["on"]:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-12)


# -- phi: Lipschitz residual blocks --------------------------------------------

def phi_layer_names(blocks: int, layers: int) -> list[str]:
    return [f"flows.{k}.net.layers.{i}" for k in range(blocks) for i in range(layers)]


def phi_draw(generator: torch.Generator, blocks: int, channels, coeff_iters: int = 200):
    """phi's initial weights as the residual flow draws them from
    ``generator``, block by block and layer by layer: w and b uniform in
    +-1/sqrt(fan_in) (the last layer of a block scaled by 1/1000), beta 0.5,
    u and v normal and normalised, then ``coeff_iters`` power iterations.
    Returns a dict in the program's state-dict names."""
    dev = generator.device
    out = {}
    n = len(channels) - 1
    for k in range(blocks):
        for i in range(n):
            fan_in, fan_out = channels[i], channels[i + 1]
            bound = 1.0 / math.sqrt(fan_in)
            w = (torch.rand(fan_out, fan_in, generator=generator, device=dev) * 2 - 1) * bound
            if i == n - 1:
                w = w / 1000.0
            b = (torch.rand(fan_out, generator=generator, device=dev) * 2 - 1) * bound
            u = normalize(torch.randn(fan_out, generator=generator, device=dev))
            v = normalize(torch.randn(fan_in, generator=generator, device=dev))
            name = f"flows.{k}.net.layers.{i}"
            out[f"{name}.w"], out[f"{name}.b"] = w, b
            out[f"{name}.beta"] = torch.full((1,), 0.5, device=dev)
            out[f"{name}.u"], out[f"{name}.v"] = u, v
    power_iterations(out, blocks, n, coeff_iters)
    return out


@torch.no_grad()
def power_iterations(phi: dict, blocks: int, layers: int, count: int) -> None:
    """``count`` rounds of power iteration on each layer's (u, v), in
    place, from the layer's current weight."""
    for name in phi_layer_names(blocks, layers):
        w = phi[f"{name}.w"].detach()
        u, v = phi[f"{name}.u"], phi[f"{name}.v"]
        for _ in range(count):
            u = normalize(mm(w, v))
            v = normalize(mm(w.T, u))
        phi[f"{name}.u"], phi[f"{name}.v"] = u, v


def phi_forward(phi: dict, x: torch.Tensor, blocks: int, layers: int,
                coeff: float) -> torch.Tensor:
    """x + g(x) per block; g alternates the swish x*sigmoid(x*softplus(beta))/1.1
    and a linear layer whose weight is divided by max(1, sigma/coeff),
    sigma = u . (W v) with u and v held constant."""
    for k in range(blocks):
        h = x
        for i in range(layers):
            name = f"flows.{k}.net.layers.{i}"
            w, b, beta = phi[f"{name}.w"], phi[f"{name}.b"], phi[f"{name}.beta"]
            h = h * torch.sigmoid(h * torch.nn.functional.softplus(beta)) / 1.1
            sigma = mm(phi[f"{name}.u"], mm(w, phi[f"{name}.v"]))
            h = mm(h, (w / torch.clamp_min(sigma / coeff, 1.0)).T) + b
        x = x + h
    return x


def sphere_regularizer(x: torch.Tensor) -> torch.Tensor:
    """Mean over points of | ||x|| - 1 |."""
    norms = torch.linalg.vector_norm(x, dim=-1)
    return torch.sum(torch.abs(norms - 1.0)) / norms.numel()


# -- transport -------------------------------------------------------------------

def sq_cost(x: torch.Tensor, y: torch.Tensor, matmul: bool = False) -> torch.Tensor:
    """(B, N, M) squared distances: the sum of squared coordinate
    differences, or with ``matmul`` the expansion |x|^2 + |y|^2 - 2 x.y
    (a product the card may run in TF32)."""
    if matmul:
        x2 = torch.sum(x * x, -1)[..., :, None]
        y2 = torch.sum(y * y, -1)[..., None, :]
        return torch.clamp_min(x2 + y2 - 2.0 * mm(x, y.transpose(-1, -2)), 0.0)
    c = 0.0
    for d in range(x.shape[-1]):
        dd = x[..., :, d, None] - y[..., None, :, d]
        c = c + dd * dd
    return c


@torch.no_grad()
def sinkhorn_duals(c: torch.Tensor, eps: float, iters: int, scales: int):
    """Annealed log-domain Sinkhorn on uniform marginals, per item: the
    temperature falls geometrically from max|C| of the item to ``eps`` over
    ``scales`` stages of ``iters`` iterations, the scaled potentials carried
    over between stages. Returns the potentials (f, g) at ``eps``."""
    b, n, m = c.shape
    log_a, log_b = -math.log(n), -math.log(m)
    log_e0 = torch.log(torch.clamp_min(torch.amax(c.abs().reshape(b, -1), -1), 1e-30))
    log_et = math.log(eps)
    denom = float(max(scales - 1, 1))

    def temp(s):
        r = s / denom
        return torch.exp(log_e0 * (1.0 - r) + log_et * r)[:, None]       # (B, 1)

    phi = c.new_zeros(b, n)
    gam = c.new_zeros(b, m)
    for s in range(scales):
        e = temp(s)
        if s > 0:
            ratio = temp(s - 1) / e
            phi, gam = phi * ratio, gam * ratio
        ce = c / e[:, :, None]
        for _ in range(iters):
            phi = -torch.logsumexp(gam[:, None, :] - ce + log_b, dim=2)
            gam = -torch.logsumexp(phi[:, :, None] - ce + log_a, dim=1)
    e = temp(scales - 1)
    return e * phi, e * gam


def sinkhorn_cost(x: torch.Tensor, y: torch.Tensor, eps: float, iters: int,
                  scales: int) -> torch.Tensor:
    """<P, C(x, y)> per item, P the plan of the detached duals: the value,
    and through the live cost its envelope gradient."""
    c = sq_cost(x, y)
    f, g = sinkhorn_duals(c.detach(), eps, iters, scales)
    n, m = c.shape[-2:]
    plan = torch.exp((f[:, :, None] + g[:, None, :] - c.detach()) / eps
                     - math.log(n) - math.log(m))
    return torch.sum(plan * c, dim=(1, 2))


def exact_assignment(c: torch.Tensor) -> torch.Tensor:
    """The optimal permutation of each (N, N) item of ``c`` (B, N, N),
    solved exactly on the host in float64."""
    cols = [linear_sum_assignment(ci)[1]
            for ci in c.detach().double().cpu().numpy()]
    return torch.as_tensor(np.stack(cols), device=c.device)


def w2_exact(points: np.ndarray, target: np.ndarray) -> float:
    """Exact W2 of two equal-size uniform clouds: the square root of the
    mean squared distance under the optimal assignment, in float64."""
    p, t = np.asarray(points, np.float64), np.asarray(target, np.float64)
    c = ((p[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    r, k = linear_sum_assignment(c)
    return float(np.sqrt(c[r, k].mean()))


# -- Adam with coupled L2 --------------------------------------------------------

class Adam:
    """grad += wd * p, then Adam's moments and bias-corrected step (the
    corrections in float64 on the host)."""

    def __init__(self, params: dict, lr: float, wd: float, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.first_grad: dict | None = None

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        seen = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            seen[k] = g.clone()
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.sub_(self.lr / bc1 * self.m[k] / denom)
        if self.first_grad is None:
            self.first_grad = seen
