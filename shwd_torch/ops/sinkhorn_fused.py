"""Fused point-cloud Sinkhorn (kernel K3): cost tile + schedule in one launch.

Counterpart of the fused half of ``shwd_tpu/ops/sinkhorn_pallas.py``
(``fused_supported``, ``_fused_forward``, ``sinkhorn_points``,
``emd2_points``). ``sinkhorn_points`` launches the hand-written CUDA kernel
``csrc/sinkhorn_points.cu`` for CUDA tensors and runs
``sinkhorn_points_reference``, its plain PyTorch version, for CPU tensors.
Both follow the TPU kernel's formulas: the cost built from the raw clouds,
per-item eps0 = max|C|, scaled potentials rescaled between temperatures,
``C / e`` as a division. The kernel has two routes, chosen by shape
(``pick_route``): tiles up to 128 x 128 held in registers, larger tiles in
shared memory or a global scratch; one CTA per item on either.

The gradient uses the envelope convention of ``ops.sinkhorn``: the plan is
formed from the detached duals and pulled back through a differentiable
``cost_matrix`` in plain PyTorch (the JAX package has no backward kernel
either). First-order gradients only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels
from .costs import cost_matrix
from .sinkhorn import emd2_approx

_KINDS = {"lp": 0, "sqeuclidean": 0, "cosine": 1, "geodesic": 2}
# the JAX package's gate: 5 live (2, Np, Mp) f32 buffers within twice 8 MB
_VMEM_BUDGET_BYTES = 8 * 1024 * 1024
_LIVE_BUFFERS = 5


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_supported(n: int, m: int, kind: str, p: float) -> bool:
    """The shape and cost gate of the JAX package's fused kernel, kept so
    the port picks the kernel for exactly the shapes the JAX package does
    (the CUDA kernel itself holds larger tiles in a global scratch)."""
    if kind in ("lp", "sqeuclidean") and p != 2:
        return False
    if kind not in _KINDS:
        return False
    return (2 * _round_up(n, 128) * _round_up(m, 128) * 4 * _LIVE_BUFFERS
            <= _VMEM_BUDGET_BYTES * 2)


def _check_kind(kind: str, p: float) -> None:
    if kind not in _KINDS or (_KINDS[kind] == 0 and p != 2):
        raise ValueError(f"sinkhorn_points takes lp (p=2), cosine or "
                         f"geodesic costs, got {kind!r} with p={p}")


def _points_cost(x: torch.Tensor, y: torch.Tensor, kind: str, p: float):
    """The cost tile as the kernel builds it (not ``cost_matrix``: cosine
    and geodesic divide the raw product by the two clamped norms)."""
    if _KINDS[kind] == 0:
        c = torch.zeros(x.shape[0], x.shape[1], y.shape[1], dtype=x.dtype,
                        device=x.device)
        for d in range(x.shape[-1]):
            dd = x[:, :, d][:, :, None] - y[:, :, d][:, None, :]
            c = c + dd * dd
        return c
    xy = torch.einsum("bnd,bmd->bnm", x, y)
    xn = torch.sqrt(torch.clamp_min(torch.sum(x * x, -1), 1e-16))[:, :, None]
    yn = torch.sqrt(torch.clamp_min(torch.sum(y * y, -1), 1e-16))[:, None, :]
    cos = xy / (xn * yn)
    if kind == "cosine":
        return (1.0 - cos) ** p
    return torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)) ** p


@torch.no_grad()
def sinkhorn_points_reference(x: torch.Tensor, y: torch.Tensor,
                              kind: str = "lp", p: float = 2.0,
                              eps: float = 5e-3, num_iters: int = 50,
                              num_scales: int = 4):
    """Plain PyTorch version of the fused kernel, same schedule.

    x (B, N, 3), y (B, M, 3) f32 -> (val (B,), f (B, N), g (B, M)).
    Forward only.
    """
    _check_kind(kind, p)
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    log_a, log_b = -math.log(n), -math.log(m)
    c = _points_cost(x.float(), y.float(), kind, p)
    c_max = torch.amax(torch.abs(c).reshape(b, -1), dim=-1, keepdim=True)
    log_e0 = torch.log(torch.clamp_min(c_max, 1e-30))               # (B, 1)
    log_et = torch.tensor(math.log(eps), **f32)
    denom = float(max(num_scales - 1, 1))

    def eps_at(s):
        r = torch.tensor(float(s), **f32) / denom
        return torch.exp(log_e0 * (1.0 - r) + log_et * r)           # (B, 1)

    phi = torch.zeros(b, n, **f32)
    gam = torch.zeros(b, m, **f32)
    for s in range(num_scales):
        e = eps_at(s)
        if s > 0:
            scale = eps_at(s - 1) / e
            phi, gam = phi * scale, gam * scale
        ce = c / e[:, :, None]
        cb = ce - log_b
        ca = ce - log_a
        for _ in range(num_iters):
            zf = gam[:, None, :] - cb
            mf = torch.amax(zf, dim=2)
            phi = -(mf + torch.log(torch.sum(torch.exp(zf - mf[:, :, None]), dim=2)))
            zg = phi[:, :, None] - ca
            mg = torch.amax(zg, dim=1)
            gam = -(mg + torch.log(torch.sum(torch.exp(zg - mg[:, None, :]), dim=1)))
    e_fin = eps_at(num_scales - 1)
    f = e_fin * phi
    g = e_fin * gam
    log_p = (f[:, :, None] + g[:, None, :] - c) / eps + log_a + log_b
    val = torch.sum(torch.exp(log_p) * c, dim=(1, 2))
    return val, f, g


def _lib():
    lib = _kernels.load("sinkhorn_points")
    fn = lib.shwd_sinkhorn_points
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, cf,
                       cf, cf, ci, ci, ci, vp]
        fn.restype = ci
        lib.shwd_sinkhorn_points_tile_in_smem.argtypes = [ci, ci]
        lib.shwd_sinkhorn_points_tile_in_smem.restype = ci
    return lib


REG_TILE = 128                 # the register route's largest N and M
_ROUTES = {"general": 0, "registers": 1}


def pick_route(n: int, m: int) -> str:
    """The kernel's route for items of N x M: tiles up to 128 x 128 are
    held in registers ("registers": one CTA of 1024 threads per item);
    larger tiles take the "general" route (tiles in shared memory or a
    global scratch)."""
    return "registers" if n <= REG_TILE and m <= REG_TILE else "general"


def _fused_forward(x: torch.Tensor, y: torch.Tensor, kind: str, p: float,
                   eps: float, num_iters: int, num_scales: int,
                   route: str | None = None):
    """(val, f, g) of detached clouds: the CUDA kernel for CUDA tensors
    (one launch, no host sync), the plain version for CPU tensors.

    ``route`` forces the kernel's route ("registers" or "general"); by
    default ``pick_route`` chooses it from the shape. The route taken is
    kept in ``_fused_forward.last_route``."""
    _check_kind(kind, p)
    x, y = x.detach(), y.detach()
    if not x.is_cuda:
        return sinkhorn_points_reference(x, y, kind, p, eps, num_iters,
                                         num_scales)
    if (x.ndim != 3 or y.ndim != 3 or x.shape[-1] != 3 or y.shape[-1] != 3
            or x.shape[0] != y.shape[0] or x.dtype != torch.float32
            or y.dtype != torch.float32 or y.device != x.device):
        raise ValueError(f"sinkhorn_points needs f32 clouds (B, N, 3) and "
                         f"(B, M, 3) on one device, got {tuple(x.shape)} "
                         f"{x.dtype} and {tuple(y.shape)} {y.dtype}")
    if num_iters < 1 or num_scales < 1:
        raise ValueError("sinkhorn_points needs num_iters >= 1 and "
                         "num_scales >= 1")
    x, y = x.contiguous(), y.contiguous()
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    dev = x.device
    route = pick_route(n, m) if route is None else route
    if route not in _ROUTES or (route == "registers" and max(n, m) > REG_TILE):
        raise ValueError(f"sinkhorn_points: no route {route!r} for N={n}, M={m}")
    lib = _lib()
    val = torch.empty(b, dtype=torch.float32, device=dev)
    f = torch.empty(b, n, dtype=torch.float32, device=dev)
    g = torch.empty(b, m, dtype=torch.float32, device=dev)
    scratch = None
    if route == "general" and not lib.shwd_sinkhorn_points_tile_in_smem(n, m):
        scratch = torch.empty(b, 2, n, m, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.shwd_sinkhorn_points(
            x.data_ptr(), y.data_ptr(), val.data_ptr(), f.data_ptr(),
            g.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, n, m, _KINDS[kind], p, eps, math.log(eps), -math.log(n),
            -math.log(m), num_iters, num_scales, _ROUTES[route],
            _kernels.stream_ptr(x))
    _kernels.check(rc, "sinkhorn_points")
    sinkhorn_points.launches += 1
    _fused_forward.last_route = route
    return val, f, g


_fused_forward.last_route = None


class _SinkhornPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, kind, p, eps, num_iters, num_scales):
        val, f, g = _fused_forward(x, y, kind, p, eps, num_iters, num_scales)
        ctx.save_for_backward(x, y, f, g)
        ctx.cfg = (kind, p, eps)
        return val

    @staticmethod
    def backward(ctx, dval):
        x, y, f, g = ctx.saved_tensors
        kind, p, eps = ctx.cfg
        n, m = x.shape[-2], y.shape[-2]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            yd = y.detach().requires_grad_(ctx.needs_input_grad[1])
            c = cost_matrix(xd, yd, kind, p)
            log_p = ((f[..., :, None] + g[..., None, :] - c.detach()) / eps
                     - math.log(n) - math.log(m))
            plan = torch.exp(log_p)
            env = torch.sum(plan * c, dim=(-2, -1))
            wanted = [t for t in (xd, yd) if t.requires_grad]
            grads = iter(torch.autograd.grad(env, wanted, dval))
        dx = next(grads) if xd.requires_grad else None
        dy = next(grads) if yd.requires_grad else None
        return dx, dy, None, None, None, None, None


def sinkhorn_points(x: torch.Tensor, y: torch.Tensor, kind: str = "lp",
                    p: float = 2.0, eps: float = 5e-3, num_iters: int = 50,
                    num_scales: int = 4) -> torch.Tensor:
    """Near-exact EMD <P, C(x, y)> per batch item through the fused kernel.

    x (B, N, 3), y (B, M, 3) -> (B,). The cost matrix never exists in
    device memory on the forward pass (for tiles that fit shared memory).
    A CUDA tensor launches the CUDA kernel or raises; a CPU tensor runs
    ``sinkhorn_points_reference``. Differentiable wrt x and y (envelope
    gradient, first order).
    """
    return _SinkhornPoints.apply(x, y, kind, p, eps, num_iters, num_scales)


sinkhorn_points.launches = 0


def emd2_points(x: torch.Tensor, y: torch.Tensor, kind: str = "lp",
                p: float = 2.0, eps: float = 5e-3, num_iters: int = 50,
                num_scales: int = 4,
                use_kernel: bool | None = None) -> torch.Tensor:
    """Dispatcher: the fused kernel route for CUDA tensors when the JAX
    package's gate admits the problem, ``cost_matrix`` + ``emd2_approx``
    (one batch-global eps0, no rescaling) otherwise. x (B, N, 3),
    y (B, M, 3) -> (B,).

    ``use_kernel`` mirrors the JAX package's ``use_pallas``: None picks by
    device and gate; True takes the kernel route (on a CPU tensor its plain
    version); False the ``emd2_approx`` route.
    """
    n, m = x.shape[-2], y.shape[-2]
    if use_kernel is None:
        use_kernel = x.is_cuda and fused_supported(n, m, kind, p)
    if use_kernel:
        return sinkhorn_points(x, y, kind, p, eps, num_iters, num_scales)
    c = cost_matrix(x, y, kind, p)
    return emd2_approx(c, eps=eps, num_iters=num_iters, num_scales=num_scales)
