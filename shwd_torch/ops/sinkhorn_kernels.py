"""Annealed-Sinkhorn warm-up for the hybrid exact-EMD solver (kernel K1).

Counterpart of the warm-up half of ``shwd_tpu/ops/sinkhorn_pallas.py``
(``warmup_supported``, ``emd2_warmup_pallas``). ``emd2_warmup`` launches
the hand-written CUDA kernel ``csrc/emd2_warmup.cu`` (one persistent
cooperative launch per call) for a CUDA tensor and runs
``emd2_warmup_reference``, its plain PyTorch version, for a CPU
tensor. Both follow the Pallas kernel's schedule and formulas: per-item
eps0 = max|C|, temperatures recomputed from it at each scale, potentials
not rescaled between temperatures, log-sums guarded at 1e-38.

``sinkhorn_warm`` is the warm-up of smaller problems (N, M <= 128): the
potentials of ``emd2_approx`` (one batch-global eps0, its temperatures
read from the device), one launch of ``csrc/sinkhorn_warm.cu`` for a
CUDA tensor and ``emd2_approx`` itself for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels
from ..utils.profiling import device_span
from .sinkhorn import emd2_approx, eps_schedule


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def warmup_supported(n: int, m: int) -> bool:
    """The size gate of the JAX package's warm-up kernel. The hybrid solver
    dispatches on it (with N*M >= 512^2), so the port picks the warm-up for
    exactly the shapes the JAX package does."""
    m_pad = _round_up(m, 128)
    n_pad = _round_up(n, 8)
    return (n_pad * m_pad + n_pad * 256) * 4 <= 13 * 1024 * 1024


def _logs(n: int, m: int, eps: float):
    log_a = -math.log(n)
    log_b = -math.log(m)
    return math.log(eps), log_a, log_b, log_a + log_b


def emd2_warmup_reference(cost: torch.Tensor, eps: float = 1e-5,
                          num_iters: int = 40, num_scales: int = 8):
    """Plain PyTorch version of the warm-up kernel, same schedule.

    cost: (B, N, M) f32 -> (val (B,), f (B, N), g (B, M)). Forward only.
    """
    cost = cost.detach()
    b, n, m = cost.shape
    log_et, log_a, log_b, log_ab = _logs(n, m, eps)
    f32 = dict(dtype=torch.float32, device=cost.device)
    c_max = torch.amax(torch.abs(cost).reshape(b, -1), dim=-1)
    log_e0 = torch.log(torch.clamp_min(c_max, 1e-30))[:, None]       # (B, 1)
    log_et_t = torch.tensor(log_et, **f32)
    denom = torch.tensor(float(max(num_scales - 1, 1)), **f32)

    def eps_at(s):
        r = torch.tensor(float(s), **f32) / denom
        return torch.exp(log_e0 * (1.0 - r) + log_et_t * r)          # (B, 1)

    f = torch.zeros(b, n, **f32)
    g = torch.zeros(b, m, **f32)
    for s in range(num_scales):
        e = eps_at(s)
        e_inv = 1.0 / e
        for _ in range(num_iters):
            z = (g[:, None, :] - cost) * e_inv[:, :, None] + log_b
            mz = torch.amax(z, dim=2)
            sz = torch.sum(torch.exp(z - mz[:, :, None]), dim=2)
            f = -e * (mz + torch.log(torch.clamp_min(sz, 1e-38)))
            z = (f[:, :, None] - cost) * e_inv[:, :, None] + log_a
            mz = torch.amax(z, dim=1)
            sz = torch.sum(torch.exp(z - mz[:, None, :]), dim=1)
            g = -e * (mz + torch.log(torch.clamp_min(sz, 1e-38)))
    e_inv = 1.0 / eps_at(num_scales - 1)
    lp = (f[:, :, None] + g[:, None, :] - cost) * e_inv[:, :, None] + log_ab
    val = torch.sum(torch.exp(lp) * cost, dim=(1, 2))
    return val, f, g


def _lib():
    lib = _kernels.load("emd2_warmup")
    fn = lib.shwd_emd2_warmup
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, cf, cf, cf, cf, ci,
                       ci, vp]
        fn.restype = ci
        lib.shwd_emd2_warmup_layout.argtypes = [ci, ci, ci, vp]
        lib.shwd_emd2_warmup_layout.restype = ci
        lib.shwd_emd2_warmup_exchanges.argtypes = [ci, ci, ci, ci, vp, vp]
        lib.shwd_emd2_warmup_exchanges.restype = ci
    return lib


_layouts: dict[tuple, dict] = {}


def warmup_layout(cost: torch.Tensor) -> dict:
    """How the kernel lays a (B, N, M) CUDA cost out on its device: blocks
    in the grid, rows per block, scratch slots per item, whether the rows
    are resident in shared memory, whether g is cached there, dynamic
    shared memory bytes."""
    index = cost.device.index
    key = (torch.cuda.current_device() if index is None else index, *cost.shape)
    if key not in _layouts:               # asked once per device and shape
        b, n, m = cost.shape
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(cost.device):
            rc = _lib().shwd_emd2_warmup_layout(b, n, m, out)
        _kernels.check(rc, "emd2_warmup layout")
        _layouts[key] = dict(zip(("grid", "rows_per_block", "slots", "resident",
                                  "g_cached", "smem_bytes"), (int(v) for v in out)))
    return dict(_layouts[key])


def warmup_exchanges(cost: torch.Tensor, count: int) -> None:
    """Launch the kernel's chain with no arithmetic on the grid
    ``emd2_warmup`` uses for ``cost``, to be timed: ``count`` exchanges in
    which every block waits for a marked word of every other block (what an
    iteration does twice)."""
    b, n, m = cost.shape
    marks = torch.empty(512, dtype=torch.float32, device=cost.device)
    with torch.cuda.device(cost.device):
        rc = _lib().shwd_emd2_warmup_exchanges(
            b, n, m, count, marks.data_ptr(), _kernels.stream_ptr(cost))
    _kernels.check(rc, "emd2_warmup exchanges")


def emd2_warmup(cost: torch.Tensor, eps: float = 1e-5, num_iters: int = 40,
                num_scales: int = 8):
    """Annealed log-Sinkhorn duals of (B, N, M) costs, per-item eps0.

    Returns (val (B,), f (B, N), g (B, M)), forward only. A CUDA tensor
    goes through the CUDA kernel (one cooperative launch, no host sync); a
    CPU tensor through the plain version.
    """
    if not cost.is_cuda:
        return emd2_warmup_reference(cost, eps, num_iters, num_scales)
    if cost.dtype != torch.float32 or cost.ndim != 3:
        raise ValueError(f"emd2_warmup needs a (B, N, M) f32 cost, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("emd2_warmup needs a contiguous cost")
    if num_iters < 1 or num_scales < 1:
        raise ValueError("emd2_warmup needs num_iters >= 1 and num_scales >= 1")
    b, n, m = cost.shape
    log_et, log_a, log_b, log_ab = _logs(n, m, eps)
    slots = warmup_layout(cost)["slots"]
    f32 = dict(dtype=torch.float32, device=cost.device)
    val = torch.empty(b, **f32)
    f = torch.empty(b, n, **f32)
    g = torch.empty(b, m, **f32)
    log_e0 = torch.empty(b, **f32)
    # per-block partials: a (max, sum) pair per column, one number per item;
    # and g with its iteration mark
    scratch = torch.empty(2 * b * m * (slots + 1) + b * slots, **f32)
    with torch.cuda.device(cost.device), device_span("k1"):
        rc = _lib().shwd_emd2_warmup(
            cost.data_ptr(), val.data_ptr(), f.data_ptr(), g.data_ptr(),
            log_e0.data_ptr(), scratch.data_ptr(), b, n, m, log_et, log_a,
            log_b, log_ab, num_iters, num_scales, _kernels.stream_ptr(cost))
    _kernels.check(rc, "emd2_warmup")
    emd2_warmup.launches += 1
    return val, f, g


emd2_warmup.launches = 0


SINKHORN_WARM_TILE = 128       # the largest N and M of the kernel's register tile


def sinkhorn_warm_supported(n: int, m: int) -> bool:
    """The shapes ``csrc/sinkhorn_warm.cu`` takes: one CTA holds an item's
    whole (N, M) tile in registers."""
    return 1 <= n <= SINKHORN_WARM_TILE and 1 <= m <= SINKHORN_WARM_TILE


def _warm_lib():
    lib = _kernels.load("sinkhorn_warm")
    fn = lib.shwd_sinkhorn_warm
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, cf, cf, ci, ci, vp]
        fn.restype = ci
    return lib


def sinkhorn_warm(cost: torch.Tensor, eps: float = 5e-3, num_iters: int = 50,
                  num_scales: int = 4):
    """The dual potentials of ``emd2_approx(cost, eps, num_iters,
    num_scales, return_potentials=True)`` for (B, N, M) costs with uniform
    marginals: returns (f (B, N), g (B, M)), forward only.

    A CUDA tensor goes through the CUDA kernel: the temperatures are
    ``emd2_approx``'s own (``eps_schedule``, batch-global eps0, made on the
    device), then one launch runs every iteration, no host sync. A CPU
    tensor runs ``emd2_approx`` itself.
    """
    if not cost.is_cuda:
        _, f, g = emd2_approx(cost, eps=eps, num_iters=num_iters,
                              num_scales=num_scales, return_potentials=True)
        return f, g
    if cost.dtype != torch.float32 or cost.ndim != 3:
        raise ValueError(f"sinkhorn_warm needs a (B, N, M) f32 cost, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("sinkhorn_warm needs a contiguous cost")
    b, n, m = cost.shape
    if b < 1 or not sinkhorn_warm_supported(n, m):
        raise ValueError(f"sinkhorn_warm takes 1 <= N, M <= {SINKHORN_WARM_TILE} "
                         f"and a batch, got {tuple(cost.shape)}")
    if num_iters < 0 or num_scales < 0:
        raise ValueError("sinkhorn_warm needs num_iters >= 0 and num_scales >= 0")
    cost = cost.detach()
    eps_sched = eps_schedule(cost, eps, num_scales).contiguous()
    f = torch.empty(b, n, dtype=torch.float32, device=cost.device)
    g = torch.empty(b, m, dtype=torch.float32, device=cost.device)
    with torch.cuda.device(cost.device):
        rc = _warm_lib().shwd_sinkhorn_warm(
            cost.data_ptr(), eps_sched.data_ptr(), f.data_ptr(), g.data_ptr(), b, n,
            m, 1.0 / n, 1.0 / m, num_iters, num_scales, _kernels.stream_ptr(cost))
    _kernels.check(rc, "sinkhorn_warm")
    sinkhorn_warm.launches += 1
    return f, g


sinkhorn_warm.launches = 0
