"""Chamfer distance: the dense differentiable form and the tiled kernel (K4).

Counterpart of ``shwd_tpu/ops/chamfer.py``:

    CD(x, y) = mean_i min_j |x_i - y_j|^2 + mean_j min_i |x_i - y_j|^2.

``chamfer`` and ``chamfer_directional`` form the dense (B, N, M) matrix and
are differentiable; the ``cd`` training criterion uses them, as in the JAX
package. ``chamfer_tiled`` never forms the matrix: for CUDA tensors it
launches the hand-written CUDA kernel ``csrc/chamfer.cu``, for CPU tensors
it runs ``chamfer_tiled_reference``, the plain PyTorch version. Forward
only, as the JAX package's ``chamfer_pallas`` is; the flow driver's
``eval_metric="cd"``, which needs no gradient, records it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from .costs import sqeuclidean_cost


def chamfer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bidirectional Chamfer distance, mean over batch. x (B, N, 3), y (B, M, 3)."""
    d = sqeuclidean_cost(x, y)
    return torch.mean(torch.amin(d, dim=-1)) + torch.mean(torch.amin(d, dim=-2))


def chamfer_directional(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean_i min_j |x_i - y_j|^2 per batch item, shape (B,)."""
    d = sqeuclidean_cost(x, y)
    return torch.mean(torch.amin(d, dim=-1), dim=-1)


@torch.no_grad()
def chamfer_tiled_reference(x: torch.Tensor, y: torch.Tensor,
                            tile_n: int = 512, tile_m: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the tiled kernel: running minima over
    (tile_n, tile_m) blocks of direct squared differences, so only one
    block of the distance matrix exists at a time. Ragged edges are sliced,
    not padded."""
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    inf = dict(dtype=x.dtype, device=x.device)
    minx = torch.full((b, n), float("inf"), **inf)
    miny = torch.full((b, m), float("inf"), **inf)
    for i0 in range(0, n, tile_n):
        xt = x[:, i0:i0 + tile_n]
        for j0 in range(0, m, tile_m):
            d = sqeuclidean_cost(xt, y[:, j0:j0 + tile_m])
            minx[:, i0:i0 + tile_n] = torch.minimum(
                minx[:, i0:i0 + tile_n], torch.amin(d, dim=2))
            miny[:, j0:j0 + tile_m] = torch.minimum(
                miny[:, j0:j0 + tile_m], torch.amin(d, dim=1))
    return torch.mean(minx) + torch.mean(miny)


def _lib():
    lib = _kernels.load("chamfer")
    fn = lib.shwd_chamfer_tiled
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def chamfer_tiled(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Tiled Chamfer distance, a scalar. x (B, N, 3), y (B, M, 3) f32.

    A CUDA tensor launches the CUDA kernel (no host sync) or raises; a CPU
    tensor runs the plain version. Forward only.
    """
    x, y = x.detach(), y.detach()
    if not x.is_cuda:
        return chamfer_tiled_reference(x, y)
    if (x.ndim != 3 or y.ndim != 3 or x.shape[-1] != 3 or y.shape[-1] != 3
            or x.shape[0] != y.shape[0] or x.dtype != torch.float32
            or y.dtype != torch.float32 or y.device != x.device):
        raise ValueError(f"chamfer_tiled needs f32 clouds (B, N, 3) and "
                         f"(B, M, 3) on one device, got {tuple(x.shape)} "
                         f"{x.dtype} and {tuple(y.shape)} {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("chamfer_tiled needs contiguous clouds")
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    if min(b, n, m) < 1 or b > 65535:
        raise ValueError(f"chamfer_tiled needs 1 <= B <= 65535 and non-empty "
                         f"clouds, got B={b}, N={n}, M={m}")
    fn = _lib()
    minx = torch.empty(b, n, dtype=torch.float32, device=x.device)
    miny = torch.empty(b, m, dtype=torch.float32, device=x.device)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), minx.data_ptr(), miny.data_ptr(),
                out.data_ptr(), b, n, m, _kernels.stream_ptr(x))
    _kernels.check(rc, "chamfer_tiled")
    chamfer_tiled.launches += 1
    return out[0]


chamfer_tiled.launches = 0
