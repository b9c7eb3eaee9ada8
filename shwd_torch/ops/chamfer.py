"""Chamfer distance: the dense differentiable form and the tiled kernel (K4).

Counterpart of ``shwd_tpu/ops/chamfer.py``:

    CD(x, y) = mean_i min_j |x_i - y_j|^2 + mean_j min_i |x_i - y_j|^2.

``chamfer`` and ``chamfer_directional`` form the dense (B, N, M) matrix and
are differentiable; the ``cd`` training criterion uses them, as in the JAX
package. ``chamfer_tiled`` never forms the matrix: for CUDA tensors it
launches the hand-written CUDA kernel ``csrc/chamfer.cu`` (one cooperative
launch, the same bits on every call), for CPU tensors
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
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
        lib.shwd_chamfer_scratch_floats.argtypes = [ci, ci, ci, ci]
        lib.shwd_chamfer_scratch_floats.restype = ctypes.c_longlong
        lib.shwd_chamfer_empty.argtypes = [ci, ci, ci, ci, vp]
        lib.shwd_chamfer_empty.restype = ci
    return lib


TILE_ROWS = 1024        # points of a side per unit of the kernel (256 threads x 4)
MAX_CHUNK = 1024        # points of the other cloud per unit (its shared memory)
MIN_CHUNK = 32          # fewer than this per unit buys no more parallel work
_sm_counts: dict[int, int] = {}


def chamfer_chunks(b: int, n: int, m: int, sm_count: int) -> int:
    """How many slices of the other cloud the kernel cuts each side's work
    into: enough units (chunks x B x row tiles of both sides) to give every
    SM one, with slices of at least 32 points where the clouds allow it and
    never more than 1024 (a slice lives in shared memory)."""
    tiles = b * (-(-n // TILE_ROWS) + -(-m // TILE_ROWS))
    want = -(-sm_count // tiles)
    most = max(1, -(-min(n, m) // MIN_CHUNK))
    least = -(-max(n, m) // MAX_CHUNK)
    return max(least, min(want, most))


def _sm_count(dev: torch.device) -> int:
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def _check_clouds(x: torch.Tensor, y: torch.Tensor) -> None:
    if (x.ndim != 3 or y.ndim != 3 or x.shape[-1] != 3 or y.shape[-1] != 3
            or x.shape[0] != y.shape[0] or x.dtype != torch.float32
            or y.dtype != torch.float32 or y.device != x.device):
        raise ValueError(f"chamfer_tiled needs f32 clouds (B, N, 3) and "
                         f"(B, M, 3) on one device, got {tuple(x.shape)} "
                         f"{x.dtype} and {tuple(y.shape)} {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("chamfer_tiled needs contiguous clouds")
    if min(x.shape[0], x.shape[1], y.shape[1]) < 1:
        raise ValueError(f"chamfer_tiled needs a batch and non-empty clouds, "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")


def chamfer_tiled(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Tiled Chamfer distance, a scalar. x (B, N, 3), y (B, M, 3) f32.

    A CUDA tensor launches the CUDA kernel (one launch, no host sync, the
    same bits on every call) or raises; a CPU tensor runs the plain
    version. Forward only.
    """
    x, y = x.detach(), y.detach()
    if not x.is_cuda:
        return chamfer_tiled_reference(x, y)
    _check_clouds(x, y)
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    lib = _lib()
    chunks = chamfer_chunks(b, n, m, _sm_count(x.device))
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        floats = lib.shwd_chamfer_scratch_floats(b, n, m, chunks)
        if floats <= 0:
            raise ValueError(f"chamfer_tiled: the kernel does not take B={b}, "
                             f"N={n}, M={m}")
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        rc = lib.shwd_chamfer_tiled(x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                                    out.data_ptr(), b, n, m, chunks,
                                    _kernels.stream_ptr(x))
    _kernels.check(rc, "chamfer_tiled")
    chamfer_tiled.launches += 1
    return out[0]


chamfer_tiled.launches = 0


def chamfer_launch_floor(x: torch.Tensor, y: torch.Tensor) -> None:
    """The kernel's launch with an empty body, at the grid a call on these
    clouds takes: the floor of one launch, for measurements only."""
    _check_clouds(x, y)
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.shwd_chamfer_empty(b, n, m, chamfer_chunks(b, n, m, _sm_count(x.device)),
                                    _kernels.stream_ptr(x))
    _kernels.check(rc, "chamfer launch floor")
