"""Sharded losses: data x slices parallel spherical sliced OT, data-parallel
transport, and pose refinement split over the batch.

Counterpart of ``shwd_tpu/parallel/sharded_ops.py``. Each rank takes its
block of the problems (batch rows over ``data``, projection frames over
``slices``), solves it end to end with the single-device ops, and one
differentiable mean over ``slices`` and one over ``data`` close the value,
which is then the same on every rank. The (B, L, N) intermediate never
exists whole. Every rank passes the same global tensors; the gradient a
rank gets is its share (``parallel.mesh``'s convention: average it over the
mesh for the global gradient).

The ops are imported where a loss is made: they import ``parallel.mesh``
themselves (for the trainer's data group).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from . import mesh as _mesh


def _axis(mesh: DeviceMesh, axis: str):
    """(size, this rank's index, group or None for a size of one)."""
    size = _mesh.axis_size(mesh, axis)
    return (size, _mesh.axis_rank(mesh, axis),
            mesh.get_group(axis) if size > 1 else None)


def make_sharded_ssw(mesh: DeviceMesh, p: float = 2.0) -> Callable:
    """Returns ssw(x, y, frames) -> the mean over (batch, slices) of the
    circular W_p^p.

    x, y: (B, N, 3); frames: (L, 3, 2). A rank takes its rows over ``data``
    and its frames over ``slices``.
    """
    from ..ops.spherical import sliced_cost_sphere

    n_data, r_data, g_data = _axis(mesh, "data")
    n_sl, r_sl, g_sl = _axis(mesh, "slices")

    def ssw(x, y, frames):
        x, y = _mesh.shard(x, n_data, r_data), _mesh.shard(y, n_data, r_data)
        frames = _mesh.shard(frames, n_sl, r_sl)
        cost = sliced_cost_sphere(x, y, frames, p=p)          # (B_loc,)
        s = torch.mean(cost)
        if g_sl is not None:
            s = _mesh.all_reduce(s, "mean", g_sl)
        return s if g_data is None else _mesh.all_reduce(s, "mean", g_data)

    return ssw


def make_sharded_transport(mesh: DeviceMesh, cost: str = "lp", p: float = 2.0,
                           eps: float = 5e-3, num_iters: int = 50,
                           num_scales: int = 4) -> Callable:
    """Batched near-exact EMD with the batch split over ``data``.

    Returns transport(x, y) -> the batch mean of W = EMD^{1/p}. Each rank
    Sinkhorn-solves its (B/D, N, M) cost stack with ITS OWN eps0 (the max
    |C| of its block, as the JAX package's ``shard_map`` body computes it),
    then one mean over ``data``.
    """
    from ..ops.costs import cost_matrix as build_cost
    from ..ops.sinkhorn import emd2_approx

    n_data, r_data, g_data = _axis(mesh, "data")
    n_sl, _, g_sl = _axis(mesh, "slices")

    def transport(x, y):
        x, y = _mesh.shard(x, n_data, r_data), _mesh.shard(y, n_data, r_data)
        with _mesh.data_parallel(None):            # the local eps0
            val = emd2_approx(build_cost(x, y, cost, p), eps=eps,
                              num_iters=num_iters, num_scales=num_scales)
        s = torch.mean(torch.clamp_min(val, 1e-30) ** (1.0 / p))
        if g_data is not None:
            s = _mesh.all_reduce(s, "mean", g_data)
        return s if g_sl is None else _mesh.all_reduce(s, "mean", g_sl)

    return transport


def sharded_refine_poses(mesh: DeviceMesh, source: torch.Tensor,
                         target: torch.Tensor, cfg=None,
                         generator: Optional[torch.Generator] = None,
                         init_pose: Optional[torch.Tensor] = None):
    """``train.pose_refine.refine_poses`` with the batch split over
    ``data``: each rank refines its rows, then the rows are gathered back, so
    every rank returns the whole ``PoseRefineResult`` (``losses``, the
    summed objective, summed over the ranks). Objects are independent, so
    the loop needs no collective, except the batch-wide eps0 of the
    ``sinkhorn`` loss's plain route (the kernel's eps0 is per object).
    ``generator`` must draw the same ``ssw`` frames on every rank.
    """
    from ..train.pose_refine import PoseRefineConfig, PoseRefineResult, refine_poses

    n_data, r_data, g_data = _axis(mesh, "data")
    rows = (lambda t: t if t is None else _mesh.shard(t, n_data, r_data))
    with _mesh.data_parallel(g_data):
        res = refine_poses(rows(source), rows(target), cfg or PoseRefineConfig(),
                           generator, init_pose=rows(init_pose))
        return PoseRefineResult(
            pose_7d=_mesh.gather_rows(res.pose_7d), est_R=_mesh.gather_rows(res.est_R),
            est_t=_mesh.gather_rows(res.est_t),
            losses=_mesh.reduce_values(res.losses, "sum"),
            per_object_loss=_mesh.gather_rows(res.per_object_loss))
