"""Point-axis parallelism: distributed sort and sorted-order OT.

Counterpart of ``shwd_tpu/parallel/dist_sort.py``. When a cloud's N points
do not fit one card, the sort itself must be distributed. The point axis is
split over the ranks of a group (the ``points`` axis of
``make_points_mesh``), each rank holding a block of ``n_loc`` entries:

- ``dist_sort``          bitonic merge-split sort of block-distributed
                         arrays: one local sort, then log2(D)(log2(D)+1)/2
                         block exchanges with rank ``s ^ j``, each merging
                         two sorted blocks (a ``torch.sort``) and keeping
                         the low or the high half;
- ``dist_cumsum``        prefix sum: local scan plus an all-gather of the
                         block totals;
- ``dist_emd1d``         exact W_p^p on the line (rank alignment after two
                         distributed sorts, one all-reduce);
- ``dist_emd1d_circle``  exact W_1 on the circle by the level-median closed
                         form (as ``ops.ot1d.emd1d_circle``, wrap segment
                         included), the level median found by 42 bisection
                         steps on all-reduced masses;
- ``make_dist_ssw``      spherical sliced W_1 with the point axis split:
                         projections are local, sorts and circle OT
                         distributed.

Every function is called by every rank of the group with its own block.
Gradients flow through the exchanges (``_Shift``: the exchange with
``s ^ j`` is its own inverse, so its backward is the same exchange of the
gradient; the neighbour shift's backward shifts the other way), the sorts
and the collectives, under the convention of ``parallel.mesh``. The level
median is an argmin held constant, as the JAX package's ``stop_gradient``.
p >= 2 circular OT needs a global quantile alignment per bisection step; for
that, shard batch and slices instead (``sharded_ops.make_sharded_ssw``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import mesh as _mesh


def make_points_mesh(points: Optional[int] = None, data: int = 1,
                     device: str | torch.device | None = None) -> DeviceMesh:
    """A (data, points) mesh: batch over ``data``, point axis over
    ``points`` (by default every rank). Every rank must call it."""
    if points is None:
        points = _mesh.world_size() // data
    return _mesh.make_mesh(data, points, device, axes=("data", "points"))


def _world(group):
    return dist.group.WORLD if group is None else group


def _sendrecv(x: torch.Tensor, send_to: Optional[int], recv_from: Optional[int],
              group) -> torch.Tensor:
    """Send ``x`` to group rank ``send_to`` and receive a tensor like it from
    ``recv_from`` (zeros where None)."""
    out = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        _mesh.collective_calls += 1
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    """Differentiable point-to-point move: ``x`` goes to ``send_to``, the
    result comes from ``recv_from``; the backward moves the gradient back
    (for a pairwise exchange, the same exchange)."""

    @staticmethod
    def forward(ctx, x, send_to, recv_from, group):
        ctx.send_to, ctx.recv_from, ctx.group = send_to, recv_from, group
        return _sendrecv(x.detach(), send_to, recv_from, group)

    @staticmethod
    def backward(ctx, g):
        return _sendrecv(g.detach(), ctx.recv_from, ctx.send_to, ctx.group), None, None, None


class _AllGather(torch.autograd.Function):
    """(D, ...) stack of every rank's ``x``; the backward sums the gradient
    over the ranks and keeps this rank's slot."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        _mesh.collective_calls += 1
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone().contiguous()
        _mesh.collective_calls += 1
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


def _merge_split(x, payload, partner, keep_low, group):
    """Exchange blocks with ``partner``, merge, keep one half.
    x: (..., n_loc) sorted locally."""
    n_loc = x.shape[-1]
    both = torch.cat([x, _Shift.apply(x, partner, partner, group)], dim=-1)
    half = slice(0, n_loc) if keep_low else slice(n_loc, 2 * n_loc)
    if payload is None:
        return torch.sort(both, dim=-1).values[..., half], None
    other_p = _Shift.apply(payload, partner, partner, group)
    both_p = torch.cat([payload, other_p], dim=-1)
    merged, order = torch.sort(both, dim=-1, stable=True)
    merged_p = torch.gather(both_p, -1, order)
    return merged[..., half], merged_p[..., half]


def _size_of(num_devices, group):
    d = dist.get_world_size(group)
    if num_devices is not None and num_devices != d:
        raise ValueError(f"num_devices={num_devices}, but the group has {d} ranks")
    return d


def dist_sort(x: torch.Tensor, num_devices: Optional[int] = None,
              payload: Optional[torch.Tensor] = None, group=None):
    """Sort a block-distributed array along its last axis.

    x: (..., n_loc), this rank's block. After the call, rank r holds the
    global ranks [r n_loc, (r+1) n_loc) in ascending order. ``payload``
    (same shape) is carried through the permutation. The group's size must
    be a power of two. Returns ``sorted_x`` (or ``(sorted_x,
    sorted_payload)``).
    """
    group = _world(group)
    d = _size_of(num_devices, group)
    assert d & (d - 1) == 0, f"points axis size {d} must be a power of two"
    if payload is None:
        x = torch.sort(x, dim=-1).values
    else:
        x, order = torch.sort(x, dim=-1, stable=True)
        payload = torch.gather(payload, -1, order)
    idx = dist.get_rank(group)
    k = 2
    while k <= d:
        j = k // 2
        while j >= 1:
            ascending = (idx & k) == 0 if k < d else True
            keep_low = ascending == ((idx & j) == 0)
            x, payload = _merge_split(x, payload, idx ^ j, keep_low, group)
            j //= 2
        k *= 2
    return x if payload is None else (x, payload)


def dist_cumsum(w: torch.Tensor, num_devices: Optional[int] = None,
                group=None) -> torch.Tensor:
    """Inclusive prefix sum along a block-distributed last axis."""
    group = _world(group)
    d = _size_of(num_devices, group)
    local = torch.cumsum(w, dim=-1)
    totals = _AllGather.apply(local[..., -1], group)         # (D, ...)
    mask = (torch.arange(d, device=w.device) < dist.get_rank(group)).to(w.dtype)
    prefix = torch.tensordot(mask, totals, dims=([0], [0]))  # (...,)
    return local + prefix[..., None]


def dist_emd1d(u: torch.Tensor, v: torch.Tensor, num_devices: Optional[int] = None,
               p: float = 2, group=None) -> torch.Tensor:
    """Exact W_p^p on the line with the sample axis split (equal-size
    uniform measures). u, v: (..., n_loc) blocks; returns the (...,) mean of
    |sort(u) - sort(v)|^p over the global sample axis, on every rank."""
    group = _world(group)
    d = _size_of(num_devices, group)
    u = dist_sort(u, d, group=group)
    v = dist_sort(v, d, group=group)
    s = torch.sum(torch.abs(u - v) ** p, dim=-1)
    return _mesh.all_reduce(s, "sum", group) / (u.shape[-1] * d)


@torch.no_grad()
def _level_median_bisect(cdf: torch.Tensor, delta: torch.Tensor, group,
                         num_iter: int = 42) -> torch.Tensor:
    """Weighted median of ``cdf`` under weights ``delta`` whose sum over the
    group is 1. The CDF differences lie in [-1, 1] and are multiples of
    1/(n m), so 42 halvings of the width-2 interval are exact for any
    n m < 2^40. One all-reduce of the (...,) masses per step."""
    lo = torch.full(cdf.shape[:-1], -1.0, dtype=cdf.dtype, device=cdf.device)
    hi = torch.ones_like(lo)
    for _ in range(num_iter):
        mid = 0.5 * (lo + hi)
        below = torch.sum(delta * (cdf <= mid[..., None]), dim=-1)
        _mesh.collective_calls += 1
        dist.all_reduce(below, group=group)
        hit = below >= 0.5
        lo, hi = torch.where(hit, lo, mid), torch.where(hit, mid, hi)
    return hi


def dist_emd1d_circle(u: torch.Tensor, v: torch.Tensor,
                      num_devices: Optional[int] = None, group=None) -> torch.Tensor:
    """Exact W_1 on the circle [0, 1) with the sample axis split.

    The merged support (2 n_loc per rank) is sorted with the signed weights
    as payload, the CDF difference is a distributed cumsum, a segment's end
    at a block boundary is the next rank's first value (1.0 past the global
    end), and the leading wrap segment [0, min) sits on rank 0 with cdf 0.
    """
    group = _world(group)
    d = _size_of(num_devices, group)
    n, m = u.shape[-1] * d, v.shape[-1] * d
    idx = dist.get_rank(group)

    values = torch.cat([u, v], dim=-1)
    weights = torch.cat([torch.full_like(u, 1.0 / n), torch.full_like(v, -1.0 / m)],
                        dim=-1)
    values, weights = dist_sort(values, d, payload=weights, group=group)
    cdf_diff = dist_cumsum(weights, d, group=group)

    # the same ops on every rank (a rank's branch only picks constants), so
    # that every rank runs the backward's exchanges in the same order
    first = values[..., 0]
    last = 1.0 if idx == d - 1 else 0.0
    nxt = _Shift.apply(first, idx - 1 if idx > 0 else None,
                       idx + 1 if idx < d - 1 else None, group)
    nxt = nxt * (1.0 - last) + last
    ends = torch.cat([values[..., 1:], nxt[..., None]], dim=-1)
    delta = ends - values

    lead_w = first * (1.0 if idx == 0 else 0.0)
    delta_ext = torch.cat([lead_w[..., None], delta], dim=-1)
    cdf_ext = torch.cat([torch.zeros_like(cdf_diff[..., :1]), cdf_diff], dim=-1)

    med = _level_median_bisect(cdf_ext.detach(), delta_ext.detach(), group)
    s = torch.sum(delta_ext * torch.abs(cdf_ext - med[..., None]), dim=-1)
    return _mesh.all_reduce(s, "sum", group)


def make_dist_ssw(mesh: DeviceMesh, num_projections: int = 100) -> Callable:
    """Spherical sliced-W_1 with the POINT axis split over ``mesh``.

    Returns ``ssw(x, y, frames) -> scalar``: x, y (B, N, 3) as every rank
    holds them, frames (L, 3, 2). A rank takes its rows (``data``) and its
    block of points (``points``), projects them on the great circles, and
    the sorts and circle OT run across ``points``; the mean over the batch
    and the slices closes over ``data``. The value is the same on every
    rank.
    """
    from ..ops.spherical import project_to_circle   # the ops import this package

    d_pts = _mesh.axis_size(mesh, "points")
    d_data = _mesh.axis_size(mesh, "data")
    g_pts = mesh.get_group("points")
    g_data = mesh.get_group("data") if d_data > 1 else None
    r_pts, r_data = mesh.get_local_rank("points"), mesh.get_local_rank("data")

    def ssw(x, y, frames):
        x = _mesh.shard(_mesh.shard(x, d_data, r_data, 0), d_pts, r_pts, 1)
        y = _mesh.shard(_mesh.shard(y, d_data, r_data, 0), d_pts, r_pts, 1)
        ax = project_to_circle(x, frames[None])          # (B_loc, L, n_loc)
        ay = project_to_circle(y, frames[None])
        s = torch.mean(dist_emd1d_circle(ax, ay, d_pts, group=g_pts))
        return s if g_data is None else _mesh.all_reduce(s, "mean", g_data)

    return ssw
