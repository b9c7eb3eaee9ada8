"""Process groups and the (data, slices) mesh of the port.

Counterpart of ``shwd_tpu/parallel/mesh.py``. The JAX package drives every
device from one controller; here each device has a process of its own, and
every process runs the same program from the same seed (the same dataset,
the same weights, the same random draws). Two named axes, as in the JAX
package:

- ``data``:   the cloud batch is split over these ranks; a rank takes its
              rows (``shard``) and the results are reduced over its group;
- ``slices``: the L random projections of sliced OT are split over these
              ranks (``sharded_ops.make_sharded_ssw``); the trainer keeps
              replicas on it.

The backend is NCCL on the card and gloo on the CPU. A one-process world
needs no environment: ``make_mesh`` makes the group itself.

Gradients follow one convention. The objective is the mean over the ranks
of each rank's value, and the differentiable collectives here transpose to
match: a mean all-reduce's backward is a mean all-reduce, a sum's a sum, an
exchange's the same exchange. So the global gradient of a tensor every
rank holds (the model's weights) is the mean over the ranks of their
gradients (``reduce_gradients``), and that of a block only this rank holds
is its gradient divided by the number of ranks.

The trainer names its data group once, with ``data_parallel``; the few ops
whose single-device value is a batch-wide maximum, minimum or sum read it
through ``group_max`` / ``group_min`` / ``active_group``. With no group
active they return their input untouched.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

AXES = ("data", "slices")

# collectives issued through this module (the trainer reports them per step)
collective_calls = 0

_active_group: Optional[dist.ProcessGroup] = None


# -- bootstrap -------------------------------------------------------------------

def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> torch.device:
    """Join the default process group (``jax.distributed.initialize``'s
    counterpart) and return this rank's device.

    With no arguments it reads the ``torchrun`` environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). The backend
    is NCCL when CUDA is available, else gloo; with NCCL the rank's device
    is ``cuda:LOCAL_RANK`` and it becomes the current device. A world of one
    with no address needs no environment (an in-memory store).
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    device = (torch.device("cuda", local_rank) if backend == "nccl"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    return device


def world_size() -> int:
    """The number of ranks: the process group's, or before one exists the
    ``torchrun`` environment's (1 without one)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def make_mesh(data: Optional[int] = None, slices: int = 1,
              device: str | torch.device | None = None,
              ranks: Optional[Sequence[int]] = None,
              axes: tuple[str, str] = AXES) -> Optional[DeviceMesh]:
    """A (data, slices) ``DeviceMesh`` over ``ranks`` (all ranks by default),
    rank-major: ranks that differ only on ``slices`` are neighbours.
    ``axes`` renames the two axes (``dist_sort``'s mesh is (data, points)).

    Defaults: every rank on ``data``. ``data * slices`` must equal the number
    of ranks. With no process group yet it joins the ``torchrun`` world, or
    makes the one-process group (NCCL on the card, gloo on the CPU), as
    JAX's mesh works on one device with no bootstrap. Every rank of the
    world must call it; a rank outside ``ranks`` gets None.
    """
    dev = resolve_device(device)
    world = world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if data is None:
        data = len(ranks) // slices
    if data * slices != len(ranks) or not set(ranks) <= set(range(world)):
        raise ValueError(f"a {data}x{slices} mesh needs {data * slices} ranks; "
                         f"{len(ranks)} given of a world of {world}")
    if not dist.is_initialized():
        initialize_distributed(backend="nccl" if dev.type == "cuda" else "gloo")
    mesh = DeviceMesh(dev.type, torch.tensor(ranks).reshape(data, slices),
                      mesh_dim_names=axes)
    return mesh if dist.get_rank() in ranks else None


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


# -- the active data group ------------------------------------------------------

@contextlib.contextmanager
def data_parallel(group: Optional[dist.ProcessGroup]):
    """Make ``group`` the data group that the batch-wide reductions of the
    ops read (None: no group, every op local)."""
    global _active_group
    previous, _active_group = _active_group, group
    try:
        yield group
    finally:
        _active_group = previous


def active_group() -> Optional[dist.ProcessGroup]:
    return _active_group


def _pick(group: Optional[dist.ProcessGroup]) -> Optional[dist.ProcessGroup]:
    return _active_group if group is None else group


def group_size(group: Optional[dist.ProcessGroup] = None) -> int:
    group = _pick(group)
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup] = None) -> int:
    group = _pick(group)
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    global collective_calls
    collective_calls += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def group_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` reduced with MAX over the active data group (a copy, no
    gradient); ``t`` itself when no group is active."""
    if _active_group is None:
        return t
    return _all_reduce(t.detach().clone(), dist.ReduceOp.MAX, _active_group)


def group_min(t: torch.Tensor) -> torch.Tensor:
    """As ``group_max``, with MIN."""
    if _active_group is None:
        return t
    return _all_reduce(t.detach().clone(), dist.ReduceOp.MIN, _active_group)


def reduce_values(t: torch.Tensor, op: str = "mean",
                  group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """A detached copy of ``t`` summed or averaged over ``group`` (default:
    the active one); ``t`` itself when there is no group."""
    group = _pick(group)
    if group is None:
        return t
    out = _all_reduce(t.detach().clone(), dist.ReduceOp.SUM, group)
    return out / dist.get_world_size(group) if op == "mean" else out


# -- rows of a global batch -------------------------------------------------------

def shard(x: torch.Tensor, n: int, index: int, dim: int = 0) -> torch.Tensor:
    """Block ``index`` of ``n`` equal blocks of ``x`` along ``dim``."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{size} entries along dim {dim} do not split into "
                         f"{n} equal blocks")
    return x.narrow(dim, index * (size // n), size // n)


def shard_rows(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
               ) -> torch.Tensor:
    """This rank's rows of a global batch: block ``rank`` of the group."""
    return shard(x, group_size(group), group_rank(group))


def gather_rows(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                ) -> torch.Tensor:
    """The rows of every rank of ``group`` (default: the active one), in rank
    order, on every rank. No gradient."""
    global collective_calls
    group = _pick(group)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    collective_calls += 1
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim=0)


# -- gradients --------------------------------------------------------------------

def reduce_gradients(params: Iterable[torch.Tensor], op: str = "mean",
                     group: Optional[dist.ProcessGroup] = None) -> None:
    """Average (or sum) the ``.grad`` of ``params`` over ``group`` (default:
    the active one) in one flattened bucket; each ``.grad`` becomes a view
    of the reduced bucket. A no-op without a group."""
    group = _pick(group)
    if group is None:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    # every rank must send the same bucket, so a missing gradient is zeros
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in params])
    _all_reduce(flat, dist.ReduceOp.SUM, group)
    if op == "mean":
        flat.div_(dist.get_world_size(group))
    for p, chunk in zip(params, flat.split([p.numel() for p in params])):
        p.grad = chunk.view_as(p)


class _AllReduce(torch.autograd.Function):
    """Sum or mean over a group; the backward is the same reduction of the
    incoming gradients (the convention of the module docstring)."""

    @staticmethod
    def forward(ctx, x, op, group):
        ctx.op, ctx.group = op, group
        out = _all_reduce(x.detach().clone().contiguous(), dist.ReduceOp.SUM, group)
        return out / dist.get_world_size(group) if op == "mean" else out

    @staticmethod
    def backward(ctx, g):
        out = _all_reduce(g.detach().clone().contiguous(), dist.ReduceOp.SUM,
                          ctx.group)
        if ctx.op == "mean":
            out = out / dist.get_world_size(ctx.group)
        return out, None, None


def all_reduce(x: torch.Tensor, op: str = "mean",
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Differentiable sum or mean of ``x`` over ``group`` (default: the
    active one); ``x`` itself when there is no group."""
    group = _pick(group)
    if group is None:
        return x
    return _AllReduce.apply(x, op, group)
