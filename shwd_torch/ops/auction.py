"""Exact assignment OT: batched eps-scaled Jacobi auction (kernel K2).

Counterpart of ``shwd_tpu/ops/auction.py``. Bertsekas' auction with
synchronous bidding solves the equal-size uniform-marginal transport
problem (an assignment problem by Birkhoff) to within N * eps_final of
optimal. ``auction_assignment`` launches the CUDA kernel
``csrc/auction.cu`` for a CUDA tensor (the whole eps ladder in one launch,
a thread-block cluster per problem, no host round trip) and runs
``auction_assignment_reference``, its plain PyTorch version, for a CPU
tensor.

The hybrid solver warms the auction's prices with annealed-Sinkhorn duals
(``_sinkhorn_warm_prices``); its gradient is the optimal permutation / N,
the envelope gradient of exact EMD.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..parallel.mesh import group_max, group_min
from ..utils.profiling import device_span
from .sinkhorn import emd2_approx
from .sinkhorn_kernels import emd2_warmup, warmup_supported

_NEG = -1e30
_MAX_PHASES = 64          # guards a NaN or infinite eps0 (as the kernel does)
_SMEM_LIMIT = 232448      # shared memory one H100 block can use
_SMEM_STATIC = 512        # of it, the kernel's static part (rounded up)


def _screen_seed(assign0: torch.Tensor, n: int) -> torch.Tensor:
    """Out-of-range entries become -1, and every pair whose object is
    claimed more than once is dropped (a duplicated seed would otherwise
    corrupt the owner map)."""
    a = torch.where((assign0 >= 0) & (assign0 < n), assign0,
                    torch.full_like(assign0, -1))
    slot = torch.where(a >= 0, a, n).long()
    counts = torch.zeros(a.shape[0], n + 1, dtype=torch.int32,
                         device=a.device).scatter_add_(
        1, slot, torch.ones_like(a))
    dup = counts.gather(1, slot) > 1
    return torch.where(dup | (a < 0), torch.full_like(a, -1), a)


def _invert(mapping: torch.Tensor, size: int) -> torch.Tensor:
    """Inverse of a partial one-to-one map, -1 where nothing maps: person ->
    object from object -> person, and the other way round."""
    b, k = mapping.shape
    out = torch.full((b, size + 1), -1, dtype=torch.int32, device=mapping.device)
    slot = torch.where(mapping >= 0, mapping, size).long()
    ids = torch.arange(k, dtype=torch.int32, device=mapping.device).expand(b, k)
    out.scatter_(1, slot, ids)               # dummy slot `size` collects the -1s
    return out[:, :size].contiguous()


def _auction_phase(cost, prices, eps, max_sweeps, assign):
    """One eps-phase, plain PyTorch. Keeps the carried pairs that satisfy
    eps-CS at THIS eps, then bids until every person is assigned or
    ``max_sweeps``. ``eps`` is a 0-dim f32 tensor. Returns (assign,
    prices, per-item sweeps)."""
    b, n, m = cost.shape
    benefit = -cost
    value0 = benefit - prices[:, None, :]
    best0 = torch.amax(value0, dim=-1)
    v_own = value0.gather(-1, assign.clamp_min(0).long()[..., None])[..., 0]
    keep = (assign >= 0) & (v_own >= best0 - eps)
    assign = torch.where(keep, assign, torch.full_like(assign, -1))
    owner = _invert(assign, m)
    sweeps = torch.zeros(b, dtype=torch.int32, device=cost.device)
    neg = torch.tensor(_NEG, dtype=cost.dtype, device=cost.device)
    for _ in range(max_sweeps):
        unassigned = assign < 0
        active = unassigned.any(-1)
        if not bool(active.any()):            # host sync once per sweep
            break
        value = benefit - prices[:, None, :]
        best = torch.amax(value, dim=-1)
        jbest = torch.argmax(value, dim=-1)   # lowest index on ties
        masked = value.scatter(-1, jbest[..., None], _NEG)
        second = torch.amax(masked, dim=-1)
        bid = prices.gather(1, jbest) + (best - second) + eps
        bid = torch.where(unassigned, bid, neg)
        bids_mat = torch.full_like(cost, _NEG).scatter_(
            2, jbest[..., None], bid[..., None])
        win_bid = torch.amax(bids_mat, dim=1)
        win_person = torch.argmax(bids_mat, dim=1).to(torch.int32)
        got = win_bid > _NEG / 2
        prices = torch.where(got, win_bid, prices)
        owner = torch.where(got, win_person, owner)
        assign = _invert(owner, n)
        sweeps += active.to(torch.int32)
    return assign, prices, sweeps


def auction_assignment_reference(cost: torch.Tensor, eps_final: float = 1e-6,
                                 scale_factor: float = 6.0,
                                 max_sweeps: int = 2000,
                                 prices0: torch.Tensor | None = None,
                                 eps0: torch.Tensor | float | None = None,
                                 assign0: torch.Tensor | None = None):
    """Plain PyTorch version of the auction kernel: the JAX package's
    ``_auction_phase`` plus its eps ladder, with the caller's seed screened
    for duplicates. Syncs with the host once per sweep. Same arguments and
    results as ``auction_assignment``."""
    cost = cost.detach()
    b, n, m = cost.shape
    if n != m:
        raise ValueError("the auction solves the equal-size assignment case")
    f32 = dict(dtype=cost.dtype, device=cost.device)
    if eps0 is None:
        eps0 = torch.clamp_min(cost.max() - cost.min(), 1e-12) / 8.0
    eps = torch.as_tensor(eps0, **f32).reshape(())
    ef = torch.tensor(eps_final, **f32)
    # a tensor, so that eps / scale is a true division on every device (by a
    # Python number, CUDA multiplies with the rounded reciprocal: 1 ulp off)
    scale = torch.tensor(scale_factor, **f32)
    prices = (torch.zeros(b, m, **f32) if prices0 is None
              else prices0.detach().to(**f32))
    assign = (torch.full((b, n), -1, dtype=torch.int32, device=cost.device)
              if assign0 is None else
              _screen_seed(assign0.to(torch.int32), n))
    total = torch.zeros(b, dtype=torch.int32, device=cost.device)
    for _ in range(_MAX_PHASES):
        assign, prices, s = _auction_phase(cost, prices, torch.maximum(eps, ef),
                                           max_sweeps, assign)
        total += s
        done = not bool(eps > ef)
        eps = eps / scale
        if done:
            break
    return assign, prices, total


def _lib():
    lib = _kernels.load("auction")
    fn = lib.shwd_auction
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, cf, cf, ci, ci,
                       vp]
        fn.restype = ci
        lib.shwd_auction_max_clusters.argtypes = [ci, ci, vp]
        lib.shwd_auction_max_clusters.restype = ci
    return lib


_CLUSTER_SIZES = (16, 8, 4, 2, 1)      # what the kernel takes
_cluster16_fits: dict[tuple[int, int], bool] = {}


def _pick_cluster(batch: int, sms: int, fits16) -> int:
    """CTAs per problem: 16 where ``batch`` such clusters fit on ``sms`` SMs
    at once and ``fits16()`` says the card can place one (16 is beyond the
    portable cluster size), else 1. These are the two layouts with a
    measured gain: 16 on the flow's single seeded solve, whose phases are
    screens of all rows, and 1 on a batch that fills the card by itself.
    The sizes between are left to callers that force them."""
    return 16 if batch * 16 <= sms and fits16() else 1


def _device_fits16(dev: torch.device, n: int) -> bool:
    """Whether ``dev`` reports room for at least one 16-CTA cluster of the
    kernel at ``n`` objects (asked once per device and size)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, n)
    if key not in _cluster16_fits:
        count = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _lib().shwd_auction_max_clusters(n, 16, ctypes.byref(count))
        _kernels.check(rc, "auction cluster occupancy")
        _cluster16_fits[key] = count.value > 0
    return _cluster16_fits[key]


def _auction_launch(cost, eps_final, scale_factor, max_sweeps, prices0, eps0,
                    assign0, cluster=None):
    """Launch the kernel. Returns (assign, prices, sweeps, rows): ``rows``
    counts the cost rows each problem scanned (for the operations bound).
    ``cluster`` forces the CTAs per problem (1, 2, 4, 8 or 16); by default
    ``_pick_cluster`` chooses it from the batch size. The result does not
    depend on it."""
    if cost.dtype != torch.float32 or cost.ndim != 3:
        raise ValueError(f"auction needs a (B, N, N) f32 cost, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    b, n, m = cost.shape
    if n != m:
        raise ValueError("the auction solves the equal-size assignment case")
    if n * 24 + _SMEM_STATIC > _SMEM_LIMIT:
        raise ValueError(f"auction kernel holds N <= {(_SMEM_LIMIT - _SMEM_STATIC) // 24}"
                         f" objects in shared memory, got {n}")
    dev = cost.device
    if prices0 is None:
        prices0 = torch.zeros(b, n, dtype=torch.float32, device=dev)
    if eps0 is None:
        eps0 = torch.clamp_min(cost.max() - cost.min(), 1e-12) / 8.0
    eps0 = torch.as_tensor(eps0, dtype=torch.float32, device=dev).reshape(1)
    tensors = [cost, prices0, eps0] + ([] if assign0 is None else [assign0])
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("auction inputs must be contiguous and on "
                             f"{dev}")
    if prices0.dtype != torch.float32 or tuple(prices0.shape) != (b, n):
        raise ValueError("prices0 must be (B, N) f32")
    if assign0 is not None and (assign0.dtype != torch.int32
                                or tuple(assign0.shape) != (b, n)):
        raise ValueError("assign0 must be (B, N) int32")
    assign = torch.empty(b, n, dtype=torch.int32, device=dev)
    prices = torch.empty(b, n, dtype=torch.float32, device=dev)
    sweeps = torch.empty(b, dtype=torch.int32, device=dev)
    rows = torch.empty(b, dtype=torch.int32, device=dev)
    if cluster is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        cluster = _pick_cluster(b, sms, lambda: _device_fits16(dev, n))
    elif cluster not in _CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {_CLUSTER_SIZES}, got {cluster}")
    with torch.cuda.device(dev), device_span("k2"):
        rc = _lib().shwd_auction(
            cost.data_ptr(), prices0.data_ptr(), eps0.data_ptr(),
            None if assign0 is None else assign0.data_ptr(),
            assign.data_ptr(), prices.data_ptr(), sweeps.data_ptr(),
            rows.data_ptr(), b, n, eps_final, scale_factor, max_sweeps,
            cluster, _kernels.stream_ptr(cost))
    _kernels.check(rc, f"auction_assignment (cluster size {cluster})")
    _auction_launch.last_cluster = cluster
    return assign, prices, sweeps, rows


_auction_launch.last_cluster = None      # CTAs per problem of the last launch


def auction_assignment(cost: torch.Tensor, eps_final: float = 1e-6,
                       scale_factor: float = 6.0, max_sweeps: int = 2000,
                       prices0: torch.Tensor | None = None,
                       eps0: torch.Tensor | float | None = None,
                       assign0: torch.Tensor | None = None):
    """Solve min_perm mean_i C[i, perm(i)] for a batch of square costs.

    cost: (B, N, N) f32. Returns (assignment (B, N) int32, final dual
    prices (B, N), sweeps (B,) int32). eps-scaling: eps starts at
    ``eps0`` (default (max C - min C)/8 over the whole batch) and divides by
    ``scale_factor`` until <= eps_final; each phase is capped at
    ``max_sweeps`` sweeps. ``prices0`` warm-starts the prices, ``assign0``
    seeds the first phase's matching (pairs failing the eps-CS screen
    re-enter the auction; out-of-range and duplicated objects are dropped
    first, so any seed is safe).

    ``sweeps`` is per item. The JAX package returns one number, the sum
    over phases of the batch's largest sweep count; the assignment and the
    prices are the same either way, because an item with nobody left
    unassigned does nothing on the batch's later sweeps.

    A CUDA tensor goes through the CUDA kernel (one launch, no host sync);
    a CPU tensor through ``auction_assignment_reference``.
    """
    if not cost.is_cuda:
        return auction_assignment_reference(cost, eps_final, scale_factor,
                                            max_sweeps, prices0, eps0, assign0)
    assign, prices, sweeps, _ = _auction_launch(
        cost.detach(), eps_final, scale_factor, max_sweeps,
        None if prices0 is None else prices0.detach(), eps0, assign0)
    auction_assignment.launches += 1
    return assign, prices, sweeps


auction_assignment.launches = 0


def _assignment_cost(cost: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    picked = cost.gather(-1, assign.long()[..., None])[..., 0]
    return picked.mean(-1)


def _sinkhorn_warm_prices(cost, sink_eps, sink_iters, sink_scales):
    """Annealed-Sinkhorn dual potentials as auction starting prices.

    The dispatch rule is the JAX package's, with ``is_cuda`` for "on the
    accelerator": the warm-up kernel once N*M >= 512^2 and the shape passes
    ``warmup_supported``; smaller problems take the plain batched
    ``emd2_approx`` (batch-global eps0), as they do in JAX.
    """
    cost = cost.detach()
    if (cost.is_cuda and cost.ndim == 3
            and cost.shape[-2] * cost.shape[-1] >= 512 * 512
            and warmup_supported(cost.shape[-2], cost.shape[-1])):
        _, f, g = emd2_warmup(cost.contiguous(), eps=sink_eps,
                              num_iters=sink_iters, num_scales=sink_scales)
    else:
        _, f, g = emd2_approx(cost, eps=sink_eps, num_iters=sink_iters,
                              num_scales=sink_scales, return_potentials=True)
    return -g                      # benefit = -C; dual price ~ g


def _hybrid_eps0(cost: torch.Tensor, eps_final: float) -> torch.Tensor:
    # well below the cost range (the warm prices carry the coarse structure)
    # but high enough to repair unconverged duals; range over the whole batch
    # (under a data-parallel fit, over every rank's block of the batch)
    c_range = torch.clamp_min(group_max(cost.max()) - group_min(cost.min()), 1e-12)
    return torch.clamp_min(c_range * 1e-4, eps_final * 10.0)


# public names for callers outside the module (the benchmark's kernel
# probes); the private names stay while portbench reads them
sinkhorn_warm_prices = _sinkhorn_warm_prices
hybrid_eps0 = _hybrid_eps0


def _hybrid_assignment(cost, eps_final, sink_eps=1e-5, sink_iters=100,
                       sink_scales=8, max_sweeps=4000):
    """Annealed-Sinkhorn duals -> auction cleanup -> exact permutation."""
    cost = cost.detach()
    prices0 = _sinkhorn_warm_prices(cost, sink_eps, sink_iters, sink_scales)
    assign, _, sweeps = auction_assignment(
        cost.contiguous(), eps_final, max_sweeps=max_sweeps,
        prices0=prices0.contiguous(), eps0=_hybrid_eps0(cost, eps_final))
    # sweep-cap safety: a person still unassigned takes its row argmin
    assign = torch.where(assign < 0,
                         torch.argmin(cost, dim=-1).to(torch.int32), assign)
    return assign, sweeps


def _permutation_plan(assign: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(assign.long(), n).to(dtype) / n


class _HybridEMD2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cost, eps_final, sink_eps, sink_iters, sink_scales):
        assign, _ = _hybrid_assignment(cost, eps_final, sink_eps, sink_iters,
                                       sink_scales)
        ctx.save_for_backward(assign)
        ctx.n = cost.shape[-1]
        return _assignment_cost(cost, assign)

    @staticmethod
    def backward(ctx, g):
        (assign,) = ctx.saved_tensors
        plan = _permutation_plan(assign, ctx.n, g.dtype)
        return g[:, None, None] * plan, None, None, None, None


def hybrid_emd2(cost: torch.Tensor, eps_final: float = 1e-7,
                sink_eps: float = 1e-5, sink_iters: int = 100,
                sink_scales: int = 8) -> torch.Tensor:
    """Exact EMD for (B, N, N) uniform problems, all on the device:
    annealed Sinkhorn for the duals, then the warm-started auction for the
    exact permutation. Differentiable wrt cost: gradient = permutation / N."""
    return _HybridEMD2.apply(cost, eps_final, sink_eps, sink_iters, sink_scales)


class _AuctionEMD2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cost, eps_final):
        assign, _, _ = auction_assignment(cost.detach().contiguous(), eps_final)
        ctx.save_for_backward(assign)
        ctx.n = cost.shape[-1]
        return _assignment_cost(cost, assign)

    @staticmethod
    def backward(ctx, g):
        (assign,) = ctx.saved_tensors
        plan = _permutation_plan(assign, ctx.n, g.dtype)
        return g[:, None, None] * plan, None


def auction_emd2(cost: torch.Tensor, eps_final: float = 1e-6) -> torch.Tensor:
    """Exact (to N * eps_final) EMD <P*, C> for (B, N, N) uniform problems,
    from cold prices. Differentiable wrt cost: gradient = permutation / N."""
    return _AuctionEMD2.apply(cost, eps_final)


def hybrid_assignment_warm(cost: torch.Tensor, assign0: torch.Tensor | None,
                           prices0: torch.Tensor | None, *, use_warm: bool,
                           eps_final: float = 1e-7, sink_eps: float = 5e-3,
                           sink_iters: int = 50, sink_scales: int = 4,
                           max_sweeps: int = 4000):
    """Exact assignment with an optional warm matching.

    ``assign0``/``prices0``: a matching and duals from a solve on a NEARBY
    cost (the same clouds through phi one Adam step earlier). Warm, the
    auction starts from them; cold, the annealed-Sinkhorn warm-up prices it.
    Warmth only buys sweeps, never exactness: the eps ladder screens and
    repairs every pair.

    ``use_warm`` picks the branch at the call site. The JAX package decides
    on the device from ``any(assign0 >= 0)``; in eager PyTorch that test
    would be a host sync, and the caller knows the answer (the SHWD loss:
    the first inner solve is cold, every later solve of a call warm).
    Cold, ``assign0`` and ``prices0`` are ignored and may be None.

    Not differentiable: callers gather the value from the undetached cost
    at ``assign_value``, which gives the envelope gradient. Returns
    (assign_value, assign_warm, prices, sweeps): ``assign_value`` is
    argmin-patched for the gather; ``assign_warm`` keeps -1 for any
    sweep-cap stragglers so it is always a safe seed.
    """
    cost = cost.detach()
    if use_warm:
        prices = prices0.detach()
        seed = assign0
    else:
        prices = _sinkhorn_warm_prices(cost, sink_eps, sink_iters, sink_scales)
        seed = None
    assign, prices, sweeps = auction_assignment(
        cost.contiguous(), eps_final, max_sweeps=max_sweeps,
        prices0=prices.contiguous(), eps0=_hybrid_eps0(cost, eps_final),
        assign0=None if seed is None else seed.to(torch.int32).contiguous())
    assign_value = torch.where(
        assign < 0, torch.argmin(cost, dim=-1).to(torch.int32), assign)
    return assign_value, assign, prices, sweeps


def hybrid_warm_sentinel(batch: int, n: int, dtype=torch.float32,
                         device: str | torch.device = "cpu"):
    """The 'no warm matching yet' state for ``hybrid_assignment_warm``."""
    return (torch.full((batch, n), -1, dtype=torch.int32, device=device),
            torch.zeros((batch, n), dtype=dtype, device=device))
