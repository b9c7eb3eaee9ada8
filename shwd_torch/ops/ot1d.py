"""One-dimensional optimal transport: on the line and on the circle.

Counterpart of ``shwd_tpu/ops/ot1d.py``:

- ``emd1d``, ``emd1d_general``: exact W_p^p on the line by sorting;
- ``emd1d_circle``: exact W_1 on the circle [0, 1) by the level-median
  closed form, including the wrap segment [0, min sample);
- ``circle_ot``: exact W_p^p on the circle, batched over leading dims.
  Equal sizes at p == 2 take the exact vertex minimum through a circular
  correlation in f64 (``_circle_ot_p2_eq``); other equal-size problems bisect
  with contiguous windows (``_dcost_uniform_eq``); unequal sizes bisect
  with the uniform-grid searches (``_dcost_uniform``). Every bisection is
  32 fixed halvings with masked updates: no data-dependent exit, so no
  host sync.

Inputs are (..., n) float tensors along the last axis, uniform weights.
Sorts are stable (ties keep their order, as ``jax.lax.sort`` does), so the
gradient of tied values reaches the same inputs. The JAX package's
permutation-sort VJP (a TPU gather workaround) is ``torch.sort`` here.
"""

from __future__ import annotations

import torch

_HALVINGS = 32


def _sort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).values


def batched_searchsorted(a: torch.Tensor, q: torch.Tensor,
                         side: str = "left") -> torch.Tensor:
    """searchsorted along the last axis with broadcast leading dims:
    a (..., K) sorted, q (..., Q) -> (..., Q) insertion indices (int64),
    as a comparison count."""
    if side == "left":
        lt = a[..., None, :] < q[..., :, None]
    else:
        lt = a[..., None, :] <= q[..., :, None]
    return lt.sum(-1)


# ---------------------------------------------------------------------------
# W_p on the line
# ---------------------------------------------------------------------------

def emd1d(u: torch.Tensor, v: torch.Tensor, p: float = 2,
          require_sort: bool = True) -> torch.Tensor:
    """Exact W_p^p between empirical measures on the line: (...,), the mean
    of |sort(u) - sort(v)|^p (no root). Unequal sizes go to
    ``emd1d_general``."""
    if u.shape[-1] != v.shape[-1]:
        return emd1d_general(u, v, p=p, require_sort=require_sort)
    if require_sort:
        u, v = _sort(u), _sort(v)
    return torch.mean(torch.abs(u - v) ** p, dim=-1)


def emd1d_general(u: torch.Tensor, v: torch.Tensor, p: float = 2,
                  require_sort: bool = True) -> torch.Tensor:
    """Exact W_p^p on the line for any sizes: |F_u^-1 - F_v^-1|^p
    integrated over the merged CDF grid (n + m entries)."""
    n, m = u.shape[-1], v.shape[-1]
    if require_sort:
        u, v = _sort(u), _sort(v)
    u_cdf = torch.arange(1, n + 1, dtype=u.dtype, device=u.device) / n
    v_cdf = torch.arange(1, m + 1, dtype=v.dtype, device=v.device) / m
    grid = torch.sort(torch.cat([u_cdf.expand(u.shape), v_cdf.expand(v.shape)],
                                dim=-1), dim=-1).values
    delta = torch.diff(grid, dim=-1, prepend=torch.zeros_like(grid[..., :1]))
    # inverse CDF at the grid points: index ceil(grid * n) - 1
    ui = (torch.ceil(grid * n - 1e-9).long() - 1).clamp(0, n - 1)
    vi = (torch.ceil(grid * m - 1e-9).long() - 1).clamp(0, m - 1)
    u_icdf = torch.gather(u, -1, ui)
    v_icdf = torch.gather(v, -1, vi)
    return torch.sum(delta * torch.abs(u_icdf - v_icdf) ** p, dim=-1)


# ---------------------------------------------------------------------------
# W_1 on the circle: level-median closed form
# ---------------------------------------------------------------------------

def _sort_pair(keys: torch.Tensor, vals: torch.Tensor):
    """Stable sort of ``keys`` along the last axis, ``vals`` carried along."""
    keys_sorted, order = torch.sort(keys, dim=-1, stable=True)
    return keys_sorted, torch.gather(vals, -1, order)


def emd1d_circle(u: torch.Tensor, v: torch.Tensor,
                 require_sort: bool = True) -> torch.Tensor:
    """Exact W_1 between empirical measures on the circle [0, 1), sizes
    may differ: W_1 = integral over [0, 1) of |F_u - F_v - med|, med the
    level median of the CDF difference.

    The integral includes the wrap segment [0, min sample), where
    F_u - F_v = 0; leaving it out (as the original reference code does)
    biases W_1 low by O(1/n). Kept as in the JAX package.
    """
    n, m = u.shape[-1], v.shape[-1]
    if require_sort:
        u, v = _sort(u), _sort(v)
    values = torch.cat([u, v], dim=-1)
    weights = torch.cat([torch.full_like(u, 1.0 / n), torch.full_like(v, -1.0 / m)],
                        dim=-1)
    values_sorted, weights_sorted = _sort_pair(values, weights)
    cdf_diff = torch.cumsum(weights_sorted, dim=-1)

    # segments: [0, vs_0) with cdf 0 (wrap), [vs_k, vs_{k+1}), [vs_last, 1)
    zeros = torch.zeros_like(values_sorted[..., :1])
    seg_ends = torch.cat([values_sorted, torch.ones_like(zeros)], dim=-1)
    seg_starts = torch.cat([zeros, values_sorted], dim=-1)
    delta = seg_ends - seg_starts                       # (..., n+m+1)
    cdf_ext = torch.cat([zeros, cdf_diff], dim=-1)

    # the level median: weighted median of cdf_ext with weights delta
    cdf_sorted, w_sorted = _sort_pair(cdf_ext, delta.detach())
    csum = torch.cumsum(w_sorted, dim=-1) - 0.5
    csum = torch.where(csum < 0, torch.full_like(csum, float("inf")), csum)
    idx = torch.argmin(csum, dim=-1, keepdim=True)
    lev_med = torch.gather(cdf_sorted, -1, idx)
    return torch.sum(delta * torch.abs(cdf_ext - lev_med), dim=-1)


# ---------------------------------------------------------------------------
# W_p on the circle: closed-form searches on uniform grids
# ---------------------------------------------------------------------------
#
# With uniform weights both CDFs are arithmetic grids: u_cdf = (1..n)/n and
# the theta-shifted target CDF is c + i/m with c = (w+1)/m - tfrac, where
# w = #{k : k/m < tfrac} entries wrapped. Every search against such a grid
# is index arithmetic.

def _grid_searchsorted_left(q: torch.Tensor, n: int) -> torch.Tensor:
    """#{k in 1..n : k/n < q}. The tolerance is relative: at q*n ~ 1e3 the
    f32 ulp is ~1e-4, and exact grid hits must not round up."""
    qn = q * n
    tol = torch.abs(qn) * 1e-6 + 1e-7
    return (torch.ceil(qn - tol).long() - 1).clamp(0, n)


def _shifted_target_uniform(theta: torch.Tensor, v_sorted: torch.Tensor):
    """The target rolled by the cut ``theta`` (..., 1): (v_ext (..., m+1),
    c); v_ext[i] = v[(w+i) % m] + floor(theta) + (i >= m-w) plus one wrap
    entry, and the shifted CDF grid is c + i/m."""
    m = v_sorted.shape[-1]
    tfloor = torch.floor(theta)
    tfrac = theta - tfloor
    w = _grid_searchsorted_left(tfrac, m)                    # (..., 1) wraps
    i = torch.arange(m, device=v_sorted.device)
    idx = (w + i) % m
    v_vals = torch.gather(v_sorted.expand(*idx.shape[:-1], m), -1, idx)
    v_vals = v_vals + tfloor + (i >= (m - w)).to(v_sorted.dtype)
    v_ext = torch.cat([v_vals, v_vals[..., :1] + 1.0], dim=-1)
    c = (w + 1).to(v_sorted.dtype) / m - tfrac
    return v_ext, c


def _dcost_uniform(theta, u_sorted, v_sorted, p):
    """Left derivative of the circle cost with respect to the cut theta."""
    n, m = u_sorted.shape[-1], v_sorted.shape[-1]
    v_ext, c = _shifted_target_uniform(theta, v_sorted)
    q = c + torch.arange(m, dtype=u_sorted.dtype, device=u_sorted.device) / m
    u_idx = _grid_searchsorted_left(q, n).clamp(0, n - 1)
    u_icdf = torch.gather(u_sorted.expand(*u_idx.shape[:-1], n), -1, u_idx)
    return torch.sum(torch.abs(u_icdf - v_ext[..., 1:]) ** p
                     - torch.abs(u_icdf - v_ext[..., :-1]) ** p,
                     dim=-1, keepdim=True)


def _cost_at_uniform(theta, u_sorted, v_sorted, p):
    """The circle transport cost at the cut theta (one merge sort of the
    two CDF grids; the searches are closed form)."""
    n, m = u_sorted.shape[-1], v_sorted.shape[-1]
    dtype, dev = u_sorted.dtype, u_sorted.device
    v_ext, c = _shifted_target_uniform(theta, v_sorted)
    u_cdf = (torch.arange(1, n + 1, dtype=dtype, device=dev) / n).expand(u_sorted.shape)
    v_cdf_t = (c + torch.arange(m, dtype=dtype, device=dev) / m).expand(v_sorted.shape)
    cdf_axis = torch.sort(torch.cat([u_cdf, v_cdf_t], dim=-1), dim=-1).values
    delta = torch.diff(cdf_axis, dim=-1, prepend=torch.zeros_like(cdf_axis[..., :1]))

    u_idx = _grid_searchsorted_left(cdf_axis, n).clamp(0, n - 1)
    u_icdf = torch.gather(u_sorted, -1, u_idx)

    # the v grid starts at c with step 1/m: #{i : c + i/m < q} = ceil((q - c) m)
    qm = (cdf_axis - c) * m
    v_idx = torch.ceil(qm - torch.abs(qm) * 1e-6 - 1e-7).long().clamp(0, m)
    v_ext2 = torch.cat([v_ext, v_ext[..., :1] + 1.0], dim=-1)
    v_icdf = torch.gather(v_ext2, -1, v_idx)
    return torch.sum(delta * torch.abs(u_icdf - v_icdf) ** p, dim=-1)


# -- equal sizes: every roll is a contiguous window --------------------------

def _batch_slice(a: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """Per-row contiguous slice: a (B, K), starts (B,) -> (B, size); starts
    are clamped to [0, K - size] (``dynamic_slice``'s rule)."""
    starts = starts.clamp(0, a.shape[-1] - size)
    idx = starts[:, None] + torch.arange(size, device=a.device)
    return torch.gather(a, -1, idx)


def _dcost_uniform_eq(theta, pu, v3, n, p):
    """``_dcost_uniform`` for n == m: theta (B, 1); pu (B, 3n) the sorted
    source edge-padded, [u0 x (n+1), u, u_{n-1} x (n-1)]; v3 (B, 2n+1) =
    [v, v+1, v0+2]. Two contiguous windows per row."""
    tfloor = torch.floor(theta)
    tfrac = theta - tfloor
    w = _grid_searchsorted_left(tfrac, n)                    # (B, 1) wraps
    v_ext = _batch_slice(v3, w[:, 0], n + 1) + tfloor
    c = (w + 1).to(pu.dtype) / n - tfrac
    cn = c * n
    tol = torch.abs(cn) * 1e-6 + 1e-7
    k0 = torch.ceil(cn - tol).long() - 1                     # (B, 1)
    u_icdf = _batch_slice(pu, k0[:, 0] + (n + 1), n)         # u[clip(k0 + i)]
    return torch.sum(torch.abs(u_icdf - v_ext[..., 1:]) ** p
                     - torch.abs(u_icdf - v_ext[..., :-1]) ** p,
                     dim=-1, keepdim=True)


def _cost_at_uniform_eq(theta, u_sorted, v_sorted, p):
    """Circle cost at theta for n == m: c = (w+1)/n - tfrac lies in
    (0, 1/n], so source atom i meets target atoms i and i+1 with masses
    c and 1/n - c. One contiguous roll of v, the rest elementwise."""
    n = u_sorted.shape[-1]
    tfloor = torch.floor(theta)
    tfrac = theta - tfloor
    w = _grid_searchsorted_left(tfrac, n)
    v3 = torch.cat([v_sorted, v_sorted + 1.0, v_sorted[..., :1] + 2.0], dim=-1)
    v_ext = _batch_slice(v3, w[:, 0], n + 1) + tfloor        # (B, n+1)
    c = (w + 1).to(u_sorted.dtype) / n - tfrac               # in (0, 1/n]
    return torch.sum(c * torch.abs(u_sorted - v_ext[..., :-1]) ** p
                     + (1.0 / n - c) * torch.abs(u_sorted - v_ext[..., 1:]) ** p,
                     dim=-1)


# -- p == 2, equal sizes: the exact vertex minimum ---------------------------
#
# For uniform equal-size measures the cost as a function of the cut is
# piecewise linear, with vertices at the alignments j of the sorted source
# against the window j of the tripled target V3 = [v-1, v, v+1]
# (j = 0..2n covers theta in [-1, 1]); so min over theta = min_j A(j)/n
# with A(j) = sum_i |u_i - V3[j+i]|^2 = sum u^2 + windowsum(V3^2)(j)
# - 2 corr(j). corr(j) = cc(j mod n) + S(clip(n-j)) + S(clip(2n-j)) - sum u,
# cc the circular cross-correlation of period n and S the suffix sums of
# u. The scan over A only selects j; the cost is evaluated exactly (and
# differentiably) at the chosen window, in the inputs' precision.
#
# The scan runs in f64. Its terms are O(n) while the gaps between
# near-optimal alignments are not: in f32 (the JAX package's DFT matmuls)
# A's rounding at n = 1024 is ~1e-4, and two FFTs (the CPU's and cuFFT)
# then pick windows whose costs differ by ~1e-4 relative.

def _corr_windows(ud: torch.Tensor, vd: torch.Tensor) -> torch.Tensor:
    """corr(j) = sum_i u_i V3[j+i], j = 0..2n, for sorted, detached
    ud, vd (B, n)."""
    n = ud.shape[-1]
    cc = torch.fft.irfft(torch.conj(torch.fft.rfft(ud, dim=-1))
                         * torch.fft.rfft(vd, dim=-1), n=n, dim=-1)
    csum = torch.cumsum(ud, dim=-1)
    total = csum[..., -1:]
    s = torch.cat([total, total - csum], dim=-1)             # S[k], k = 0..n
    s_rev = torch.flip(s, dims=(-1,))                        # S[n-j], j = 0..n
    t1 = torch.cat([s_rev, total.expand(*total.shape[:-1], n)], dim=-1)
    t2 = torch.cat([torch.zeros_like(ud), s_rev], dim=-1)
    cc3 = torch.cat([cc, cc, cc[..., :1]], dim=-1)
    return cc3 + t1 + t2 - total


def _circle_ot_p2_eq(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact W_2^2 on the circle, n == m: u, v (B, n) sorted in [0, 1) ->
    (B,)."""
    n = u.shape[-1]
    v3 = torch.cat([v - 1.0, v, v + 1.0], dim=-1)                # (B, 3n)
    ud, vd = u.detach().double(), v.detach().double()
    v3d = torch.cat([vd - 1.0, vd, vd + 1.0], dim=-1)
    corr = _corr_windows(ud, vd)                                 # (B, 2n+1)
    csum = torch.cumsum(v3d * v3d, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    s2 = csum[..., n:3 * n + 1] - csum[..., :2 * n + 1]
    u2 = torch.sum(ud * ud, dim=-1, keepdim=True)
    a = u2 + s2 - 2.0 * corr
    j_star = torch.argmin(a, dim=-1)
    win = _batch_slice(v3, j_star, n)
    return torch.mean((u - win) ** 2, dim=-1)


def _bisect(dcost, theta_like: torch.Tensor, max_iter: int) -> torch.Tensor:
    """``max_iter`` halvings of [-1, 1] towards the sign change of the
    derivative, masked per problem; returns the detached midpoint."""
    tm = torch.zeros_like(theta_like) - 1.0
    tp = torch.zeros_like(theta_like) + 1.0
    for _ in range(max_iter):
        tc = (tm + tp) / 2.0
        go_right = dcost(tc) < 0        # derivative negative: optimum right of tc
        tm = torch.where(go_right, tc, tm)
        tp = torch.where(go_right, tp, tc)
    return ((tm + tp) / 2.0).detach()


def circle_ot(u: torch.Tensor, v: torch.Tensor, p: float = 2,
              max_iter: int = _HALVINGS, require_sort: bool = True) -> torch.Tensor:
    """Exact W_p^p on the circle (p >= 1), batched over leading dims: the
    Delon-Salomon-Sobolevski search on the cut shift with a fixed number
    of masked halvings (32 halvings of [-1, 1] reach ~5e-10), or the exact
    vertex minimum for p == 2 with equal sizes. Gradients flow through the
    final cost evaluation with the cut detached (exact by the envelope
    theorem)."""
    if require_sort:
        u, v = _sort(u), _sort(v)
    n, m = u.shape[-1], v.shape[-1]
    batch_shape = u.shape[:-1]

    if n == m and p == 2:
        return _circle_ot_p2_eq(u.reshape(-1, n), v.reshape(-1, n)).reshape(batch_shape)

    if n == m:
        uf, vf = u.reshape(-1, n), v.reshape(-1, n)
        ud, vd = uf.detach(), vf.detach()
        pu = torch.cat([ud[:, :1].expand(-1, n + 1), ud,
                        ud[:, -1:].expand(-1, n - 1)], dim=-1)
        v3 = torch.cat([vd, vd + 1.0, vd[:, :1] + 2.0], dim=-1)
        tc = _bisect(lambda t: _dcost_uniform_eq(t, pu, v3, n, p), uf[:, :1], max_iter)
        return _cost_at_uniform_eq(tc, uf, vf, p).reshape(batch_shape)

    ud, vd = u.detach(), v.detach()
    tc = _bisect(lambda t: _dcost_uniform(t, ud, vd, p), ud[..., :1], max_iter)
    return _cost_at_uniform(tc, u, v, p)
