// Fused point-cloud Sinkhorn: cost tile from the raw clouds plus the whole
// eps-scaled log-domain schedule in one launch.
//
// Replaces: shwd_tpu/ops/sinkhorn_pallas.py::_fused_forward (kernel
// _make_kernel), the VMEM-resident solver behind sinkhorn_points /
// emd2_points, the default transport of the W_COS registration trainer.
//
// What it computes, per batch item of x (B, N, 3), y (B, M, 3):
//   C_ij from the points: lp p=2 as a sum of squared differences; cosine
//   (1 - cos)^p and geodesic arccos(clip(cos))^p with
//   cos = x.y / (sqrt(max(|x|^2, 1e-16)) sqrt(max(|y|^2, 1e-16)));
//   eps0 = max |C| over the item; temperatures
//   e_s = exp(log eps0 (1 - r) + log eps r), r = s / max(S - 1, 1);
//   scaled potentials phi = f / e, gam = g / e, rescaled by e_prev / e at
//   each new temperature; per temperature the tile Ce = C / e (a division,
//   as the TPU kernel) and num_iters rounds of
//     phi_i = -(max_j z + log sum_j exp(z - max)),  z = gam_j - (Ce_ij - log b)
//     gam_j = -(max_i z + log sum_i exp(z - max)),  z = phi_i - (Ce_ij - log a)
//   then f = e_last phi, g = e_last gam and
//   val = sum_ij exp((f_i + g_j - C_ij) / eps + log a + log b) C_ij.
//   Forward only; the gradient is taken outside from f and g.
//
// What bounds it on the H100: one exp per cost entry per half-iteration,
// B N M (2 S I + 1) transcendentals (0.84 G at B=128, N=M=128, 50 x 4),
// about 0.20 ms on the special-function units; the f32 work around each exp
// is a third of that and the bytes (the clouds in, val, f, g out) nothing.
//
// Two routes, chosen by shape in the wrapper (ops/sinkhorn_fused.py::
// pick_route); a failed build or launch of either raises.
//
// Register route (N, M <= 128, every main path): the item's tile lives in
// registers for a whole temperature, so an iteration reads no cost from
// memory and the f-update stays inside each warp.
//   - One CTA of 1024 threads per item, __launch_bounds__(1024, 1): 32
//     warps on the SM. Warp w owns rows 4 w .. 4 w + 3, lane l the columns
//     l, l + 32, l + 64, l + 96 (conflict-free reads of gam): each thread
//     holds a 4 x 4 block of Ce = C / e, rebuilt once per temperature by
//     the division from the points in shared memory (the cost recomputed
//     by the same code, so the same bits). Entries past a ragged edge hold
//     +inf: their exp is 0.
//   - log a and log b enter as scalars (z = gam - (Ce - log b), z = phi -
//     (Ce - log a)), so one tile serves both updates; when N == M the tile
//     holds Ce - log a, one subtraction per entry.
//   - f-update: z once into registers; the row maxima over the registers,
//     then a reduce-scatter over the lanes for the warp's 4 rows together
//     (each lane ends with one row's result: 6 shuffles, not 20); exactly
//     one exp per entry; the sums the same way. Every lane then holds phi
//     of its warp's rows: no shared-memory write and no barrier.
//   - g-update: each warp forms a (max, sum) pair per column over its 4
//     rows (one exp per entry) and stores it; barrier 1; warp v merges the
//     32 pairs of columns 4 v .. 4 v + 3, 8 lanes per column and 4 pairs per
//     lane, in a fixed order (max, one rescaling exp per pair, sum), so the
//     result is the same bits on every call; gam goes to shared memory;
//     barrier 2. TWO block barriers per iteration (the general route: 3).
//     The pairs are double buffered by the iteration's parity.
//   - exp(z - max) is ex2.approx((z - max) log2 e): log2 e multiplies the
//     difference only, z keeps the plain version's arithmetic (z reaches
//     ~1e3-1e5 at the last temperatures, where folding a constant into it
//     moves f). Logs stay logf, one per row or column and lane.
//   - A cluster of 2 CTAs per item (rows split, the other CTA's pairs
//     through distributed shared memory, a cluster barrier) was tried for
//     batches that leave most SMs idle and lost at the trainer's eval batch
//     of 51 (PERF.md): one CTA per item is the only layout.
//
// General route (N or M > 128, up to the JAX gate, ~640 x 640): one block
// of 512 threads per item, C and Ce in dynamic shared memory when both fit
// (up to ~168 x 168), else in a global scratch that stays in L2; one warp
// per row for the f-update, a few threads per column with an online
// (max, sum) for the g-update; three block barriers per iteration.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;      // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;

// the register route
constexpr int kRegThreads = 1024;
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kRegTile = 128;           // its largest N and M
constexpr int kCols = kRegTile / 32;    // columns per lane
constexpr int kRegRows = kRegTile / kRegWarps;   // rows per warp
// pairs per warp, padded to 2 mod 16 so the merge's 64-bit loads hit 32
// distinct banks per half-warp
constexpr int kPartStride = kRegTile + 2;
constexpr float kLog2e = 1.4426950408889634f;

enum Kind { kLp = 0, kCosine = 1, kGeodesic = 2 };

__device__ __forceinline__ float eps_at(float log_e0, float log_et, int s,
                                        int num_scales) {
  const float r = (float)s / (float)(num_scales > 1 ? num_scales - 1 : 1);
  return expf(log_e0 * (1.0f - r) + log_et * r);
}

// e^x for x <= 0 on the special-function unit: 2^(x log2 e), 2 ulp of the
// unit plus the rounding of the product; e^-inf = 0, results below 2^-126
// flush to 0
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// reduce over the block; every thread gets the result
template <bool kIsMax, int kNumWarps = kWarps>
__device__ float block_all_reduce(float v, float* red) {
  v = kIsMax ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int k = 1; k < kNumWarps; ++k) r = kIsMax ? fmaxf(r, red[k]) : r + red[k];
  __syncthreads();
  return r;
}

__device__ __forceinline__ void lse_push(float& mr, float& sr, float z) {
  if (z > mr) {
    sr = sr * expf(mr - z) + 1.0f;
    mr = z;
  } else {
    sr += expf(z - mr);
  }
}

__device__ __forceinline__ void lse_merge(float& mr, float& sr, float m, float s) {
  const float mn = fmaxf(mr, m);
  sr = sr * expf(mr - mn) + s * expf(m - mn);
  mr = mn;
}

__device__ __forceinline__ float pow_p(float v, float p) {
  if (p == 1.0f) return v;
  if (p == 2.0f) return v * v;
  return powf(v, p);
}

__device__ __forceinline__ float cost_entry(int kind, float p, const float* xi,
                                            const float* yj) {
  if (kind == kLp) {
    // squared differences, summed in coordinate order without contraction
    const float d0 = xi[0] - yj[0], d1 = xi[1] - yj[1], d2 = xi[2] - yj[2];
    return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                     __fmul_rn(d2, d2));
  }
  const float xy = fmaf(xi[2], yj[2], fmaf(xi[1], yj[1], xi[0] * yj[0]));
  const float xn = sqrtf(fmaxf(
      fmaf(xi[2], xi[2], fmaf(xi[1], xi[1], xi[0] * xi[0])), 1e-16f));
  const float yn = sqrtf(fmaxf(
      fmaf(yj[2], yj[2], fmaf(yj[1], yj[1], yj[0] * yj[0])), 1e-16f));
  float cs = xy / (xn * yn);
  if (kind == kCosine) return pow_p(1.0f - cs, p);
  cs = fminf(fmaxf(cs, -1.0f + 1e-7f), 1.0f - 1e-7f);
  return pow_p(acosf(cs), p);
}

// ---------------------------------------------------------------------------
// General route

__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_points_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ val, float* __restrict__ f,
                       float* __restrict__ g, float* scratch, int n, int m,
                       int kind, float p, float eps, float log_et, float log_a,
                       float log_b, int num_iters, int num_scales,
                       int tile_in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nm = n * m;
  float* phi = smem;                 // (n)
  float* gam = phi + n;              // (m)
  float* xs = gam + m;               // (n, 3)
  float* ys = xs + 3 * n;            // (m, 3)
  float* pm = ys + 3 * m;            // (kThreads) partial maxima of the g-update
  float* ps = pm + kThreads;         // (kThreads) partial sums
  float* red = ps + kThreads;        // (32)
  float* c;                          // (n, m) cost
  float* ce;                         // (n, m) cost / temperature
  if (tile_in_smem) {
    c = red + 32;
  } else {
    c = scratch + (size_t)b * 2 * (size_t)nm;
  }
  ce = c + nm;

  for (int i = tid; i < 3 * n; i += kThreads) xs[i] = x[(size_t)b * 3 * n + i];
  for (int j = tid; j < 3 * m; j += kThreads) ys[j] = y[(size_t)b * 3 * m + j];
  for (int i = tid; i < n; i += kThreads) phi[i] = 0.0f;
  for (int j = tid; j < m; j += kThreads) gam[j] = 0.0f;
  __syncthreads();

  float c_max = 0.0f;
  for (int idx = tid; idx < nm; idx += kThreads) {
    const int i = idx / m, j = idx - i * m;
    const float cij = cost_entry(kind, p, xs + 3 * i, ys + 3 * j);
    c[idx] = cij;
    c_max = fmaxf(c_max, fabsf(cij));
  }
  c_max = block_all_reduce<true>(c_max, red);
  const float log_e0 = logf(fmaxf(c_max, 1e-30f));

  // the g-update's thread layout: cols columns side by side, groups row
  // groups behind them
  const int m32 = (m + 31) & ~31;
  const int cols = m32 < kThreads ? m32 : kThreads;
  const int groups = kThreads / cols;
  const int lc = tid % cols, grp = tid / cols;

  for (int s = 0; s < num_scales; ++s) {
    const float e = eps_at(log_e0, log_et, s, num_scales);
    if (s > 0) {
      const float scale = eps_at(log_e0, log_et, s - 1, num_scales) / e;
      for (int i = tid; i < n; i += kThreads) phi[i] *= scale;
      for (int j = tid; j < m; j += kThreads) gam[j] *= scale;
    }
    for (int idx = tid; idx < nm; idx += kThreads) ce[idx] = c[idx] / e;
    __syncthreads();

    for (int it = 0; it < num_iters; ++it) {
      // phi_i: one warp per row
      for (int row = warp; row < n; row += kWarps) {
        const float* cr = ce + row * m;
        float mx = -INFINITY;
        for (int j = lane; j < m; j += 32) mx = fmaxf(mx, gam[j] - (cr[j] - log_b));
        mx = warp_max(mx);
        float sm = 0.0f;
        for (int j = lane; j < m; j += 32) sm += expf(gam[j] - (cr[j] - log_b) - mx);
        sm = warp_sum(sm);
        if (lane == 0) phi[row] = -(mx + logf(sm));
      }
      __syncthreads();
      // gam_j: groups threads per column
      for (int c0 = 0; c0 < m; c0 += cols) {
        const int col = c0 + lc;
        float mr = -INFINITY, sr = 0.0f;
        if (grp < groups && col < m)
          for (int i = grp; i < n; i += groups)
            lse_push(mr, sr, phi[i] - (ce[i * m + col] - log_a));
        if (groups > 1) {           // then cols >= m: a single trip of this loop
          pm[tid] = mr;
          ps[tid] = sr;
          __syncthreads();
          if (grp == 0)
            for (int k = 1; k < groups; ++k)
              lse_merge(mr, sr, pm[k * cols + lc], ps[k * cols + lc]);
        }
        if (grp == 0 && col < m) gam[col] = -(mr + logf(sr));
      }
      __syncthreads();
    }
  }

  const float e_fin = eps_at(log_e0, log_et, num_scales - 1, num_scales);
  for (int i = tid; i < n; i += kThreads) {
    const float fi = e_fin * phi[i];
    phi[i] = fi;
    f[(size_t)b * n + i] = fi;
  }
  for (int j = tid; j < m; j += kThreads) {
    const float gj = e_fin * gam[j];
    gam[j] = gj;
    g[(size_t)b * m + j] = gj;
  }
  __syncthreads();
  float acc = 0.0f;
  for (int idx = tid; idx < nm; idx += kThreads) {
    const int i = idx / m, j = idx - i * m;
    const float cij = c[idx];
    acc += expf((phi[i] + gam[j] - cij) / eps + log_a + log_b) * cij;
  }
  acc = block_all_reduce<false>(acc, red);
  if (tid == 0) val[b] = acc;
}

size_t smem_bytes(int n, int m, bool tile_in_smem) {
  size_t words = (size_t)4 * n + (size_t)4 * m + 2 * kThreads + 32;
  if (tile_in_smem) words += (size_t)2 * n * m;
  return words * sizeof(float);
}

// ---------------------------------------------------------------------------
// Register route

// shared memory of the CTA: the (max, sum) pairs of the g-update, double
// buffered, [parity][warp][column]; the item's points; gam; reductions
constexpr size_t kRegPairs = (size_t)2 * kRegWarps * kPartStride;
constexpr size_t kRegSmemBytes =
    kRegPairs * sizeof(float2) + (size_t)(6 * kRegTile + kRegTile + kRegWarps) * sizeof(float);

template <bool kIsMax>
__device__ __forceinline__ float comb(float a, float b) {
  return kIsMax ? fmaxf(a, b) : a + b;
}

// Reduce the 4 rows' values over the warp as a reduce-scatter: the first
// two rounds swap halves of the rows between lanes, so every lane ends with
// the full reduction of ONE row, row lane / 8; 2 + 1 + 3 shuffles instead
// of 4 x 5. The tree per row is fixed: the same bits on every call.
template <bool kIsMax>
__device__ __forceinline__ float scatter_reduce(const float (&v)[kRegRows], int lane) {
  const bool hi = lane & 16, mid = lane & 8;
  const float w0 = comb<kIsMax>(hi ? v[2] : v[0], __shfl_xor_sync(kFull, hi ? v[0] : v[2], 16));
  const float w1 = comb<kIsMax>(hi ? v[3] : v[1], __shfl_xor_sync(kFull, hi ? v[1] : v[3], 16));
  float u = comb<kIsMax>(mid ? w1 : w0, __shfl_xor_sync(kFull, mid ? w0 : w1, 8));
#pragma unroll
  for (int off = 4; off; off >>= 1) u = comb<kIsMax>(u, __shfl_xor_sync(kFull, u, off));
  return u;
}

// kSquare (N == M, so log a == log b): the tile holds Ce - log a, one
// subtraction per entry in each update and the same values as the plain
// version's ca and cb
template <bool kSquare>
__global__ void __launch_bounds__(kRegThreads, 1)
sinkhorn_points_regs_kernel(const float* __restrict__ x, const float* __restrict__ y,
                            float* __restrict__ val, float* __restrict__ f,
                            float* __restrict__ g, int n, int m, int kind, float p,
                            float eps, float log_et, float log_a, float log_b,
                            int num_iters, int num_scales) {
  constexpr int R = kRegRows;
  constexpr int kPairsPerLane = kRegWarps / 8;           // pairs a merging lane reads
  extern __shared__ __align__(16) float smem[];
  float2* pairs = reinterpret_cast<float2*>(smem);
  float* xs = smem + 2 * kRegPairs;                      // (128, 3)
  float* ys = xs + 3 * kRegTile;                         // (128, 3)
  float* gam = ys + 3 * kRegTile;                        // (128)
  float* red = gam + kRegTile;                           // (32)

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * R;
  // the merge: warp v takes column 4 v + lane / 8; its lane the pairs of
  // warps lane % 8 + 8 i (the padded stride spreads them over the banks)
  const int mcol = 4 * warp + (lane >> 3), mh = lane & 7;

  for (int i = tid; i < 3 * n; i += kRegThreads) xs[i] = x[(size_t)b * 3 * n + i];
  for (int j = tid; j < 3 * m; j += kRegThreads) ys[j] = y[(size_t)b * 3 * m + j];
  if (tid < kRegTile) gam[tid] = 0.0f;
  __syncthreads();

  bool rv[R], cv[kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) rv[r] = row0 + r < n;
#pragma unroll
  for (int k = 0; k < kCols; ++k) cv[k] = lane + 32 * k < m;

  float c_max = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (rv[r] && cv[k])
        c_max = fmaxf(c_max, fabsf(cost_entry(kind, p, xs + 3 * (row0 + r),
                                              ys + 3 * (lane + 32 * k))));
  c_max = block_all_reduce<true, kRegWarps>(c_max, red);
  const float log_e0 = logf(fmaxf(c_max, 1e-30f));

  float phi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) phi[r] = 0.0f;
  float ce[R][kCols];
  int t = 0;                                             // iterations so far

  for (int s = 0; s < num_scales; ++s) {
    const float e = eps_at(log_e0, log_et, s, num_scales);
    if (s > 0) {
      const float scale = eps_at(log_e0, log_et, s - 1, num_scales) / e;
#pragma unroll
      for (int r = 0; r < R; ++r) phi[r] *= scale;
      if (tid < kRegTile) gam[tid] *= scale;
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float v = cost_entry(kind, p, xs + 3 * (row0 + r), ys + 3 * (lane + 32 * k)) / e;
        ce[r][k] = (rv[r] && cv[k]) ? (kSquare ? v - log_a : v) : INFINITY;
      }

    for (int it = 0; it < num_iters; ++it, ++t) {
      // ---- f-update, inside the warp ----
      float gk[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) gk[k] = gam[lane + 32 * k];
      float z[R][kCols], mx[R], sm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mx[r] = -INFINITY;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          z[r][k] = kSquare ? gk[k] - ce[r][k] : gk[k] - (ce[r][k] - log_b);
          mx[r] = fmaxf(mx[r], z[r][k]);
        }
      }
      const float my_mx = scatter_reduce<true>(mx, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mx[r] = __shfl_sync(kFull, my_mx, r * 8);
        sm[r] = 0.0f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) sm[r] += exp_fast(z[r][k] - mx[r]);
      }
      const float my_sm = scatter_reduce<false>(sm, lane);
      const float my_phi = -(my_mx + logf(my_sm));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = __shfl_sync(kFull, my_phi, r * 8);
        phi[r] = rv[r] ? v : 0.0f;         // a row past n keeps 0
      }

      // ---- g-update: a (max, sum) pair per column over the warp's rows ----
      const int buf = (t & 1) * kRegWarps * kPartStride;
      float2* mine = pairs + buf + warp * kPartStride;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        float zz[R], zm = -INFINITY;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          zz[r] = kSquare ? phi[r] - ce[r][k] : phi[r] - (ce[r][k] - log_a);
          zm = fmaxf(zm, zz[r]);
        }
        float ss = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) ss += exp_fast(zz[r] - zm);
        // no valid row here: the pair (-inf, 0) adds nothing to the merge
        mine[lane + 32 * k] = make_float2(zm, zm == -INFINITY ? 0.0f : ss);
      }
      __syncthreads();                                        // barrier 1

      // ---- merge in warp order ----
      float2 pk[kPairsPerLane];
      const float2* src = pairs + buf + mh * kPartStride + mcol;
#pragma unroll
      for (int i = 0; i < kPairsPerLane; ++i) pk[i] = src[i * 8 * kPartStride];
      float gm = pk[0].x;
#pragma unroll
      for (int i = 1; i < kPairsPerLane; ++i) gm = fmaxf(gm, pk[i].x);
#pragma unroll
      for (int off = 4; off; off >>= 1) gm = fmaxf(gm, __shfl_xor_sync(kFull, gm, off));
      float gs = 0.0f;
#pragma unroll
      for (int i = 0; i < kPairsPerLane; ++i) gs += pk[i].y * exp_fast(pk[i].x - gm);
#pragma unroll
      for (int off = 4; off; off >>= 1) gs += __shfl_xor_sync(kFull, gs, off);
      if (mh == 0 && mcol < m) gam[mcol] = -(gm + logf(gs));  // a column past m keeps 0
      __syncthreads();                                        // barrier 2
    }
  }

  const float e_fin = eps_at(log_e0, log_et, num_scales - 1, num_scales);
  float fi[R], gj[kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    fi[r] = e_fin * phi[r];
    if (lane == r && rv[r]) f[(size_t)b * n + row0 + r] = fi[r];
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) gj[k] = e_fin * gam[lane + 32 * k];
  if (tid < m) g[(size_t)b * m + tid] = e_fin * gam[tid];
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (rv[r] && cv[k]) {
        const float cij = cost_entry(kind, p, xs + 3 * (row0 + r), ys + 3 * (lane + 32 * k));
        acc += expf((fi[r] + gj[k] - cij) / eps + log_a + log_b) * cij;
      }
  acc = block_all_reduce<false, kRegWarps>(acc, red);
  if (tid == 0) val[b] = acc;
}

// Once per device: the shared-memory opt-in of each kernel
bool g_ready[kMaxDevices];

cudaError_t prepare_device() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_ready[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(sinkhorn_points_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sinkhorn_points_regs_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRegSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sinkhorn_points_regs_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRegSmemBytes);
  if (err != cudaSuccess) return err;
  g_ready[device] = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Whether both (n, m) tiles of the general route fit in a block's shared
// memory; otherwise the caller passes a scratch of 2 * batch * n * m floats.
int shwd_sinkhorn_points_tile_in_smem(int n, int m) {
  return smem_bytes(n, m, true) <= (size_t)kSmemLimit ? 1 : 0;
}

// x (B, n, 3), y (B, m, 3) f32 contiguous -> val (B,), f (B, n), g (B, m).
// kind: 0 lp (p = 2), 1 cosine, 2 geodesic. log_et = log(eps),
// log_a = -log n, log_b = -log m, computed by the caller in double
// precision. route 1 is the register route (n, m <= 128), route 0 the
// general one (scratch as shwd_sinkhorn_points_tile_in_smem says). Returns
// the CUDA error of the launch (cudaErrorInvalidValue for arguments the
// route does not take).
int shwd_sinkhorn_points(const float* x, const float* y, float* val, float* f,
                         float* g, float* scratch, int batch, int n, int m,
                         int kind, float p, float eps, float log_et,
                         float log_a, float log_b, int num_iters,
                         int num_scales, int route, void* stream) {
  cudaError_t err = prepare_device();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (n > kRegTile || m > kRegTile) return (int)cudaErrorInvalidValue;
    if (n == m)
      sinkhorn_points_regs_kernel<true><<<batch, kRegThreads, kRegSmemBytes, st>>>(
          x, y, val, f, g, n, m, kind, p, eps, log_et, log_a, log_b, num_iters, num_scales);
    else
      sinkhorn_points_regs_kernel<false><<<batch, kRegThreads, kRegSmemBytes, st>>>(
          x, y, val, f, g, n, m, kind, p, eps, log_et, log_a, log_b, num_iters, num_scales);
    return (int)cudaGetLastError();
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const bool in_smem = shwd_sinkhorn_points_tile_in_smem(n, m) != 0;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, m, in_smem);
  if (bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  sinkhorn_points_kernel<<<batch, kThreads, bytes, st>>>(
      x, y, val, f, g, scratch, n, m, kind, p, eps, log_et, log_a, log_b,
      num_iters, num_scales, in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
