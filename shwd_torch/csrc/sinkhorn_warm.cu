// Batched annealed log-Sinkhorn potentials of small costs in one launch:
// the dual iterations of emd2_approx, for the exact (hybrid) solver's cold
// warm-up below K1's size gate.
//
// Replaces: no TPU kernel. The JAX package's counterpart,
// shwd_tpu/ops/sinkhorn.py::emd2_approx, is plain jnp that XLA fuses; the
// port ran it op by op, about 22 kernels an iteration (4,400 at 50 x 4).
// Added so that a cold hybrid solve of problems up to 128 x 128 (the
// registration trainer's phi ascent and validation solves) prices the
// auction in one launch. ops/auction.py::warm_route picks it by shape.
//
// What it computes, per batch item of C (B, N, M), uniform marginals
// a = 1/N, b = 1/M (log a, log b as the plain path forms them:
// logf of the f32 marginal), exactly the schedule of
// emd2_approx(C, eps, num_iters, num_scales, return_potentials=True):
//   temperatures e_s = eps_sched[s], s = 0 .. S - 1: the wrapper forms them
//   on the device with emd2_approx's own torch expression from ONE
//   eps0 = max |C| over the whole batch (over every rank's block under a
//   data-parallel fit), so they are the plain path's bits;
//   f = g = 0, carried unscaled from one temperature to the next; at each
//   temperature num_iters rounds of
//     f_i = -e (max_j z + log sum_j exp(z - max)),  z = (g_j - C_ij)/e + log b
//     g_j = -e (max_i z + log sum_i exp(z - max)),  z = (f_i - C_ij)/e + log a
//   f32 throughout, every iteration run (no early exit). Forward only; it
//   writes f and g.
//   Rounding differs from the plain path in three places: z multiplies by
//   the f32 reciprocal of e (one fused multiply-add with log b), exp is
//   ex2.approx, and the sums run in the kernel's fixed order.
//
// What bounds it on the H100: one exp per cost entry per half-iteration,
// 2 S I B N M of them (0.84 G at B = 128, N = M = 128, 50 x 4), about 0.20
// ms on the special-function units (16 a clock an SM). The f32 work around
// each exp (subtract, multiply-add, max, subtract, scale, add) is close to
// 7/8 of that on the FMA pipes; the bytes (C in, f and g out, 8.5 MB at that
// shape) take 2.5 us.
//
// Design (K3's register route, csrc/sinkhorn_points.cu, with this
// function's semantics): the item's tile lives in registers for the whole
// call, so an iteration reads no cost from memory and the f-update stays
// inside each warp; all that an exp needs is in registers.
//   - One CTA of 1024 threads per item, __launch_bounds__(1024, 1): B = 128
//     fills 128 of 132 SMs in one wave. Warp w owns rows 4 w .. 4 w + 3,
//     lane l the columns l, l + 32, l + 64, l + 96 (coalesced loads of C,
//     conflict-free reads of g): each thread reads its 4 x 4 block of C
//     from global memory once and keeps it. Entries past a ragged edge
//     hold +inf: their z is -inf and their exp 0.
//   - f-update: z once into registers; the row maxima over the registers,
//     then a reduce-scatter over the lanes for the warp's 4 rows together
//     (each lane ends with one row's result: 6 shuffles, not 20); one exp
//     per entry; the sums the same way. Every lane then holds f of its
//     warp's rows: no shared-memory write and no barrier.
//   - g-update: each warp forms a (max, sum) pair per column over its 4
//     rows (one exp per entry) and stores it; barrier 1; warp v merges the
//     32 pairs of columns 4 v .. 4 v + 3, 8 lanes per column and 4 pairs per
//     lane, in a fixed order (max, one rescaling exp per pair, sum): the
//     same bits on every call, no float atomics; g goes to shared memory;
//     barrier 2. Two block barriers an iteration; the pairs need one
//     buffer, since barrier 2 parts one iteration's merge from the next
//     one's stores.
//   - exp(z - max) is ex2.approx((z - max) log2 e): log2 e multiplies the
//     difference only, so z keeps the plain version's arithmetic (z reaches
//     ~1e3-1e5 at the last temperatures, where folding a constant into it
//     would move f). Logs stay logf, one per row or column and lane.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                  // the largest N and M
constexpr int kCols = kTile / 32;           // columns per lane
constexpr int kRows = kTile / kWarps;       // rows per warp
// pairs per warp, padded to 2 mod 16 so the merge's 64-bit loads hit 32
// distinct banks per half-warp
constexpr int kPartStride = kTile + 2;
constexpr float kLog2e = 1.4426950408889634f;

// e^x for x <= 0 on the special-function unit: 2^(x log2 e), 2 ulp of the
// unit plus the rounding of the product; e^-inf = 0, results below 2^-126
// flush to 0
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

template <bool kIsMax>
__device__ __forceinline__ float comb(float a, float b) {
  return kIsMax ? fmaxf(a, b) : a + b;
}

// Reduce the 4 rows' values over the warp as a reduce-scatter: the first
// two rounds swap halves of the rows between lanes, so every lane ends with
// the full reduction of ONE row, row lane / 8; 2 + 1 + 3 shuffles instead
// of 4 x 5. The tree per row is fixed: the same bits on every call.
template <bool kIsMax>
__device__ __forceinline__ float scatter_reduce(const float (&v)[kRows], int lane) {
  const bool hi = lane & 16, mid = lane & 8;
  const float w0 = comb<kIsMax>(hi ? v[2] : v[0], __shfl_xor_sync(kFull, hi ? v[0] : v[2], 16));
  const float w1 = comb<kIsMax>(hi ? v[3] : v[1], __shfl_xor_sync(kFull, hi ? v[1] : v[3], 16));
  float u = comb<kIsMax>(mid ? w1 : w0, __shfl_xor_sync(kFull, mid ? w0 : w1, 8));
#pragma unroll
  for (int off = 4; off; off >>= 1) u = comb<kIsMax>(u, __shfl_xor_sync(kFull, u, off));
  return u;
}

__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_warm_kernel(const float* __restrict__ cost, const float* __restrict__ eps_sched,
                     float* __restrict__ f_out, float* __restrict__ g_out, int n, int m,
                     float a, float b, int num_iters, int num_scales) {
  constexpr int R = kRows;
  constexpr int kPairsPerLane = kWarps / 8;             // pairs a merging lane reads
  __shared__ float2 pairs[kWarps * kPartStride];        // [warp][column]
  __shared__ float g[kTile];

  const int item = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * R;
  // the merge: warp v takes column 4 v + lane / 8; its lane the pairs of
  // warps lane % 8 + 8 i (the padded stride spreads them over the banks)
  const int mcol = 4 * warp + (lane >> 3), mh = lane & 7;
  const float log_a = logf(a), log_b = logf(b);

  bool rv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rv[r] = row0 + r < n;
  const float* ci = cost + (size_t)item * n * m;
  float c[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = lane + 32 * k;
      c[r][k] = (rv[r] && col < m) ? ci[(size_t)(row0 + r) * m + col] : INFINITY;
    }
  if (tid < kTile) g[tid] = 0.0f;
  __syncthreads();

  float my_f = 0.0f;                                    // f of row row0 + lane / 8
  for (int s = 0; s < num_scales; ++s) {
    const float e = eps_sched[s];
    const float inv_e = 1.0f / e;
    for (int it = 0; it < num_iters; ++it) {
      // ---- f-update, inside the warp ----
      float gk[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) gk[k] = g[lane + 32 * k];
      float z[R][kCols], mx[R], sm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mx[r] = -INFINITY;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          z[r][k] = (gk[k] - c[r][k]) * inv_e + log_b;
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
      my_f = -(e * (my_mx + logf(my_sm)));
      float fr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = __shfl_sync(kFull, my_f, r * 8);
        fr[r] = rv[r] ? v : 0.0f;          // a row past n (its f is NaN) adds -inf
      }

      // ---- g-update: a (max, sum) pair per column over the warp's rows ----
      float2* mine = pairs + warp * kPartStride;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        float zz[R], zm = -INFINITY;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          zz[r] = (fr[r] - c[r][k]) * inv_e + log_a;
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
      const float2* src = pairs + mh * kPartStride + mcol;
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
      if (mh == 0 && mcol < m) g[mcol] = -(e * (gm + logf(gs)));  // a column past m keeps 0
      __syncthreads();                                        // barrier 2
    }
  }

  if (mh == 0 && row0 + (lane >> 3) < n) f_out[(size_t)item * n + row0 + (lane >> 3)] = my_f;
  if (tid < m) g_out[(size_t)item * m + tid] = g[tid];
}

}  // namespace

extern "C" {

// cost (batch, n, m) f32 contiguous, eps_sched (num_scales,) f32 on the
// device -> f (batch, n), g (batch, m). a = 1/n and b = 1/m as f32 (the
// plain path's marginals). 1 <= n, m <= 128. Returns the CUDA error of the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
int shwd_sinkhorn_warm(const float* cost, const float* eps_sched, float* f, float* g,
                       int batch, int n, int m, float a, float b, int num_iters,
                       int num_scales, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || n > kTile || m > kTile || num_iters < 0 ||
      num_scales < 0)
    return (int)cudaErrorInvalidValue;
  sinkhorn_warm_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cost, eps_sched, f, g, n, m, a, b, num_iters, num_scales);
  return (int)cudaGetLastError();
}

}  // extern "C"
