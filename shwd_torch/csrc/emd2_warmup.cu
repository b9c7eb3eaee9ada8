// Annealed log-domain Sinkhorn duals for the hybrid exact-EMD solver.
//
// Replaces: shwd_tpu/ops/sinkhorn_pallas.py::emd2_warmup_pallas (kernel
// _make_warmup_kernel), the VMEM-resident warm-up that prices the auction.
//
// What it computes, per batch item b of a (B, N, M) f32 cost:
//   eps0 = max |C| over the item; num_scales geometric temperatures
//   e_s = exp(log eps0 (1 - r) + log eps r), r = s / (S - 1); at each,
//   num_iters rounds of
//     f_i = -e (max_j z + log sum_j exp(z - max)),  z = (g_j - C_ij)/e + log b
//     g_j = -e (max_i z + log sum_i exp(z - max)),  z = (f_i - C_ij)/e + log a
//   with no rescaling of the potentials between temperatures, then
//   val = sum_ij exp((f_i + g_j - C_ij)/e_final + log a + log b) C_ij.
//   Forward only: the caller holds the duals under no-grad.
//
// What bounds it on the H100: one exp per cost entry per half-iteration,
// 2 * S * I * N * M transcendentals (0.92 G at the flow shape: 1200 x 1200,
// 40 x 8), plus re-reading the cost every pass. The 5.8 MB flow cost stays
// in the 50 MB L2, so the passes read L2, not HBM; the bound is the
// exp work on the special-function units (16 per clock per SM on sm_90,
// about 0.22 ms for 0.92 G), above the f32 ALU work.
//
// Design (simple first):
//   - warmup_init: one block per item reduces max |C|, writes log eps0 to a
//     device buffer and zeroes f, g and val. Temperatures are recomputed from
//     that buffer on the device, so the host loop of launches never syncs.
//   - f_pass: one warp per row, an online (max, sum) log-sum-exp over the
//     row's columns, coalesced along the row.
//   - g_pass: a 32-column by 32-row-group tile per block; each thread walks
//     its column down a strided set of rows (neighbouring threads read
//     neighbouring addresses), then the 32 partial (max, sum) pairs of a
//     column are merged in shared memory.
//   - warmup_value: one block per item sums the plan-weighted cost.
//   2 * S * I + 2 launches per call (642 at 40 x 8). A persistent kernel or
//   a CUDA graph would remove the launch gaps; that is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;     // rows per f_pass block
constexpr int kColTile = 32;     // columns per g_pass block
constexpr int kRowGroups = 32;   // row groups per g_pass block
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float eps_at(float log_e0, float log_et, int s,
                                        int num_scales) {
  const float r = (float)s / (float)(num_scales > 1 ? num_scales - 1 : 1);
  return expf(log_e0 * (1.0f - r) + log_et * r);
}

// merge (m, s) into the running (mr, sr) of an online log-sum-exp
__device__ __forceinline__ void lse_merge(float& mr, float& sr, float m,
                                          float s) {
  const float mn = fmaxf(mr, m);
  sr = sr * expf(mr - mn) + s * expf(m - mn);
  mr = mn;
}

__device__ __forceinline__ void lse_push(float& mr, float& sr, float z) {
  if (z > mr) {
    sr = sr * expf(mr - z) + 1.0f;
    mr = z;
  } else {
    sr += expf(z - mr);
  }
}

template <typename Op>
__device__ float block_reduce(float v, Op op, float identity, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1) v = op(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    v = lane < nwarps ? scratch[lane] : identity;
    for (int off = 16; off; off >>= 1) v = op(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;   // valid in thread 0
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};

__global__ void warmup_init(const float* __restrict__ cost, int n, int m,
                            float* __restrict__ log_e0, float* __restrict__ f,
                            float* __restrict__ g, float* __restrict__ val) {
  __shared__ float scratch[32];
  const int b = blockIdx.x;
  const long long nm = (long long)n * m;
  const float* c = cost + b * nm;
  float mx = -1e30f;
  for (long long i = threadIdx.x; i < nm; i += blockDim.x)
    mx = fmaxf(mx, fabsf(c[i]));
  mx = block_reduce(mx, MaxOp(), -1e30f, scratch);
  if (threadIdx.x == 0) {
    log_e0[b] = logf(fmaxf(mx, 1e-30f));
    val[b] = 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) f[(long long)b * n + i] = 0.0f;
  for (int j = threadIdx.x; j < m; j += blockDim.x) g[(long long)b * m + j] = 0.0f;
}

__global__ void f_pass(const float* __restrict__ cost,
                       const float* __restrict__ g, float* __restrict__ f,
                       const float* __restrict__ log_e0, int n, int m,
                       float log_et, int s, int num_scales, float log_b) {
  const int b = blockIdx.y;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;                       // whole warps only
  const float e = eps_at(log_e0[b], log_et, s, num_scales);
  const float e_inv = 1.0f / e;
  const float* c = cost + ((long long)b * n + row) * m;
  const float* gb = g + (long long)b * m;
  float mr = -1e30f, sr = 0.0f;
  for (int j = lane; j < m; j += 32) lse_push(mr, sr, (gb[j] - c[j]) * e_inv + log_b);
  for (int off = 16; off; off >>= 1) {
    const float mo = __shfl_xor_sync(kFull, mr, off);
    const float so = __shfl_xor_sync(kFull, sr, off);
    lse_merge(mr, sr, mo, so);
  }
  if (lane == 0) f[(long long)b * n + row] = -e * (mr + logf(fmaxf(sr, 1e-38f)));
}

__global__ void g_pass(const float* __restrict__ cost,
                       const float* __restrict__ f, float* __restrict__ g,
                       const float* __restrict__ log_e0, int n, int m,
                       float log_et, int s, int num_scales, float log_a) {
  __shared__ float sm_m[kRowGroups][kColTile + 1];
  __shared__ float sm_s[kRowGroups][kColTile + 1];
  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kColTile + tx;
  const float e = eps_at(log_e0[b], log_et, s, num_scales);
  const float e_inv = 1.0f / e;
  float mr = -1e30f, sr = 0.0f;
  if (col < m) {
    const float* c = cost + (long long)b * n * m + col;
    const float* fb = f + (long long)b * n;
    for (int i = ty; i < n; i += kRowGroups)
      lse_push(mr, sr, (fb[i] - c[(long long)i * m]) * e_inv + log_a);
  }
  sm_m[ty][tx] = mr;
  sm_s[ty][tx] = sr;
  __syncthreads();
  if (ty == 0 && col < m) {
    for (int k = 1; k < kRowGroups; ++k) lse_merge(mr, sr, sm_m[k][tx], sm_s[k][tx]);
    g[(long long)b * m + col] = -e * (mr + logf(fmaxf(sr, 1e-38f)));
  }
}

__global__ void warmup_value(const float* __restrict__ cost,
                             const float* __restrict__ f,
                             const float* __restrict__ g,
                             const float* __restrict__ log_e0, int n, int m,
                             float log_et, int num_scales, float log_ab,
                             float* __restrict__ val) {
  __shared__ float scratch[32];
  const int b = blockIdx.x;
  const float e_inv = 1.0f / eps_at(log_e0[b], log_et, num_scales - 1, num_scales);
  const long long nm = (long long)n * m;
  const float* c = cost + b * nm;
  const float* fb = f + (long long)b * n;
  const float* gb = g + (long long)b * m;
  float acc = 0.0f;
  for (long long idx = threadIdx.x; idx < nm; idx += blockDim.x) {
    const int i = (int)(idx / m), j = (int)(idx - (long long)i * m);
    const float cij = c[idx];
    acc += expf((fb[i] + gb[j] - cij) * e_inv + log_ab) * cij;
  }
  acc = block_reduce(acc, SumOp(), 0.0f, scratch);
  if (threadIdx.x == 0) val[b] = acc;
}

}  // namespace

extern "C" {

// cost (B, n, m) f32 contiguous -> val (B,), f (B, n), g (B, m); log_e0 (B,)
// is scratch. log_et = log(eps), log_a = -log n, log_b = -log m and
// log_ab = log_a + log_b are computed by the caller in double precision.
// Returns cudaGetLastError() after the last launch.
int shwd_emd2_warmup(const float* cost, float* val, float* f, float* g,
                     float* log_e0, int batch, int n, int m, float log_et,
                     float log_a, float log_b, float log_ab, int num_iters,
                     int num_scales, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  warmup_init<<<batch, kReduceThreads, 0, st>>>(cost, n, m, log_e0, f, g, val);
  const dim3 f_grid((n + kRowWarps - 1) / kRowWarps, batch);
  const dim3 g_grid((m + kColTile - 1) / kColTile, batch);
  const dim3 g_block(kColTile, kRowGroups);
  for (int s = 0; s < num_scales; ++s) {
    for (int it = 0; it < num_iters; ++it) {
      f_pass<<<f_grid, kRowWarps * 32, 0, st>>>(cost, g, f, log_e0, n, m,
                                                 log_et, s, num_scales, log_b);
      g_pass<<<g_grid, g_block, 0, st>>>(cost, f, g, log_e0, n, m, log_et, s,
                                         num_scales, log_a);
    }
  }
  warmup_value<<<batch, kReduceThreads, 0, st>>>(cost, f, g, log_e0, n, m,
                                                 log_et, num_scales, log_ab, val);
  return (int)cudaGetLastError();
}

}  // extern "C"
