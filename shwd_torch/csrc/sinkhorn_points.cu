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
// Design (simple first): the TPU kernel's batch tiles and 128-padding exist
// for its vector unit and are not carried over.
//   - one block of 512 threads per item, one launch for the whole schedule,
//     no host sync;
//   - C and Ce live in dynamic shared memory when both fit (128 KB at
//     128 x 128); larger items keep both tiles in a global scratch that
//     stays in L2. The passes are the same code on either pointer;
//   - f-update: one warp per row, lanes over columns, a max pass then a
//     sum-of-exp pass, so each entry costs exactly one exp;
//   - g-update: a few threads per column, each walking a strided set of
//     rows with an online (max, sum) pair (neighbouring threads read
//     neighbouring words), merged through shared memory;
//   - block barriers separate the half-iterations (3 per iteration).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;      // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;

enum Kind { kLp = 0, kCosine = 1, kGeodesic = 2 };

__device__ __forceinline__ float eps_at(float log_e0, float log_et, int s,
                                        int num_scales) {
  const float r = (float)s / (float)(num_scales > 1 ? num_scales - 1 : 1);
  return expf(log_e0 * (1.0f - r) + log_et * r);
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
template <bool kIsMax>
__device__ float block_all_reduce(float v, float* red) {
  v = kIsMax ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int k = 1; k < kWarps; ++k) r = kIsMax ? fmaxf(r, red[k]) : r + red[k];
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

}  // namespace

extern "C" {

// Whether both (n, m) tiles fit in a block's shared memory; otherwise the
// caller passes a scratch of 2 * batch * n * m floats.
int shwd_sinkhorn_points_tile_in_smem(int n, int m) {
  return smem_bytes(n, m, true) <= (size_t)kSmemLimit ? 1 : 0;
}

// x (B, n, 3), y (B, m, 3) f32 contiguous -> val (B,), f (B, n), g (B, m).
// kind: 0 lp (p = 2), 1 cosine, 2 geodesic. log_et = log(eps),
// log_a = -log n, log_b = -log m, computed by the caller in double
// precision. Returns the CUDA error of the launch (1 for a missing scratch).
int shwd_sinkhorn_points(const float* x, const float* y, float* val, float* f,
                         float* g, float* scratch, int batch, int n, int m,
                         int kind, float p, float eps, float log_et,
                         float log_a, float log_b, int num_iters,
                         int num_scales, void* stream) {
  const bool in_smem = shwd_sinkhorn_points_tile_in_smem(n, m) != 0;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, m, in_smem);
  if (bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB is a per-device attribute of the function: ask
  // once for the whole limit, not on every launch
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(
        sinkhorn_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  sinkhorn_points_kernel<<<batch, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      x, y, val, f, g, scratch, n, m, kind, p, eps, log_et, log_a, log_b,
      num_iters, num_scales, in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
