// Tiled two-sided Chamfer distance that never forms the (N, M) matrix.
//
// Replaces: shwd_tpu/ops/chamfer.py::chamfer_pallas (kernel
// _chamfer_tile_kernel), the VMEM-tiled Chamfer for large clouds.
//
// What it computes, for x (B, N, 3), y (B, M, 3):
//   minx[b, i] = min_j |x_bi - y_bj|^2,  miny[b, j] = min_i |x_bi - y_bj|^2,
//   out = mean(minx) + mean(miny), means over all B N and all B M entries.
//   Forward only, as the TPU kernel is. Distances are direct squared
//   differences (the TPU body expands x^2 + y^2 - 2 x.y for its matrix
//   unit; the direct form is exact where that cancels).
//
// What bounds it on the H100: 8 f32 operations per pair and side (three
// subtractions, three multiply-adds, a minimum), 16 B N M in all (0.034 G
// at 128 x 128 x 128, 0.66 G at 2 x 5000 x 4099), against 12 (N + M) B
// bytes in: operations by a wide margin.
//
// Design (simple first): the TPU grid walks (item, row tile, column tile)
// in order and revisits its output blocks; blocks here run in parallel, so
//   - chamfer_min: a grid over (row tile, item); each thread owns one
//     point of the first cloud and keeps its running minimum in a
//     register while the block walks the second cloud through shared
//     memory in tiles of 1024 points (every thread reads the same word: a
//     broadcast). Bounds replace the TPU version's far-away padding rows;
//   - the same kernel with the clouds swapped gives the other side;
//   - chamfer_mean: one block sums both sides in a fixed order (double
//     accumulators) and writes the scalar, so the result is deterministic.
//   Three launches per call, no host sync.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 256;        // points of the first cloud per block
constexpr int kTile = 1024;       // points of the second cloud per tile
constexpr int kMeanThreads = 1024;

__global__ void __launch_bounds__(kRows)
chamfer_min(const float* __restrict__ a, const float* __restrict__ b, int na,
            int nb, float* __restrict__ mins) {
  __shared__ float tile[3 * kTile];
  const int item = blockIdx.y;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const float* ai = a + ((size_t)item * na + (i < na ? i : 0)) * 3;
  const float a0 = ai[0], a1 = ai[1], a2 = ai[2];
  const float* bb = b + (size_t)item * nb * 3;
  float best = INFINITY;
  for (int j0 = 0; j0 < nb; j0 += kTile) {
    const int cnt = nb - j0 < kTile ? nb - j0 : kTile;
    __syncthreads();
    for (int k = threadIdx.x; k < 3 * cnt; k += kRows) tile[k] = bb[(size_t)3 * j0 + k];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float d0 = a0 - tile[3 * j], d1 = a1 - tile[3 * j + 1],
                  d2 = a2 - tile[3 * j + 2];
      best = fminf(best, d0 * d0 + d1 * d1 + d2 * d2);
    }
  }
  if (i < na) mins[(size_t)item * na + i] = best;
}

__global__ void __launch_bounds__(kMeanThreads)
chamfer_mean(const float* __restrict__ minx, const float* __restrict__ miny,
             long long nx, long long ny, float* __restrict__ out) {
  __shared__ double red[kMeanThreads / 32];
  double sx = 0.0, sy = 0.0;
  for (long long i = threadIdx.x; i < nx; i += kMeanThreads) sx += (double)minx[i];
  for (long long j = threadIdx.x; j < ny; j += kMeanThreads) sy += (double)miny[j];
  double v = sx / (double)nx + sy / (double)ny;
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int k = 0; k < kMeanThreads / 32; ++k) total += red[k];
    out[0] = (float)total;
  }
}

}  // namespace

extern "C" {

// x (B, n, 3), y (B, m, 3) f32 contiguous -> out (1,) = mean(minx) +
// mean(miny); minx (B, n) and miny (B, m) are written on the way.
// Returns the CUDA error of the last launch.
int shwd_chamfer_tiled(const float* x, const float* y, float* minx,
                       float* miny, float* out, int batch, int n, int m,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 gx((n + kRows - 1) / kRows, batch);
  const dim3 gy((m + kRows - 1) / kRows, batch);
  chamfer_min<<<gx, kRows, 0, st>>>(x, y, n, m, minx);
  chamfer_min<<<gy, kRows, 0, st>>>(y, x, m, n, miny);
  chamfer_mean<<<1, kMeanThreads, 0, st>>>(minx, miny, (long long)batch * n,
                                           (long long)batch * m, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
