// phi's residual chain of Lipschitz blocks (the learned map of SHWD), one
// launch a pass.
//
// Replaces no TPU kernel: shwd_tpu/flows/lipschitz.py and residual.py are
// plain jnp, which XLA fuses into a few fusions a pass. Op by op, the port
// launched about a dozen kernels a layer forward (SpectralLinear.forward),
// ten a layer per power iteration, and the autograd backward of both: ~1,400
// of a train step's ~2,430 graph nodes and ~2,350 of a flow step's ~2,870,
// and ~57,000 eager launches to build a 5-block phi.
//
// What it computes, for points (P, 3) f32 and a chain of blocks
// f(x) = x + g(x), g = 7 x (swish, then a linear layer with the weight
// w / max(1, sigma / coeff), sigma = u . (w v)), channels 3 -> 8 x 6 -> 3:
//   - forward: y = f_K(... f_1(x)), each block's input saved on request;
//   - backward: from the saved inputs and dL/dy, dL/dx and/or one partial
//     per CTA of dL/dw_hat, dL/db and dL/dsoftplus(beta);
//   - grad_reduce: the partials summed in a fixed order, then the chain
//     rules through w / max(1, sigma / coeff) with u and v constant (the
//     clamp passes the gradient where sigma / coeff >= 1, as the backward of
//     torch.clamp_min does) and through softplus, into dL/dw, dL/db and
//     dL/dbeta, laid out layer by layer as (w, b, beta);
//   - power_iter: n rounds of u = W v / |W v|, v = W^T u / |W^T u| on every
//     layer's buffers, in place.
//
// What bounds it on the H100: neither bytes nor operations. A forward over
// the flow's 2400 points is ~12 MFLOP (~0.2 us at the f32 peak) on ~58 KB
// in and out;
// each pass is bound by one launch's latency and by the serial chain of a
// point through 35 layers of dependent 8-wide products. So the design
// counts launches and keeps every intermediate on the chip:
//   - one launch a pass. Each CTA first forms every layer's w_hat and
//     softplus(beta) in shared memory from the live parameters and buffers
//     (~92 floats a layer, read in batches of independent loads), so the
//     normalisation costs no launch; then each thread carries one point
//     through every block, its activations in registers;
//   - the backward recomputes each block from its saved input (3 floats a
//     block and point): nothing per layer goes to device memory;
//   - parameter gradients: per layer, a CTA's 128 points stage (dL/dy, a)
//     in shared memory and reduce them in a fixed order into the CTA's
//     partial (f32 over 8 points, then 16 slices and the CTA's tiles in
//     f64); a second launch sums the partials in a fixed order. No float
//     atomics: two launches on the same inputs give the same bits, and the
//     grid is a function of the shape and the device alone;
//   - the parameters reach the kernels as pointers in the launch's
//     parameter block (up to 8 blocks a launch), so the in-place updates of
//     Adam, load_state_dict and the power iteration are seen, and a
//     captured launch reads the same tensors at every replay.
// The math is the module's, in f32: accurate expf and log1pf (no
// fast-math), the same /1.1 and the same clamp, the per-point divisions in
// branch-free forms that round as IEEE division does (see recip); products
// are plain FMAs, no TF32.

#include <cuda_runtime.h>
#include <math.h>

// One layer's tensors, as the wrapper hands them in: w (out, in), b (out),
// beta (1), u (out), v (in), all f32 contiguous on one device, and the
// layer's coeff. The C interface's type, so outside the file's namespace.
struct ShwdChainLayer {
  const float* w;
  const float* b;
  const float* beta;
  float* u;
  float* v;
  float coeff;
};

namespace {

using Layer = ShwdChainLayer;

constexpr int kDim = 3;                        // point dimension
constexpr int kWidth = 8;                      // hidden width
constexpr int kLayers = 7;                     // layers a block
constexpr int kMaxBlocks = 8;                  // blocks a launch
constexpr int kMaxLayers = kMaxBlocks * kLayers;
constexpr int kThreads = 128;                  // points a tile, one a thread
constexpr int kSliceRows = 8;                  // points a thread sums in the reduction
constexpr int kSlices = kThreads / kSliceRows; // 16
constexpr int kRedCols = kWidth + 2;           // w row, then b, then softplus term
constexpr int kStageRow = kWidth + 1;          // padded rows: no bank conflicts
constexpr int kTableRow = kWidth * kWidth + 3 * kWidth + 4;   // w_hat, b, sp, pad, u, v: 92
constexpr int kReduceValues = 80;              // >= the values of any layer (73)
constexpr int kReduceThreads = 4 * kReduceValues;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPowerThreads = kWarp;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int in_of(int l) { return l == 0 ? kDim : kWidth; }
__host__ __device__ constexpr int out_of(int l) { return l == kLayers - 1 ? kDim : kWidth; }
// a layer's gradient values: w (out x in), b (out), beta (1)
__host__ __device__ constexpr int values_of(int l) { return out_of(l) * in_of(l) + out_of(l) + 1; }
__host__ __device__ constexpr int value_offset(int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += values_of(i);
  return off;
}
constexpr int kValuesPerBlock = value_offset(kLayers);
static_assert(kValuesPerBlock == 426, "a block's (w, b, beta) floats");
static_assert(values_of(1) <= kReduceValues, "a layer's values fit the reduction");

struct Chain {
  Layer layer[kMaxLayers];
  int blocks;
};

// The shared table, a row a layer: w_hat (8 x 8, zero outside out x in), b,
// softplus(beta), padding, and the power-iteration pair u, v.
struct Table {
  float wh[kWidth * kWidth];
  float b[kWidth];
  float sp;
  float pad[3];
  float u[kWidth];
  float v[kWidth];
};
static_assert(sizeof(Table) == kTableRow * sizeof(float), "table row");

__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));          // F.softplus, threshold 20
}

// The per-point passes divide without the IEEE division's code: its
// slow-path branch splits each division into its own basic block, which
// kept the compiler from interleaving a thread's eight independent lanes
// (the passes ran 1.2-2.3x slower). Both forms below give the correctly
// rounded quotient, as the division does: checked on the card against
// IEEE division for every d in [1, 2^126) and for every float x.
//
// 1 / d for d >= 1: the approximate reciprocal, one Newton step and one
// correction, in f32; 0 from d = 2^126 on (the division gives at most
// 2^-126 there; d = 1 + exp(-t) reaches it only for t < -87).
__device__ __forceinline__ float recip(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  r = fmaf(fmaf(-d, r, 1.0f), r, r);
  const float q = fmaf(fmaf(-d, r, 1.0f), r, r);
  return d >= 0x1p126f ? 0.0f : q;
}

// x / 1.1f: x times the f64 reciprocal of 1.1f, rounded once to f32 (the
// same correction in f32 misrounds tiny x).
constexpr double kInvDiv = 1.0 / (double)1.1f;
__device__ __forceinline__ float div11(float x) { return (float)((double)x * kInvDiv); }

// torch.sigmoid's 1 / (1 + exp(-t))
__device__ __forceinline__ float sigmoid(float t) { return recip(1.0f + expf(-t)); }

// sigma = u . (W v) from a staged row (w 8 x 8), the module's order: W v
// first, then the dot with u. The gradients' reduction forms it with the
// same operations in the same order, so the forward and the chain rule
// divide by the same max(1, sigma / coeff).
__device__ __forceinline__ float layer_sigma(const float* w, const float* u, const float* v,
                                             int out, int in) {
  float s = 0.0f;
  for (int j = 0; j < out; ++j) {
    float wv = 0.0f;
    for (int k = 0; k < in; ++k) wv = fmaf(w[j * kWidth + k], v[k], wv);
    s = fmaf(u[j], wv, s);
  }
  return s;
}

// Element r of layer l's table row, read from the layer's tensors (0 in the
// padding).
__device__ __forceinline__ float raw_entry(const Chain& c, int l, int r) {
  const Layer& L = c.layer[l];
  const int li = l % kLayers, in = in_of(li), out = out_of(li);
  if (r < kWidth * kWidth) {
    const int j = r / kWidth, k = r % kWidth;
    return (j < out && k < in) ? L.w[j * in + k] : 0.0f;
  }
  r -= kWidth * kWidth;
  if (r < kWidth) return r < out ? L.b[r] : 0.0f;
  r -= kWidth;
  if (r == 0) return L.beta[0];
  r -= 4;
  if (r < 0) return 0.0f;
  if (r < kWidth) return r < out ? L.u[r] : 0.0f;
  r -= kWidth;
  return r < in ? L.v[r] : 0.0f;
}

// Every layer's w_hat = w / max(sigma / coeff, 1), b, softplus(beta), u and
// v into the table; `den` (kMaxLayers floats) is scratch. The tensors are
// read in batches of independent loads (a dependent chain of loads, one
// element at a time, took most of a launch). Ends synced.
__device__ __forceinline__ void build_table(const Chain& c, Table* table, float* den) {
  constexpr int kBatch = 16;
  const int n = c.blocks * kLayers, total = n * kTableRow;
  float* flat = reinterpret_cast<float*>(table);
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    float vals[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = base + i * blockDim.x;
      vals[i] = e < total ? raw_entry(c, e / kTableRow, e % kTableRow) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = base + i * blockDim.x;
      if (e < total) flat[e] = vals[i];
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    Table& t = table[l];
    const int li = l % kLayers;
    den[l] = fmaxf(layer_sigma(t.wh, t.u, t.v, out_of(li), in_of(li)) / c.layer[l].coeff, 1.0f);
    t.sp = softplus(t.sp);                          // the row held beta
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * kWidth * kWidth; e += blockDim.x) {
    const int l = e / (kWidth * kWidth);
    table[l].wh[e % (kWidth * kWidth)] /= den[l];
  }
  __syncthreads();
}

// Layer kLayer of a block on one point: h <- W_hat swish(h) + b; with
// kRecord, z <- the swish input. Templates keep every index a constant, so
// the activations stay in registers.
template <int kLayer, bool kRecord>
__device__ __forceinline__ void layer_forward(const Table& L, float (&h)[kWidth],
                                              float (&z)[kWidth]) {
  constexpr int in = in_of(kLayer), out = out_of(kLayer);
  float a[kWidth];
#pragma unroll
  for (int k = 0; k < in; ++k) {
    if (kRecord) z[k] = h[k];
    a[k] = div11(h[k] * sigmoid(h[k] * L.sp));
  }
#pragma unroll
  for (int j = 0; j < out; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < in; ++k) acc = fmaf(a[k], L.wh[j * kWidth + k], acc);
    h[j] = acc + L.b[j];
  }
}

// One block on one point, x <- x + g(x); with kRecord, z[l] holds layer l's
// swish input.
template <bool kRecord>
__device__ __forceinline__ void block_forward(const Table* t, float (&x)[kDim],
                                              float (&z)[kLayers][kWidth]) {
  float h[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) h[k] = k < kDim ? x[k] : 0.0f;
  layer_forward<0, kRecord>(t[0], h, z[0]);
  layer_forward<1, kRecord>(t[1], h, z[1]);
  layer_forward<2, kRecord>(t[2], h, z[2]);
  layer_forward<3, kRecord>(t[3], h, z[3]);
  layer_forward<4, kRecord>(t[4], h, z[4]);
  layer_forward<5, kRecord>(t[5], h, z[5]);
  layer_forward<6, kRecord>(t[6], h, z[6]);
#pragma unroll
  for (int d = 0; d < kDim; ++d) x[d] += h[d];
}

__global__ void __launch_bounds__(kThreads) forward_kernel(const Chain c, const float* __restrict__ x,
                                                           float* __restrict__ y,
                                                           float* __restrict__ saved, long long n) {
  __shared__ __align__(16) Table table[kMaxLayers];
  __shared__ float den[kMaxLayers];
  build_table(c, table, den);
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  float v[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) v[d] = x[p * kDim + d];
  float z[kLayers][kWidth];                         // unused without kRecord
  for (int k = 0; k < c.blocks; ++k) {
    if (saved != nullptr) {
#pragma unroll
      for (int d = 0; d < kDim; ++d) saved[((long long)k * n + p) * kDim + d] = v[d];
    }
    block_forward<false>(table + k * kLayers, v, z);
  }
#pragma unroll
  for (int d = 0; d < kDim; ++d) y[p * kDim + d] = v[d];
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// Shared memory of the backward, in floats from the dynamic base.
constexpr int kTableFloats = kMaxLayers * kTableRow;
constexpr int kDenFloats = kMaxLayers;
constexpr int kStageFloats = 2 * kThreads * kStageRow + kThreads;     // g, a, softplus term
constexpr int kRedFloats = kSlices * kWidth * kRedCols;
constexpr int kAccOffsetFloats = kTableFloats + kDenFloats + kStageFloats + kRedFloats;
static_assert(kAccOffsetFloats % 4 == 0, "the f64 accumulators are 16-byte aligned");

size_t backward_smem_bytes(int blocks, bool params) {
  if (!params) return (size_t)(kTableFloats + kDenFloats) * sizeof(float);
  return (size_t)kAccOffsetFloats * sizeof(float) + (size_t)blocks * kValuesPerBlock * sizeof(double);
}

// Stage one layer's (dL/dy, a, softplus term) of every point of the tile,
// reduce them in a fixed order and add the tile's sums to the CTA's f64
// accumulators of the layer. All threads call it together.
template <int kLayer>
__device__ __forceinline__ void reduce_layer(const float (&gy)[kWidth], const float (&a)[kWidth],
                                             float tsp, float* stage, float* red, double* acc) {
  constexpr int in = in_of(kLayer), out = out_of(kLayer);
  float* sg = stage;                                  // [kThreads][kStageRow]
  float* sa = stage + kThreads * kStageRow;           // [kThreads][kStageRow]
  float* st = stage + 2 * kThreads * kStageRow;       // [kThreads]
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    sg[tid * kStageRow + k] = gy[k];
    sa[tid * kStageRow + k] = a[k];
  }
  st[tid] = tsp;
  __syncthreads();
  {
    // thread (row j, slice s) sums its 8 points: w row j, b_j, and for
    // j = 0 the softplus term
    const int j = tid % kWidth, s = tid / kWidth;
    float w_sum[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) w_sum[k] = 0.0f;
    float b_sum = 0.0f, t_sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kSliceRows; ++i) {
      const int p = s * kSliceRows + i;
      const float g = sg[p * kStageRow + j];
#pragma unroll
      for (int k = 0; k < kWidth; ++k)
        if (k < in) w_sum[k] = fmaf(g, sa[p * kStageRow + k], w_sum[k]);
      b_sum += g;
      t_sum += st[p];
    }
    float* r = red + (s * kWidth + j) * kRedCols;
#pragma unroll
    for (int k = 0; k < kWidth; ++k) r[k] = w_sum[k];
    r[kWidth] = b_sum;
    r[kWidth + 1] = t_sum;
  }
  __syncthreads();
  if (tid < values_of(kLayer)) {
    int j, col;
    if (tid < out * in) {
      j = tid / in;
      col = tid % in;
    } else if (tid < out * in + out) {
      j = tid - out * in;
      col = kWidth;
    } else {
      j = 0;
      col = kWidth + 1;
    }
    double sum = 0.0;
    for (int s = 0; s < kSlices; ++s) sum += (double)red[(s * kWidth + j) * kRedCols + col];
    acc[value_offset(kLayer) + tid] += sum;
  }
  // Single buffers suffice: the next call writes the stage after these
  // reads of it (the barrier above) and `red` after its own first barrier,
  // which every thread reaches only after these reads of `red`.
}

// Layer kLayer backward on one point: gy holds dL/d(layer output) and
// becomes dL/d(swish input); z is the swish input. With `params` (the same
// in every thread) the layer's gradient sums go to acc.
template <int kLayer>
__device__ __forceinline__ void layer_backward(const Table& L, const float (&z)[kWidth],
                                               float (&gy)[kWidth], bool params, float* stage,
                                               float* red, double* acc) {
  constexpr int in = in_of(kLayer), out = out_of(kLayer);
  float a[kWidth], gz[kWidth];
  float tsp = 0.0f;
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    a[k] = 0.0f;
    gz[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < in; ++k) {
    const float s = sigmoid(z[k] * L.sp);
    a[k] = div11(z[k] * s);
    float ga = 0.0f;
#pragma unroll
    for (int j = 0; j < out; ++j) ga = fmaf(L.wh[j * kWidth + k], gy[j], ga);
    // a = (z * s) / 1.1, s = sigmoid(z * sp)
    const float gn = div11(ga);
    const float gt = gn * z[k] * (1.0f - s) * s;
    gz[k] = gn * s + gt * L.sp;
    tsp = fmaf(gt, z[k], tsp);
  }
  if (params) reduce_layer<kLayer>(gy, a, tsp, stage, red, acc);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) gy[k] = gz[k];
}

// One block backward on one point: g holds dL/d(block output) and becomes
// dL/d(block input); with `params` the layers' gradient sums go to acc.
__device__ __forceinline__ void block_backward(const Table* t, const float (&x)[kDim],
                                               float (&g)[kDim], bool params, float* stage,
                                               float* red, double* acc) {
  float z[kLayers][kWidth];
  float xo[kDim] = {x[0], x[1], x[2]};
  block_forward<true>(t, xo, z);
  float gy[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) gy[k] = k < kDim ? g[k] : 0.0f;
  layer_backward<6>(t[6], z[6], gy, params, stage, red, acc);
  layer_backward<5>(t[5], z[5], gy, params, stage, red, acc);
  layer_backward<4>(t[4], z[4], gy, params, stage, red, acc);
  layer_backward<3>(t[3], z[3], gy, params, stage, red, acc);
  layer_backward<2>(t[2], z[2], gy, params, stage, red, acc);
  layer_backward<1>(t[1], z[1], gy, params, stage, red, acc);
  layer_backward<0>(t[0], z[0], gy, params, stage, red, acc);
#pragma unroll
  for (int d = 0; d < kDim; ++d) g[d] += gy[d];
}

// dL/dx where gx is given; the parameters' partials where partials is
// given (one branch for every thread of the launch: a template argument in
// its place left the dL/dx-only kernel spilling to the stack).
__global__ void __launch_bounds__(kThreads) backward_kernel(const Chain c, const float* __restrict__ saved,
                                                            const float* __restrict__ gy,
                                                            float* __restrict__ gx,
                                                            double* __restrict__ partials,
                                                            long long n, int tiles) {
  extern __shared__ __align__(16) float smem[];
  Table* table = reinterpret_cast<Table*>(smem);
  float* den = smem + kTableFloats;
  float* stage = den + kDenFloats;
  float* red = stage + kStageFloats;
  double* acc = reinterpret_cast<double*>(smem + kAccOffsetFloats);
  const int values = c.blocks * kValuesPerBlock;
  const bool params = partials != nullptr;
  if (params)
    for (int v = threadIdx.x; v < values; v += blockDim.x) acc[v] = 0.0;
  build_table(c, table, den);                         // ends synced
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p = (long long)tile * kThreads + threadIdx.x;
    const bool valid = p < n;                         // others carry zeros
    float g[kDim];
#pragma unroll
    for (int d = 0; d < kDim; ++d) g[d] = valid ? gy[p * kDim + d] : 0.0f;
    for (int k = c.blocks - 1; k >= 0; --k) {
      float x[kDim];
#pragma unroll
      for (int d = 0; d < kDim; ++d) x[d] = valid ? saved[((long long)k * n + p) * kDim + d] : 0.0f;
      block_backward(table + k * kLayers, x, g, params, stage, red, acc + k * kValuesPerBlock);
    }
    if (gx != nullptr && valid) {
#pragma unroll
      for (int d = 0; d < kDim; ++d) gx[p * kDim + d] = g[d];
    }
  }
  if (params) {
    __syncthreads();
    for (int v = threadIdx.x; v < values; v += blockDim.x)
      partials[(long long)blockIdx.x * values + v] = acc[v];
  }
}

// One CTA a layer: the layer's sums over the partial rows (four strided
// quarters, then the quarters in order), then the chain rules.
__global__ void __launch_bounds__(kReduceThreads) grad_reduce_kernel(const Chain c,
                                                                     const double* __restrict__ partials,
                                                                     int rows, float* __restrict__ grads) {
  __shared__ double part[4][kReduceValues];
  __shared__ float total[kReduceValues];
  __shared__ Table row;                             // w (8 x 8), beta, u, v
  __shared__ float s_den, s_ratio, s_corr;
  const int l = blockIdx.x, li = l % kLayers, blk = l / kLayers;
  const int in = in_of(li), out = out_of(li), nl = values_of(li);
  const int off = blk * kValuesPerBlock + value_offset(li);
  const int values = c.blocks * kValuesPerBlock;
  const Layer& L = c.layer[l];
  const int tid = threadIdx.x, v = tid % kReduceValues, q = tid / kReduceValues;
  if (tid < kTableRow) reinterpret_cast<float*>(&row)[tid] = raw_entry(c, l, tid);
  if (v < nl) {
    double s = 0.0;
#pragma unroll 8
    for (int r = q; r < rows; r += 4) s += partials[(long long)r * values + off + v];
    part[q][v] = s;
  }
  __syncthreads();
  if (tid < kWarp) {
    // sigma as layer_sigma forms it (the table's): lane j forms (W v)_j,
    // then the dot with u in the order of j
    float wv = 0.0f;
    if (tid < out)
      for (int k = 0; k < in; ++k) wv = fmaf(row.wh[tid * kWidth + k], row.v[k], wv);
    float sigma = 0.0f;
    for (int j = 0; j < out; ++j) sigma = fmaf(row.u[j], __shfl_sync(kFullMask, wv, j), sigma);
    if (tid == 0) {
      s_ratio = sigma / L.coeff;
      s_den = fmaxf(s_ratio, 1.0f);
    }
  }
  if (tid < nl) total[tid] = (float)(((part[0][tid] + part[1][tid]) + part[2][tid]) + part[3][tid]);
  __syncthreads();
  const float den = s_den;
  if (tid < kWarp) {
    // d/d den of w / den, summed over the layer: sum(-G * w / (den * den)),
    // in f64 over the lanes, then a fixed shuffle tree
    double corr = 0.0;
    for (int e = tid; e < out * in; e += kWarp)
      corr += (double)((-total[e] * row.wh[(e / in) * kWidth + e % in]) / (den * den));
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) corr += __shfl_xor_sync(kFullMask, corr, o);
    if (tid == 0) s_corr = (float)corr;
  }
  __syncthreads();
  float* gw = grads + off;
  if (tid < out * in) {
    float g = total[tid] / den;
    if (s_ratio >= 1.0f) {            // clamp_min's backward passes the tie
      const float g_sigma = s_corr / L.coeff;
      g += (row.u[tid / in] * g_sigma) * row.v[tid % in];
    }
    gw[tid] = g;
  } else if (tid < out * in + out) {
    gw[tid] = total[tid];
  } else if (tid == nl - 1) {
    const float beta = row.sp, gsp = total[tid];    // the staged row holds beta
    const float e = expf(beta);                                // softplus' backward
    gw[tid] = beta > 20.0f ? gsp : gsp * e / (e + 1.0f);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// One warp a layer: lane j holds row j of W and lane k column k.
__global__ void __launch_bounds__(kPowerThreads) power_iter_kernel(const Chain c, int n_iter) {
  const int l = blockIdx.x, li = l % kLayers;
  const int in = in_of(li), out = out_of(li);
  const Layer& L = c.layer[l];
  const int lane = threadIdx.x;
  float row[kWidth], col[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    row[k] = (lane < out && k < in) ? L.w[lane * in + k] : 0.0f;
    col[k] = (lane < in && k < out) ? L.w[k * in + lane] : 0.0f;
  }
  float v = lane < in ? L.v[lane] : 0.0f;
  float u = 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    float wv = 0.0f;
#pragma unroll
    for (int k = 0; k < kWidth; ++k) wv = fmaf(row[k], __shfl_sync(kFullMask, v, k), wv);
    u = wv / fmaxf(sqrtf(warp_sum(wv * wv)), 1e-12f);
    float wtu = 0.0f;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) wtu = fmaf(col[j], __shfl_sync(kFullMask, u, j), wtu);
    v = wtu / fmaxf(sqrtf(warp_sum(wtu * wtu)), 1e-12f);
  }
  if (lane < out) L.u[lane] = u;
  if (lane < in) L.v[lane] = v;
}

cudaError_t make_chain(const Layer* layers, int blocks, Chain* c) {
  if (layers == nullptr || blocks < 1 || blocks > kMaxBlocks) return cudaErrorInvalidValue;
  c->blocks = blocks;
  for (int i = 0; i < blocks * kLayers; ++i) c->layer[i] = layers[i];
  return cudaSuccess;
}

int g_sms[kMaxDevices];
bool g_ready[kMaxDevices];

cudaError_t prepare_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_ready[dev]) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)backward_smem_bytes(kMaxBlocks, true));
    if (err != cudaSuccess) return err;
    g_ready[dev] = true;
  }
  *sms = g_sms[dev];
  return cudaSuccess;
}

long long tiles_of(long long n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int shwd_residual_chain_max_blocks() { return kMaxBlocks; }

int shwd_residual_chain_values_per_block() { return kValuesPerBlock; }

// CTAs of the backward with parameter gradients on n points: the rows of
// its partials (two CTAs an SM at most, each walking its tiles). 0 for
// arguments it does not take.
int shwd_residual_chain_backward_grid(long long n) {
  int sms = 0;
  if (n < 1 || tiles_of(n) > 0x7fffffffLL || prepare_device(&sms) != cudaSuccess) return 0;
  const long long cap = 2LL * sms;
  return (int)(tiles_of(n) < cap ? tiles_of(n) : cap);
}

// layers: blocks x 7 layers; x, y (n, 3); saved (blocks, n, 3) or null.
int shwd_residual_chain_forward(const Layer* layers, int blocks, const float* x, float* y,
                                float* saved, long long n, void* stream) {
  Chain c;
  cudaError_t err = make_chain(layers, blocks, &c);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || tiles_of(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  forward_kernel<<<(unsigned)tiles_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, x, y, saved, n);
  return (int)cudaGetLastError();
}

// saved (blocks, n, 3) from the forward, gy (n, 3); gx (n, 3) or null;
// partials (grid, blocks x 426) f64 or null, grid as
// shwd_residual_chain_backward_grid(n) says. At least one of gx and
// partials.
int shwd_residual_chain_backward(const Layer* layers, int blocks, const float* saved,
                                 const float* gy, float* gx, double* partials, int grid,
                                 long long n, void* stream) {
  Chain c;
  cudaError_t err = make_chain(layers, blocks, &c);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = prepare_device(&sms);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || tiles_of(n) > 0x7fffffffLL || (gx == nullptr && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)tiles_of(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (partials == nullptr) {
    backward_kernel<<<tiles, kThreads, backward_smem_bytes(blocks, false), st>>>(
        c, saved, gy, gx, nullptr, n, tiles);
  } else {
    if (grid != shwd_residual_chain_backward_grid(n)) return (int)cudaErrorInvalidValue;
    backward_kernel<<<grid, kThreads, backward_smem_bytes(blocks, true), st>>>(
        c, saved, gy, gx, partials, n, tiles);
  }
  return (int)cudaGetLastError();
}

// partials (rows, blocks x 426) f64 -> grads (blocks x 426) f32: per layer
// dL/dw (out, in), dL/db (out), dL/dbeta (1).
int shwd_residual_chain_grad_reduce(const Layer* layers, int blocks, const double* partials,
                                    int rows, float* grads, void* stream) {
  Chain c;
  cudaError_t err = make_chain(layers, blocks, &c);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  grad_reduce_kernel<<<blocks * kLayers, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, partials, rows, grads);
  return (int)cudaGetLastError();
}

// n_iter >= 1 rounds of power iteration on every layer's u and v, in place.
int shwd_residual_chain_power_iter(const Layer* layers, int blocks, int n_iter, void* stream) {
  Chain c;
  cudaError_t err = make_chain(layers, blocks, &c);
  if (err != cudaSuccess) return (int)err;
  if (n_iter < 1) return (int)cudaErrorInvalidValue;
  power_iter_kernel<<<blocks * kLayers, kPowerThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, n_iter);
  return (int)cudaGetLastError();
}

// The launch floor of the forward, for measurements only: the same grid
// and block with an empty body.
int shwd_residual_chain_empty(long long n, void* stream) {
  if (n < 1 || tiles_of(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  empty_kernel<<<(unsigned)tiles_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
