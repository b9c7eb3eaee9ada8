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
// 40 x 8), about 0.22 ms on the special-function units (16 per clock per
// SM). Above that bound stands the chain floor: the g-update needs every
// row and the f-update every column, so an iteration is two exchanges
// across the whole grid that no layout can overlap, 2 * S * I = 640 per
// call, each a write that has to reach L2 and be read back from there
// (shwd_emd2_warmup_exchanges times them bare). What the kernel pays is
// that chain plus the scheduler slots of about a dozen operations around
// each exp, on blocks that all wait for the slowest.
//
// Design: one persistent cooperative launch runs the max |C| pass, all
// S * I iterations and the value pass; the grid is one block of 1024
// threads per SM (times the occupancy the runtime reports, 256 blocks at
// most), so all blocks are co-resident and may wait for each other.
//   - The B * N rows are dealt to the blocks in contiguous runs (10 rows
//     each at 1 x 1200 x 1200: 120 blocks). A block loads its rows into
//     shared memory once, so the cost is read from L2 once per call. When
//     a block's run does not fit in shared memory, the same code reads its
//     rows from global memory instead. f of the block's rows lives in
//     shared memory and is written out once at the end.
//   - f-update, local to the block: g of the block's items is copied from
//     L2 into shared memory once per iteration (every warp reading it from
//     L2 made the 4.8 KB a hot spot); the warps share out (row, column
//     chunk) units, each one pass with up to 16 z values in registers per
//     lane and a running (max, sum); the chunks of a row are merged in
//     chunk order.
//   - g-update: each thread walks its columns down the block's rows and
//     writes one (max, sum) partial per column into a scratch tensor, laid
//     out (block, column) so that the writes are coalesced; the columns
//     are dealt to the blocks, which bring the partials of up to 32
//     columns at a time into shared memory (neighbouring threads on
//     neighbouring words) and merge each column with one warp, over the
//     blocks holding rows of its item, always in block order; write g.
//     No float atomics: the same input gives the same bits on every run.
//   - No barrier inside the iterations: every exchanged word carries its
//     own mark. g travels as an 8-byte (value, iteration it is for), a
//     partial as (max, sum) with the iteration's parity in the sign of the
//     sum (never negative), each written by one 64-bit st.relaxed.gpu and
//     polled by one 64-bit ld.relaxed.gpu until the mark is the one the
//     reader waits for. A writer cannot overrun a reader: the value of
//     its next write is computed from words of blocks that have read its
//     last one. Grid barriers (cooperative groups) remain
//     around the max |C| pass and before the value pass, 4 per call.
//   - With the rows and g in shared memory and M a multiple of 4, the two
//     inner loops read 16 and 8 bytes at a time (four columns per lane,
//     a pair of columns per thread).
//   - exp(x), x <= 0, is ex2.approx(x log2 e): two operations instead of
//     expf's eight. z itself keeps the plain version's arithmetic
//     ((g - C) / e + log b, in that order): at the small temperatures z
//     is ~1e5 and its rounding decides the result, so it must not change.
//   - eps0 and val are reduced like g (per-block partials, merged in block
//     order by the block that holds the item's first row).
//   One launch per call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr int kPerLane = 16;     // columns (or rows) a thread holds in registers at a time
constexpr int kQuads = 4;        //   the same in groups of four columns
constexpr int kRows = 8;         //   rows of a pair of columns
constexpr int kSlotsPerLane = 8; // a column's partials a lane holds
constexpr int kMaxGrid = 32 * kSlotsPerLane;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* cost;   // (B, n, m)
  float* val;          // (B,)
  float* f;            // (B, n)
  float* g;            // (B, m)
  float* log_e0;       // (B,)
  float2* col_part;    // (slots, B * m): a column's (max, sum) per block
  float2* g_mark;      // (B, m): g with the iteration it is meant for
  float* item_part;    // (B, slots): an item's max |C|, later its value
  int batch, n, m;
  int rows_per_block, slots, resident, g_cached, units, row_items, col_items;
  int tile_shift, tile_floats;
  float log_et, log_a, log_b, log_ab;
  int num_iters, num_scales;
};

__device__ __forceinline__ float eps_at(float log_e0, float log_et, int s,
                                        int num_scales) {
  const float r = (float)s / (float)(num_scales > 1 ? num_scales - 1 : 1);
  return expf(log_e0 * (1.0f - r) + log_et * r);
}

// e^x for x <= 0 on the special-function unit: 2^(x log2 e), 2 ulp of the
// unit plus the rounding of the product (relative 6e-8 |x|, which only
// touches terms that are small beside the largest); results below 2^-126
// flush to 0
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// Exchanges between blocks carry their own "ready" mark, so the reader
// polls the word it needs and no barrier stands between the iterations. g
// travels as (value, iteration it is meant for); a column partial as (max,
// sum) with the iteration's parity in the sign of the sum, which is never
// negative. Each pair is ONE 64-bit access at both ends, a relaxed store
// and a relaxed load at gpu scope: the memory model then promises that a
// reader sees the mark and its value together, and a strong store that
// meets a strong load is no data race.
__device__ __forceinline__ void store_now(float2* p, float x, float y) {
  const unsigned long long w =
      (unsigned long long)__float_as_uint(x) | ((unsigned long long)__float_as_uint(y) << 32);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ float2 load_now(const float2* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return make_float2(__uint_as_float((unsigned)w), __uint_as_float((unsigned)(w >> 32)));
}
__device__ __forceinline__ float poll_g(const float2* p, int t) {
  float2 v = load_now(p);
  while (__float_as_int(v.y) != t) v = load_now(p);
  return v.x;
}
__device__ __forceinline__ float2 poll_partial(const float2* p, int t) {
  float2 v = load_now(p);
  while (((__float_as_uint(v.y) >> 31) ^ (unsigned)t) & 1u) v = load_now(p);
  v.y = fabsf(v.y);
  return v;
}
__device__ __forceinline__ float with_parity(float sum, int t) {
  return __uint_as_float(__float_as_uint(sum) | ((unsigned)t << 31));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// the same tree on every run, and the same total in every lane
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// block-wide reduction; the result is valid in thread 0. Ends in a barrier
// so that calls can follow each other.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? scratch[lane] : (kMax ? kNeg : 0.0f);
    v = kMax ? warp_max(v) : warp_sum(v);
  }
  __syncthreads();
  return v;
}

// the first and the last block that hold rows of item b
__device__ __forceinline__ int first_block(const Params& p, int b) {
  return (int)(((long long)b * p.n) / p.rows_per_block);
}
__device__ __forceinline__ int last_block(const Params& p, int b) {
  return (int)(((long long)(b + 1) * p.n - 1) / p.rows_per_block);
}

// Merge the per-block partials of item b (a maximum or a sum, in block
// order) when this block holds the item's first row; one warp per item.
template <bool kMax>
__device__ float merge_item(const Params& p, int b, int lane) {
  const int slots = last_block(p, b) - first_block(p, b) + 1;
  float v = kMax ? kNeg : 0.0f;
  for (int k = lane; k < slots; k += 32) {
    const float x = __ldcg(p.item_part + (long long)b * p.slots + k);
    v = kMax ? fmaxf(v, x) : v + x;
  }
  return kMax ? warp_max(v) : warp_sum(v);
}

// fold z[0..K) into a running log-sum-exp (mx, sum); mn is its new maximum
template <int K>
__device__ __forceinline__ void lse_fold(float& mx, float& sum, const float* z, float mn) {
  sum *= exp_fast(mx - mn);
#pragma unroll
  for (int k = 0; k < K; ++k) sum += exp_fast(z[k] - mn);
  mx = mn;
}

__global__ void __launch_bounds__(kThreads) warmup_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float2* tile = reinterpret_cast<float2*>(smem);   // slots rows of tile_w + 1 partials
  float* c_s = smem + p.tile_floats;                // rows_per_block * m, if resident
  float* g_s = c_s + (p.resident ? (size_t)p.rows_per_block * p.m : 0);  // row_items * m, if g_cached
  float* red = g_s + (p.g_cached ? (size_t)p.row_items * p.m : 0);       // kWarps
  float* f_s = red + kWarps;                // rows_per_block
  float* part_m = f_s + p.rows_per_block;   // units
  float* part_s = part_m + p.units;         // units
  float* loge_r = part_s + p.units;         // row_items: log eps0 of the rows' items,
  float* e_r = loge_r + p.row_items;        //   their temperature at this scale
  float* k_r = e_r + p.row_items;           //   and its inverse
  float* loge_c = k_r + p.row_items;        // col_items: the same of the columns' items
  float* e_c = loge_c + p.col_items;
  int* row_item = reinterpret_cast<int*>(e_c + p.col_items);   // rows_per_block: a row's item
  int* row_slot = row_item + p.rows_per_block;   // row_items: this block's slot in an item's partials

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, m = p.m;
  const long long total_rows = (long long)p.batch * n;
  const long long r0 = (long long)blockIdx.x * p.rows_per_block;
  const long long r1 = min(total_rows, r0 + p.rows_per_block);
  const int nr = (int)(r1 - r0);                       // >= 1 by the layout
  const int b0 = (int)(r0 / n), b1 = (int)((r1 - 1) / n);
  // the items whose first row this block holds
  const int own0 = (r0 % n == 0) ? b0 : b0 + 1;
  // entry `off` of the block's rows (local row lr starts at lr * m)
  const float* rows_g = p.cost + r0 * m;
  auto cost_at = [&](int off) { return p.resident ? c_s[off] : rows_g[off]; };
  // rows and g in shared memory and 16-byte aligned: the wide loops
  const bool fast = p.resident && p.g_cached && (m & 3) == 0;

  // columns of g this block merges
  const long long total_cols = (long long)p.batch * m;
  const long long cols_per_block = (total_cols + gridDim.x - 1) / gridDim.x;
  const long long c0 = min(total_cols, blockIdx.x * cols_per_block);
  const long long c1 = min(total_cols, c0 + cols_per_block);
  const int bc0 = (int)(c0 / m);             // the first item among them

  // ---- load the block's rows, max |C| per item, g = 0 ----
  for (int b = b0; b <= b1; ++b) {
    const long long la = max(r0, (long long)b * n) - r0;
    const long long lb = min(r1, (long long)(b + 1) * n) - r0;
    float mx = 0.0f;
    for (long long idx = la * m + tid; idx < lb * m; idx += kThreads) {
      const float v = rows_g[idx];
      if (p.resident) c_s[idx] = v;
      mx = fmaxf(mx, fabsf(v));
    }
    mx = block_reduce<true>(mx, red);
    if (tid == 0) p.item_part[(long long)b * p.slots + blockIdx.x - first_block(p, b)] = mx;
  }
  for (long long c = c0 + tid; c < c1; c += kThreads)
    store_now(p.g_mark + c, 0.0f, __int_as_float(0));
  // the partials this block will write: marked odd, so iteration 0 waits
  for (int b = b0; b <= b1; ++b) {
    float2* out = p.col_part + (blockIdx.x - first_block(p, b)) * total_cols + (long long)b * m;
    for (int j = tid; j < m; j += kThreads) store_now(out + j, kNeg, with_parity(0.0f, 1));
  }
  grid.sync();
  for (int b = own0 + warp; b <= b1; b += kWarps) {
    const float mx = merge_item<true>(p, b, lane);
    if (lane == 0) p.log_e0[b] = logf(fmaxf(mx, 1e-30f));
  }
  grid.sync();
  for (int k = tid; k < p.row_items; k += kThreads)
    loge_r[k] = b0 + k < p.batch ? __ldcg(p.log_e0 + b0 + k) : 0.0f;
  for (int k = tid; k < p.col_items; k += kThreads)
    loge_c[k] = bc0 + k < p.batch ? __ldcg(p.log_e0 + bc0 + k) : 0.0f;
  for (int lr = tid; lr < nr; lr += kThreads) row_item[lr] = (int)((r0 + lr) / n);
  for (int k = tid; k <= b1 - b0; k += kThreads) row_slot[k] = blockIdx.x - first_block(p, b0 + k);

  // (row, column chunk) units of the f-update: `split` warps share a row
  const int split = max(1, kWarps / nr);
  const int chunk = (((m + split - 1) / split) + 31) & ~31;
  // the block's items' part of g, as the f-update reads it
  const int g_count = (b1 - b0 + 1) * m;
  const float2* g_rows = p.g_mark + (long long)b0 * m;
  const int tile_w = 1 << p.tile_shift;
  // of the columns in the merge's tile: their item and how many blocks
  // write a partial for it (once, if all the block's columns fit one tile)
  __shared__ int item_of[32], slots_of[32];
  auto describe_tile = [&](long long ca, int ncols) {
    if (tid < ncols) {
      item_of[tid] = (int)((ca + tid) / m);
      slots_of[tid] = last_block(p, item_of[tid]) - first_block(p, item_of[tid]) + 1;
    }
    __syncthreads();
  };
  const bool one_tile = c1 - c0 <= tile_w;
  if (one_tile) describe_tile(c0, (int)(c1 - c0));

  int t = 0;                       // iterations done, over all scales
  for (int s = 0; s < p.num_scales; ++s) {
    __syncthreads();
    for (int k = tid; k < p.row_items; k += kThreads) {
      e_r[k] = eps_at(loge_r[k], p.log_et, s, p.num_scales);
      k_r[k] = 1.0f / e_r[k];
    }
    for (int k = tid; k < p.col_items; k += kThreads)
      e_c[k] = eps_at(loge_c[k], p.log_et, s, p.num_scales);
    for (int it = 0; it < p.num_iters; ++it, ++t) {
      // ---- f-update on the block's rows: one pass per unit, the running
      // maximum the warp's, the sum this lane's ----
      if (p.g_cached)
        for (int idx = tid; idx < g_count; idx += kThreads) g_s[idx] = poll_g(g_rows + idx, t);
      __syncthreads();
      for (int u = warp; u < nr * split; u += kWarps) {
        const int lr = u / split, ch = u - lr * split;
        const int b = row_item[lr];
        const float kk = k_r[b - b0];
        const int j1 = min(m, (ch + 1) * chunk);
        float mx = kNeg, sum = 0.0f;
        if (fast) {               // four columns per lane and load
          const float4* c4 = reinterpret_cast<const float4*>(c_s + lr * m);
          const float4* g4 = reinterpret_cast<const float4*>(g_s + (b - b0) * m);
          for (int qa = ch * chunk / 4; qa < j1 / 4; qa += 32 * kQuads) {
            float z[4 * kQuads];
            float zmax = kNeg;
#pragma unroll
            for (int k = 0; k < kQuads; ++k) {
              const int q = qa + 32 * k + lane;
              if (q < j1 / 4) {
                const float4 c = c4[q], g = g4[q];
                z[4 * k] = (g.x - c.x) * kk + p.log_b;
                z[4 * k + 1] = (g.y - c.y) * kk + p.log_b;
                z[4 * k + 2] = (g.z - c.z) * kk + p.log_b;
                z[4 * k + 3] = (g.w - c.w) * kk + p.log_b;
              } else {
                z[4 * k] = z[4 * k + 1] = z[4 * k + 2] = z[4 * k + 3] = -INFINITY;
              }
              zmax = fmaxf(fmaxf(zmax, fmaxf(z[4 * k], z[4 * k + 1])),
                           fmaxf(z[4 * k + 2], z[4 * k + 3]));
            }
            lse_fold<4 * kQuads>(mx, sum, z, fmaxf(mx, warp_max(zmax)));
          }
        } else {
          const int gb = (b - b0) * m;
          for (int ja = ch * chunk; ja < j1; ja += 32 * kPerLane) {
            float z[kPerLane];
            float zmax = kNeg;
#pragma unroll
            for (int k = 0; k < kPerLane; ++k) {
              const int j = ja + 32 * k + lane;
              const float gj = j >= j1 ? 0.0f : p.g_cached ? g_s[gb + j] : poll_g(g_rows + gb + j, t);
              z[k] = j < j1 ? (gj - cost_at(lr * m + j)) * kk + p.log_b : -INFINITY;
              zmax = fmaxf(zmax, z[k]);
            }
            lse_fold<kPerLane>(mx, sum, z, fmaxf(mx, warp_max(zmax)));
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) { part_m[u] = mx; part_s[u] = sum; }
      }
      __syncthreads();
      for (int lr = tid; lr < nr; lr += kThreads) {
        const int b = row_item[lr];
        float mx = kNeg, sum = 0.0f;
        for (int k = 0; k < split; ++k) mx = fmaxf(mx, part_m[lr * split + k]);
        for (int k = 0; k < split; ++k)
          sum += part_s[lr * split + k] * exp_fast(part_m[lr * split + k] - mx);
        f_s[lr] = -e_r[b - b0] * (mx + logf(fmaxf(sum, 1e-38f)));
      }
      __syncthreads();

      // ---- g-update: partials over the block's rows, a thread per column
      // (per pair of columns in the wide loop) ----
      for (int b = b0; b <= b1; ++b) {
        const int la = (int)(max(r0, (long long)b * n) - r0);
        const int lb = (int)(min(r1, (long long)(b + 1) * n) - r0);
        const float kk = k_r[b - b0];
        float2* out = p.col_part + row_slot[b - b0] * total_cols + (long long)b * m;
        if (fast) {
          const float2* c2 = reinterpret_cast<const float2*>(c_s);
          for (int jp = tid; jp < m / 2; jp += kThreads) {
            float mx0 = kNeg, mx1 = kNeg, sum0 = 0.0f, sum1 = 0.0f;
            for (int ra = la; ra < lb; ra += kRows) {
              float z0[kRows], z1[kRows];
              float zmax0 = kNeg, zmax1 = kNeg;
#pragma unroll
              for (int k = 0; k < kRows; ++k) {
                const int lr = ra + k;
                if (lr < lb) {
                  const float2 c = c2[lr * (m / 2) + jp];
                  const float fi = f_s[lr];
                  z0[k] = (fi - c.x) * kk + p.log_a;
                  z1[k] = (fi - c.y) * kk + p.log_a;
                } else {
                  z0[k] = z1[k] = -INFINITY;
                }
                zmax0 = fmaxf(zmax0, z0[k]);
                zmax1 = fmaxf(zmax1, z1[k]);
              }
              lse_fold<kRows>(mx0, sum0, z0, fmaxf(mx0, zmax0));
              lse_fold<kRows>(mx1, sum1, z1, fmaxf(mx1, zmax1));
            }
            store_now(out + 2 * jp, mx0, with_parity(sum0, t & 1));
            store_now(out + 2 * jp + 1, mx1, with_parity(sum1, t & 1));
          }
        } else {
          for (int j = tid; j < m; j += kThreads) {
            float mx = kNeg, sum = 0.0f;
            for (int ra = la; ra < lb; ra += kPerLane) {
              float z[kPerLane];
              float zmax = kNeg;
#pragma unroll
              for (int k = 0; k < kPerLane; ++k) {
                const int lr = ra + k;
                z[k] = lr < lb ? (f_s[lr] - cost_at(lr * m + j)) * kk + p.log_a : -INFINITY;
                zmax = fmaxf(zmax, z[k]);
              }
              lse_fold<kPerLane>(mx, sum, z, fmaxf(mx, zmax));
            }
            store_now(out + j, mx, with_parity(sum, t & 1));
          }
        }
      }

      // ---- g-update: merge this block's share of the columns, tile_w
      // columns at a time: all threads bring their partials (slot-major, so
      // neighbours read neighbouring words) into shared memory, then a warp
      // per column merges them in slot order ----
      for (long long ca = c0; ca < c1; ca += tile_w) {
        const int ncols = (int)min((long long)tile_w, c1 - ca);
        if (!one_tile) describe_tile(ca, ncols);
        for (int e = tid; e < p.slots << p.tile_shift; e += kThreads) {
          const int slot = e >> p.tile_shift, cj = e & (tile_w - 1);
          if (cj >= ncols || slot >= slots_of[cj]) continue;   // nobody writes it
          // rows one longer than tile_w: no bank conflict below
          tile[slot * (tile_w + 1) + cj] = poll_partial(p.col_part + slot * total_cols + ca + cj, t);
        }
        __syncthreads();
        for (int cj = warp; cj < ncols; cj += kWarps) {
          const int b = item_of[cj], slots = slots_of[cj];
          float2 ms[kSlotsPerLane];               // slots <= kMaxGrid
          float mx = kNeg, sum = 0.0f;
#pragma unroll
          for (int k = 0; k < kSlotsPerLane; ++k) {
            const int slot = 32 * k + lane;
            ms[k] = slot < slots ? tile[slot * (tile_w + 1) + cj] : make_float2(kNeg, 0.0f);
            mx = fmaxf(mx, ms[k].x);
          }
          mx = warp_max(mx);
#pragma unroll
          for (int k = 0; k < kSlotsPerLane; ++k) sum += ms[k].y * exp_fast(ms[k].x - mx);
          sum = warp_sum(sum);
          if (lane == 0) {
            const float gj = -e_c[b - bc0] * (mx + logf(fmaxf(sum, 1e-38f)));
            store_now(p.g_mark + ca + cj, gj, __int_as_float(t + 1));
            if (t + 1 == p.num_scales * p.num_iters) p.g[ca + cj] = gj;
          }
        }
        __syncthreads();     // the tile is free for the next columns, or iteration
      }
    }
  }
  grid.sync();

  // ---- value pass, and f out ----
  for (int lr = tid; lr < nr; lr += kThreads) p.f[r0 + lr] = f_s[lr];
  for (int b = b0; b <= b1; ++b) {
    const int la = (int)(max(r0, (long long)b * n) - r0);
    const int lb = (int)(min(r1, (long long)(b + 1) * n) - r0);
    const float e_inv = k_r[b - b0];                 // of the last temperature
    const float* gb = p.g + (long long)b * m;
    float acc = 0.0f;
    for (int idx = la * m + tid; idx < lb * m; idx += kThreads) {
      const int lr = idx / m, j = idx - lr * m;
      const float cij = cost_at(idx);
      acc += expf((f_s[lr] + __ldcg(gb + j) - cij) * e_inv + p.log_ab) * cij;
    }
    acc = block_reduce<false>(acc, red);
    if (tid == 0) p.item_part[(long long)b * p.slots + blockIdx.x - first_block(p, b)] = acc;
  }
  grid.sync();
  for (int b = own0 + warp; b <= b1; b += kWarps) {
    const float v = merge_item<false>(p, b, lane);
    if (lane == 0) p.val[b] = v;
  }
}

// The kernel's chain with no arithmetic: `count` exchanges in which every
// block waits for a word of every other block.
__global__ void __launch_bounds__(kThreads) exchange_kernel(int count, float2* marks) {
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) store_now(marks + blockIdx.x, 0.0f, __int_as_float(0));
  grid.sync();
  for (int k = 1; k <= count; ++k) {
    if (threadIdx.x == 0) store_now(marks + blockIdx.x, 0.0f, __int_as_float(k));
    // ">=": a block may be an exchange ahead of a slow reader of its word
    for (int i = threadIdx.x; i < gridDim.x; i += kThreads)
      while (__float_as_int(load_now(marks + i).y) < k) {}
    __syncthreads();
  }
}

// How a (batch, n, m) problem is laid out on the current device.
struct Layout {
  int grid, rows_per_block, slots, resident, g_cached, units, row_items, col_items;
  int tile_shift, tile_floats;
  size_t smem;
};

// Deal the rows to at most `blocks` blocks and size a block's shared memory.
void deal(int batch, int n, int m, long long blocks, int resident, int g_cached,
          Layout* lay) {
  const long long total_rows = (long long)batch * n;
  lay->rows_per_block = (int)((total_rows + blocks - 1) / blocks);
  lay->grid = (int)((total_rows + lay->rows_per_block - 1) / lay->rows_per_block);
  const long long cols_per_block = ((long long)batch * m + lay->grid - 1) / lay->grid;
  lay->resident = resident;
  lay->g_cached = g_cached;
  lay->units = lay->rows_per_block > kWarps ? lay->rows_per_block : kWarps;
  lay->row_items = lay->rows_per_block / n + 2;
  lay->col_items = (int)(cols_per_block / m) + 2;
  // blocks that hold rows of one item: at most ceil(n / rows) + 1
  lay->slots = (n + lay->rows_per_block - 1) / lay->rows_per_block + 1;
  if (lay->slots > lay->grid) lay->slots = lay->grid;
  // the merge's tile: all slots of 2^tile_shift columns (at most 32, or
  // all the block's) as float2, a row per slot and one longer than that,
  // kept a multiple of 16 bytes
  lay->tile_shift = 0;
  while (lay->tile_shift < 5 && (1 << lay->tile_shift) < cols_per_block) ++lay->tile_shift;
  lay->tile_floats = (2 * lay->slots * ((1 << lay->tile_shift) + 1) + 3) & ~3;
  size_t floats = (size_t)lay->tile_floats + kWarps + (size_t)lay->rows_per_block +
                  2 * (size_t)lay->units + 4 * lay->row_items + 2 * lay->col_items +
                  lay->rows_per_block;
  if (resident) floats += (size_t)lay->rows_per_block * m;
  if (g_cached) floats += (size_t)lay->row_items * m;
  lay->smem = floats * sizeof(float);
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices], g_smem_max[kMaxDevices];   // 0 until the device is set up
struct Cached {
  int batch, n, m;     // 0 until a layout was made
  Layout lay;
};
Cached g_last[kMaxDevices];

cudaError_t make_layout(int batch, int n, int m, Layout* out) {
  int dev = 0, occupancy = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {          // once per device: the shared-memory opt-in
    int sms = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    err = cudaFuncGetAttributes(&attr, warmup_kernel);
    if (err != cudaSuccess) return err;
    optin -= (int)attr.sharedSizeBytes;       // the kernel's static part
    err = cudaFuncSetAttribute(warmup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    g_smem_max[dev] = optin;
    g_sms[dev] = sms;
  }
  // a caller repeats one shape: the last layout of the device is kept
  Cached& last = g_last[dev];
  if (last.batch == batch && last.n == n && last.m == m) {
    *out = last.lay;
    return cudaSuccess;
  }
  const int sms = g_sms[dev], smem_max = g_smem_max[dev];
  const long long total_rows = (long long)batch * n;
  Layout lay;
  // one block per SM decides whether the rows fit in shared memory
  long long blocks = sms < kMaxGrid ? sms : kMaxGrid;
  if (blocks > total_rows) blocks = total_rows;
  // what fits in shared memory, in order of worth: the block's rows and
  // its items' part of g, the rows alone, g alone, neither
  for (int choice = 3; choice >= 0; --choice) {
    deal(batch, n, m, blocks, choice >> 1, choice & 1, &lay);
    if (lay.smem <= (size_t)smem_max) break;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, warmup_kernel, kThreads,
                                                      lay.smem);
  if (err != cudaSuccess) return err;
  if (occupancy < 1) return cudaErrorLaunchOutOfResources;
  // all the blocks the card holds at once (a warp merges a column's
  // partials in registers, hence kMaxGrid); fewer rows each never need
  // more shared memory, so the blocks stay co-resident
  blocks = (long long)sms * occupancy;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  if (blocks > total_rows) blocks = total_rows;
  deal(batch, n, m, blocks, lay.resident, lay.g_cached, &lay);
  last.batch = batch; last.n = n; last.m = m; last.lay = lay;
  *out = lay;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// layout[0..5] = grid, rows per block, slots, rows resident in shared memory
// (0/1), g cached there (0/1), dynamic shared memory bytes; the caller
// allocates scratch of 2 * batch * m * (slots + 1) + batch * slots floats.
int shwd_emd2_warmup_layout(int batch, int n, int m, int* layout) {
  Layout lay;
  cudaError_t err = make_layout(batch, n, m, &lay);
  if (err != cudaSuccess) return (int)err;
  layout[0] = lay.grid;
  layout[1] = lay.rows_per_block;
  layout[2] = lay.slots;
  layout[3] = lay.resident;
  layout[4] = lay.g_cached;
  layout[5] = (int)lay.smem;
  return 0;
}

// cost (B, n, m) f32 contiguous -> val (B,), f (B, n), g (B, m); log_e0 (B,)
// and scratch (see shwd_emd2_warmup_layout; 8-byte aligned) are work space.
// log_et = log(eps), log_a = -log n, log_b = -log m and log_ab = log_a +
// log_b are computed by the caller in double precision. One cooperative
// launch; returns its error code.
int shwd_emd2_warmup(const float* cost, float* val, float* f, float* g,
                     float* log_e0, float* scratch, int batch, int n, int m,
                     float log_et, float log_a, float log_b, float log_ab,
                     int num_iters, int num_scales, void* stream) {
  Layout lay;
  cudaError_t err = make_layout(batch, n, m, &lay);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.cost = cost; p.val = val; p.f = f; p.g = g; p.log_e0 = log_e0;
  p.col_part = reinterpret_cast<float2*>(scratch);
  p.g_mark = p.col_part + (size_t)batch * m * lay.slots;
  p.item_part = scratch + 2 * (size_t)batch * m * (lay.slots + 1);
  p.batch = batch; p.n = n; p.m = m;
  p.rows_per_block = lay.rows_per_block; p.slots = lay.slots;
  p.resident = lay.resident; p.g_cached = lay.g_cached; p.units = lay.units;
  p.row_items = lay.row_items; p.col_items = lay.col_items;
  p.tile_shift = lay.tile_shift; p.tile_floats = lay.tile_floats;
  p.log_et = log_et; p.log_a = log_a; p.log_b = log_b; p.log_ab = log_ab;
  p.num_iters = num_iters; p.num_scales = num_scales;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)warmup_kernel, dim3(lay.grid),
                                    dim3(kThreads), args, lay.smem,
                                    static_cast<cudaStream_t>(stream));
  return (int)err;
}


// The chain floor of the kernel above, for measurements only: `count`
// exchanges of one marked word between all blocks of the grid of a (batch,
// n, m) call (marks: 256 float2 of work space).
int shwd_emd2_warmup_exchanges(int batch, int n, int m, int count, float* marks,
                               void* stream) {
  Layout lay;
  cudaError_t err = make_layout(batch, n, m, &lay);
  if (err != cudaSuccess) return (int)err;
  float2* marks2 = reinterpret_cast<float2*>(marks);
  void* args[] = {&count, &marks2};
  err = cudaLaunchCooperativeKernel((const void*)exchange_kernel, dim3(lay.grid),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return (int)err;
}

}  // extern "C"
