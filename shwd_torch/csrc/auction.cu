// Batched eps-scaled Jacobi auction for square assignment problems.
//
// Replaces: shwd_tpu/ops/auction.py::_auction_phase and auction_assignment,
// an XLA while_loop on the TPU (not Pallas). Run eagerly, each of its
// ~300-1700 sweeps per solve would end in a host sync on any(assign < 0);
// here the whole eps ladder runs inside one launch.
//
// What it computes, per problem b of a (B, N, N) f32 cost (minimised):
//   eps ladder: eps = eps0; each phase runs at max(eps, eps_final), then
//   done = eps <= eps_final (tested before the division), eps /= scale.
//   Phase start: the eps-CS screen keeps a carried pair (i, a_i) only if
//   value(i, a_i) >= max_j value(i, j) - eps, value = -C - prices.
//   Sweep (until every person is assigned or max_sweeps): every unassigned
//   person i finds best = max_j value, jbest = the LOWEST such j, second =
//   max over j != jbest, and bids prices[jbest] + (best - second) + eps,
//   all in f32 in that order; each object takes its highest bid (the LOWEST
//   person on a tie), its previous owner becomes unassigned.
//   These are the JAX package's rules, so the same inputs give the same
//   assignment and prices, whatever the cluster size.
//
// What bounds it on the H100: every sweep rescans the rows of the
// unassigned persons (N floats each) and every phase the rows of the
// assigned ones, from L2 (the 5.8 MB flow cost stays resident), so HBM
// sees the cost once; the floor is the compare/subtract work over the
// rows scanned, which the data decides (the kernel counts them). The
// sweeps are a serial chain of dependent steps, so latency, not
// bandwidth or arithmetic, is what the kernel actually pays: a screen
// wants many SMs reading rows at once, a late sweep with a handful of
// bidders wants short barriers.
//
// Design: one thread-block cluster per problem, 1024 threads per CTA; the
// kernel takes any cluster size of 1, 2, 4, 8 or 16, and the caller picks
// 16 CTAs where that many per problem fit the card at once (B = 1), else
// one (B = 128).
//   - Every CTA keeps its own copy of prices and of the person -> object
//     map in shared memory, so a row scan reads only local memory and L2.
//   - The objects are split in contiguous slices over the CTAs: the home
//     CTA of an object holds its 64-bit bid key and its owner.
//   - Screen: the rows of the assigned persons are dealt over all warps of
//     the cluster; a pair that fails is cleared in every CTA's copy.
//   - Sweep: each CTA lists the unassigned persons of its share (person
//     mod cluster size, a power of two) and counts all of them; one warp
//     per bidder scans its row ONCE, carrying (best, jbest, second)
//     together (with 16 bidders or fewer, up to 32 warps share a row, 128
//     columns or more each, and their results are merged by the same
//     rule); lane 0 raises the object's key (order-preserving bid bits <<
//     32 | ~person) to its bid in the home CTA's shared memory; cluster
//     barrier; the home CTA applies each winning bid and writes the new
//     price and the two changed person -> object entries into every CTA's
//     copy; cluster barrier. The key's order is the tie rule, so the split
//     cannot change the result.
//   - Another CTA's shared memory is addressed explicitly (mapa,
//     st.shared::cluster), and the key is raised by a compare-and-swap
//     loop: a 64-bit atomicMax through a generic pointer, or
//     red.shared::cluster.max.u64, lost bids there. A cluster of one uses
//     the plain shared-memory forms and __syncthreads.
//   24 bytes of shared memory per object and CTA (28.8 KB at N = 1200).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPhases = 64;       // guards a NaN or infinite eps0
constexpr float kNeg = -1e30f;

__device__ __forceinline__ uint32_t order_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// the best value of a set of columns, its lowest column, and the best
// value among the other columns
struct Scan {
  float best;
  int jbest;
  float second;
};

__device__ __forceinline__ void scan_visit(Scan& r, float v, int j) {
  // columns arrive in rising order, so a strict test keeps the lowest
  if (v > r.best) {
    r.second = r.best;
    r.best = v;
    r.jbest = j;
  } else {
    r.second = fmaxf(r.second, v);
  }
}

// higher best wins, the lower column on a tie; the loser's best competes
// for second. max is exact, so any merge order gives the two-pass result.
__device__ __forceinline__ void scan_merge(Scan& r, const Scan& o) {
  const bool take = o.best > r.best || (o.best == r.best && o.jbest < r.jbest);
  const float loser = take ? r.best : o.best;
  if (take) r = o;
  r.second = fmaxf(r.second, loser);
}

__device__ __forceinline__ Scan warp_merge(Scan r) {
  for (int off = 16; off; off >>= 1) {
    Scan o;
    o.best = __shfl_xor_sync(kFull, r.best, off);
    o.jbest = __shfl_xor_sync(kFull, r.jbest, off);
    o.second = __shfl_xor_sync(kFull, r.second, off);
    scan_merge(r, o);
  }
  return r;
}

// One pass by one warp over the columns [lo, hi) of a row: best value, its
// lowest column and the best of the others. `vec`: n, lo and hi are
// multiples of 4 and the cost is 16-byte aligned, so the row and the
// prices can be read 16 bytes at a time.
__device__ __forceinline__ Scan scan_row(const float* __restrict__ row,
                                         const float* prices, int lo, int hi,
                                         int lane, bool vec) {
  Scan r{-INFINITY, 0x7fffffff, -INFINITY};
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* prices4 = reinterpret_cast<const float4*>(prices);
#pragma unroll 5
    for (int q = lo / 4 + lane; q < hi / 4; q += 32) {
      const float4 c = row4[q], p = prices4[q];
      scan_visit(r, -c.x - p.x, 4 * q);
      scan_visit(r, -c.y - p.y, 4 * q + 1);
      scan_visit(r, -c.z - p.z, 4 * q + 2);
      scan_visit(r, -c.w - p.w, 4 * q + 3);
    }
  } else {
#pragma unroll 4
    for (int j = lo + lane; j < hi; j += 32) scan_visit(r, -row[j] - prices[j], j);
  }
  return warp_merge(r);
}

// All threads of the cluster meet; shared-memory writes made before it, in
// any CTA of the cluster, are seen after it. A cluster of one is a block.
__device__ __forceinline__ void cluster_sync(int csize) {
  if (csize == 1) {
    __syncthreads();
    return;
  }
  __syncwarp();     // the warp may come out of divergent code
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Distributed shared memory, addressed explicitly: `local` is a pointer
// into this CTA's shared memory, the result the same place in CTA `rank`.
// A cluster of one takes the plain shared-memory forms instead, which are
// shorter.
__device__ __forceinline__ uint32_t remote(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  return out;
}
__device__ __forceinline__ void remote_store(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
// 64-bit maximum by compare-and-swap (the primitive shared memory has); it
// returns only when the value is in place
__device__ __forceinline__ void remote_max(uint32_t addr, unsigned long long v) {
  unsigned long long seen;
  asm volatile("ld.volatile.shared::cluster.u64 %0, [%1];" : "=l"(seen) : "r"(addr) : "memory");
  while (seen < v) {
    unsigned long long prev;
    asm volatile("atom.shared::cluster.cas.b64 %0, [%1], %2, %3;"
                 : "=l"(prev) : "r"(addr), "l"(seen), "l"(v) : "memory");
    if (prev == seen) break;
    seen = prev;
  }
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost,
               const float* __restrict__ prices0,
               const float* __restrict__ eps0,
               const int* __restrict__ assign0, int* __restrict__ assign_out,
               float* __restrict__ prices_out, int* __restrict__ sweeps_out,
               int* __restrict__ rows_out, int n, float eps_final,
               float scale_factor, int max_sweeps) {
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* keys = smem;                          // n, home slice used
  float* prices = reinterpret_cast<float*>(keys + n);       // n
  int* owner = reinterpret_cast<int*>(prices + n);          // n, home slice used
  int* assign = owner + n;                                  // n
  int* list = assign + n;                                   // n
  __shared__ int listed;
  __shared__ Scan parts[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cost + (long long)b * n * n;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(cost) & 15) == 0;
  // a row splits into at most 2^max_shift spans of 128 columns or more,
  // one per warp when few persons bid
  int max_shift = 0;
  while (max_shift < 5 && (128 << max_shift) < n) ++max_shift;
  // this CTA's slice of the objects
  const int per_cta = (n + csize - 1) / csize;
  const int j0 = min(n, rank * per_cta), j1 = min(n, j0 + per_cta);

  // load the warm start; out-of-range seeds become -1, then every pair
  // whose object is claimed more than once is dropped (in every CTA alike)
  if (rank == 0 && tid == 0) rows_out[b] = 0;
  if (tid == 0) listed = 0;
  for (int i = tid; i < n; i += kThreads) {
    prices[i] = prices0[(long long)b * n + i];
    int a = assign0 ? assign0[(long long)b * n + i] : -1;
    assign[i] = (a >= 0 && a < n) ? a : -1;
    list[i] = 0;
    keys[i] = 0ull;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads)
    if (assign[i] >= 0) atomicAdd(&list[assign[i]], 1);
  __syncthreads();
  for (int i = tid; i < n; i += kThreads)
    if (assign[i] >= 0 && list[assign[i]] > 1) assign[i] = -1;
  __syncthreads();

  float eps = *eps0;
  int total_sweeps = 0, rows = 0;
  for (int phase = 0; phase < kMaxPhases; ++phase) {
    const float eps_ph = fmaxf(eps, eps_final);

    // every CTA has finished reading its copy of assign (the load above,
    // or the count that ended the last phase) before another clears pairs
    cluster_sync(csize);
    // eps-CS screen of the carried matching, rows dealt over the cluster
    for (int i = rank * kWarps + warp; i < n; i += csize * kWarps) {
      const int a = assign[i];
      if (a < 0) continue;
      const float* row = c + (long long)i * n;
      const Scan r = scan_row(row, prices, 0, n, lane, vec);
      const float v_own = -row[a] - prices[a];
      if (!(v_own >= r.best - eps_ph)) {
        if (csize == 1) assign[i] = -1;
        else for (int k = lane; k < csize; k += 32) remote_store(remote(assign + i, k), -1);
      }
      if (lane == 0) ++rows;
    }
    cluster_sync(csize);
    for (int j = j0 + tid; j < j1; j += kThreads) owner[j] = -1;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int a = assign[i];
      if (a >= j0 && a < j1) owner[a] = i;
    }
    __syncthreads();

    int s = 0;
    while (true) {
      // list this CTA's share of the unassigned persons, count all of them
      int unassigned = 0;
      for (int base = 0; base < n; base += kThreads) {
        const int i = base + tid;
        const bool un = i < n && assign[i] < 0;
        if (un && (i & (csize - 1)) == rank) list[atomicAdd(&listed, 1)] = i;
        unassigned += __syncthreads_count(un);
      }
      const int mine = listed;
      if (unassigned == 0 || s >= max_sweeps) break;

      // the second best is floored at -1e30 as the JAX masked max is; the
      // bid's arithmetic keeps the JAX order; jbest >= n only on a NaN row
      auto bid = [&](Scan r, int i) {
        if (lane != 0 || r.jbest >= n) return;
        const float gap = r.best - fmaxf(r.second, kNeg);
        float amount = prices[r.jbest] + gap;
        amount = amount + eps_ph;
        const unsigned long long key =
            ((unsigned long long)order_bits(amount) << 32) | (uint32_t)(~i);
        if (csize == 1) atomicMax(keys + r.jbest, key);
        else remote_max(remote(keys + r.jbest, r.jbest / per_cta), key);
        ++rows;
      };
      // with few bidders 2^shift warps share a row (128 columns or more
      // each: a 16-byte read per lane), so that a late sweep waits for one
      // short read instead of a long one
      const int shift = mine > 0 ? min(max_shift, __clz(mine - 1) - 27) : 0;
      if (shift < 1) {
        for (int k = warp; k < mine; k += kWarps)
          bid(scan_row(c + (long long)list[k] * n, prices, 0, n, lane, vec), list[k]);
      } else {
        // columns per warp: the row's 128s dealt to 2^shift warps
        const int span = ((((n + 127) >> 7) + (1 << shift) - 1) >> shift) << 7;
        if (warp < mine << shift) {
          const int lo = min(n, (warp & ((1 << shift) - 1)) * span);
          const Scan r = scan_row(c + (long long)list[warp >> shift] * n, prices, lo,
                                  min(n, lo + span), lane, vec);
          if (lane == 0) parts[warp] = r;
        }
        __syncthreads();
        if (warp < mine) {
          Scan r{-INFINITY, 0x7fffffff, -INFINITY};
          if (lane < 1 << shift) r = parts[(warp << shift) + lane];
          bid(warp_merge(r), list[warp]);
        }
      }
      cluster_sync(csize);
      // bidders are unassigned, previous owners are assigned: the writes
      // below never touch the same person twice
      if (tid == 0) listed = 0;
      for (int j = j0 + tid; j < j1; j += kThreads) {
        const unsigned long long key = keys[j];
        if (key == 0ull) continue;
        keys[j] = 0ull;
        const int winner = (int)(~(uint32_t)(key & 0xffffffffull));
        const float price = from_order_bits((uint32_t)(key >> 32));
        const int old = owner[j];
        owner[j] = winner;
        if (csize == 1) {
          if (old >= 0) assign[old] = -1;
          assign[winner] = j;
          prices[j] = price;
        }
        for (int k = 0; k < csize && csize > 1; ++k) {
          if (old >= 0) remote_store(remote(assign + old, k), -1);
          remote_store(remote(assign + winner, k), j);
          remote_store(remote(prices + j, k), __float_as_int(price));
        }
      }
      cluster_sync(csize);
      ++s;
    }
    // the list count of the sweep that was not run
    __syncthreads();
    if (tid == 0) listed = 0;
    total_sweeps += s;
    const bool done = !(eps > eps_final);   // eps <= eps_final; NaN ends
    eps = eps / scale_factor;
    if (done) break;
  }

  if (rank == 0) {
    for (int i = tid; i < n; i += kThreads) {
      assign_out[(long long)b * n + i] = assign[i];
      prices_out[(long long)b * n + i] = prices[i];
    }
    if (tid == 0) sweeps_out[b] = total_sweeps;
  }
  // per-thread row counts (lane 0 of each warp) summed into the output
  if (lane == 0 && rows) atomicAdd(&rows_out[b], rows);
}

size_t smem_bytes(int n) {
  return (size_t)n * (sizeof(unsigned long long) + sizeof(float) + 3 * sizeof(int));
}

constexpr int kMaxDevices = 64;
int g_smem_max[kMaxDevices];    // 0 until the device is set up

// Once per device: opt in to all the dynamic shared memory a block may have
// and to clusters beyond the portable size of 8.
cudaError_t prepare_device(int* smem_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_smem_max[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    err = cudaFuncGetAttributes(&fa, auction_kernel);
    if (err != cudaSuccess) return err;
    optin -= (int)fa.sharedSizeBytes;         // the kernel's static part
    err = cudaFuncSetAttribute(auction_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(auction_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_smem_max[dev] = optin;
  }
  *smem_max = g_smem_max[dev];
  return cudaSuccess;
}

cudaError_t configure(int n, int cluster, cudaStream_t stream, int batch,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = smem_bytes(n);
  int smem_max = 0;
  cudaError_t err = prepare_device(&smem_max);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(batch * cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// How many clusters of `cluster` CTAs the current device holds at once for
// problems of n objects; 0 when it cannot place one.
int shwd_auction_max_clusters(int n, int cluster, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(n, cluster, nullptr, 1, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(count, auction_kernel, &cfg);
}

// cost (B, n, n) f32; prices0 (B, n) f32; eps0 one f32 on the device;
// assign0 (B, n) int32 or null -> assign (B, n) int32 (-1 where the sweep
// cap left a person unassigned), prices (B, n) f32, sweeps (B,) int32 and
// rows (B,) int32 (rows scanned: screened plus bidding rows). `cluster`
// CTAs work on each problem (1, 2, 4, 8 or 16).
int shwd_auction(const float* cost, const float* prices0, const float* eps0,
                 const int* assign0, int* assign, float* prices, int* sweeps,
                 int* rows, int batch, int n, float eps_final,
                 float scale_factor, int max_sweeps, int cluster, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(n, cluster, static_cast<cudaStream_t>(stream),
                              batch, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLaunchKernelEx(&cfg, auction_kernel, cost, prices0, eps0,
                                 assign0, assign, prices, sweeps, rows, n,
                                 eps_final, scale_factor, max_sweeps);
}

}  // extern "C"
