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
//   assignment and prices.
//
// What bounds it on the H100: every sweep rescans the rows of the
// unassigned persons (N floats each) and every phase the rows of the
// assigned ones, from L2 (the 5.8 MB flow cost stays resident), so HBM
// sees the cost once; the floor is the compare/subtract work over the
// rows scanned, which the data decides (the kernel counts them). The
// sweeps are a serial chain of dependent steps, so latency, not
// bandwidth or arithmetic, is what the kernel actually pays.
//
// Design: one CTA per problem (grid = B), 1024 threads. prices, owner,
// assign, the per-object 64-bit bid keys and the list of unassigned persons
// live in shared memory (24 bytes per object: 28.8 KB at N = 1200). Per
// sweep: compact the unassigned persons; one warp per bidder scans its row
// twice (best/jbest, then second); lane 0 does atomicMax of the key
// (order-preserving bid bits << 32 | ~person); then one thread per object
// applies its winning bid. Known limit: at B = 1 a single SM works and 131
// idle.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// best value, its lowest column and the second best (the max over all
// other columns, floored at -1e30 as in the JAX masked max) of one row
__device__ __forceinline__ void scan_row(const float* __restrict__ row,
                                         const float* prices, int n, int lane,
                                         float& best, int& jbest,
                                         float& second) {
  best = -INFINITY;
  jbest = 0x7fffffff;
  for (int j = lane; j < n; j += 32) {
    const float v = -row[j] - prices[j];
    if (v > best) { best = v; jbest = j; }
  }
  for (int off = 16; off; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oj = __shfl_xor_sync(kFull, jbest, off);
    if (ob > best || (ob == best && oj < jbest)) { best = ob; jbest = oj; }
  }
  second = kNeg;
  for (int j = lane; j < n; j += 32) {
    if (j != jbest) second = fmaxf(second, -row[j] - prices[j]);
  }
  for (int off = 16; off; off >>= 1)
    second = fmaxf(second, __shfl_xor_sync(kFull, second, off));
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost,
               const float* __restrict__ prices0,
               const float* __restrict__ eps0,
               const int* __restrict__ assign0, int* __restrict__ assign_out,
               float* __restrict__ prices_out, int* __restrict__ sweeps_out,
               int* __restrict__ rows_out, int n, float eps_final,
               float scale_factor, int max_sweeps) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                          // n
  float* prices = reinterpret_cast<float*>(keys + n);       // n
  int* owner = reinterpret_cast<int*>(prices + n);          // n
  int* assign = owner + n;                                  // n
  int* list = assign + n;                                   // n
  __shared__ int count;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cost + (long long)b * n * n;

  // load the warm start; out-of-range seeds become -1, then every pair
  // whose object is claimed more than once is dropped
  if (tid == 0) rows_out[b] = 0;
  for (int i = tid; i < n; i += kThreads) {
    prices[i] = prices0[(long long)b * n + i];
    int a = assign0 ? assign0[(long long)b * n + i] : -1;
    assign[i] = (a >= 0 && a < n) ? a : -1;
    list[i] = 0;
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

    // eps-CS screen of the carried matching
    for (int i = warp; i < n; i += kWarps) {
      const int a = assign[i];
      if (a < 0) continue;
      const float* row = c + (long long)i * n;
      float best = -INFINITY;
      for (int j = lane; j < n; j += 32) best = fmaxf(best, -row[j] - prices[j]);
      for (int off = 16; off; off >>= 1)
        best = fmaxf(best, __shfl_xor_sync(kFull, best, off));
      if (lane == 0) {
        const float v_own = -row[a] - prices[a];
        if (!(v_own >= best - eps_ph)) assign[i] = -1;
        ++rows;
      }
    }
    for (int j = tid; j < n; j += kThreads) owner[j] = -1;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads)
      if (assign[i] >= 0) owner[assign[i]] = i;
    __syncthreads();

    int s = 0;
    while (true) {
      if (tid == 0) count = 0;
      for (int j = tid; j < n; j += kThreads) keys[j] = 0ull;
      __syncthreads();
      for (int i = tid; i < n; i += kThreads)
        if (assign[i] < 0) list[atomicAdd(&count, 1)] = i;
      __syncthreads();
      const int unassigned = count;
      if (unassigned == 0 || s >= max_sweeps) break;

      for (int k = warp; k < unassigned; k += kWarps) {
        const int i = list[k];
        float best, second;
        int jbest;
        scan_row(c + (long long)i * n, prices, n, lane, best, jbest, second);
        if (lane == 0 && jbest < n) {        // jbest >= n only on a NaN row
          const float gap = best - second;
          float bid = prices[jbest] + gap;
          bid = bid + eps_ph;
          const unsigned long long key =
              ((unsigned long long)order_bits(bid) << 32) | (uint32_t)(~i);
          atomicMax(&keys[jbest], key);
          ++rows;
        }
      }
      __syncthreads();
      // bidders are unassigned, previous owners are assigned: the writes
      // below never touch the same person twice
      for (int j = tid; j < n; j += kThreads) {
        const unsigned long long key = keys[j];
        if (key == 0ull) continue;
        const int winner = (int)(~(uint32_t)(key & 0xffffffffull));
        const int old = owner[j];
        if (old >= 0) assign[old] = -1;
        owner[j] = winner;
        assign[winner] = j;
        prices[j] = from_order_bits((uint32_t)(key >> 32));
      }
      __syncthreads();
      ++s;
    }
    total_sweeps += s;
    const bool done = !(eps > eps_final);   // eps <= eps_final; NaN ends
    eps = eps / scale_factor;
    if (done) break;
  }

  for (int i = tid; i < n; i += kThreads) {
    assign_out[(long long)b * n + i] = assign[i];
    prices_out[(long long)b * n + i] = prices[i];
  }
  // per-thread row counts (lane 0 of each warp) summed into the output
  if (lane == 0 && rows) atomicAdd(&rows_out[b], rows);
  if (tid == 0) sweeps_out[b] = total_sweeps;
}

}  // namespace

extern "C" {

size_t shwd_auction_smem_bytes(int n) {
  return (size_t)n * (sizeof(unsigned long long) + sizeof(float) + 3 * sizeof(int));
}

// cost (B, n, n) f32; prices0 (B, n) f32; eps0 one f32 on the device;
// assign0 (B, n) int32 or null -> assign (B, n) int32 (-1 where the sweep
// cap left a person unassigned), prices (B, n) f32, sweeps (B,) int32 and
// rows (B,) int32 (rows scanned: screened plus bidding rows).
int shwd_auction(const float* cost, const float* prices0, const float* eps0,
                 const int* assign0, int* assign, float* prices, int* sweeps,
                 int* rows, int batch, int n, float eps_final,
                 float scale_factor, int max_sweeps, void* stream) {
  const size_t smem = shwd_auction_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auction_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, prices0, eps0, assign0, assign, prices, sweeps, rows, n, eps_final,
      scale_factor, max_sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
