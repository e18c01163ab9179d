// K6: the exact top-kc of each row of (Q, n) masked f32 scores, for the
// int2 tier's coarse pass (after K5, scan_int2.cu).
//
// Replaces the selection the JAX package runs after `pallas_int2_scores`:
// `jax.lax.approx_max_k` (perceive_tpu/ops/topk.py, an XLA custom call of
// the TPU) and the exact `_select_topk_hier`.  The port's select is exact:
// the floor it returns is the kc-th score, so the escalation bound of the
// coarse pass is exact too.
//
// Order: the key of entry i is (order-preserving bits of score + 0.0, ~i),
// so equal scores go to the lower row first; -inf entries (masked rows)
// order below every finite score and among themselves by row.  Output: the
// kc selected (score, row) pairs ORDERED BY ROW (the fine phase gathers the
// candidates' columns in address order), and the floor, the kc-th score.
//
// What bounds it on the H100: bytes.  At Q = 1 and n = 4,194,304 the scores
// are 16.8 MB, read 5 times (three radix levels, a count, a write) = 84 MB,
// mostly from the 50 MB L2 (25 us at 3.35 TB/s).  Design, many blocks a
// query (one block a query would leave 131 SMs idle):
//   init   state (prefix, mask, remaining kk = kc) and a zero histogram;
//   hist   x3: an 11-bit digit of the 32-bit order value of every entry
//          that matches the prefix so far, into a shared histogram (warp
//          aggregated with __match_any_sync: coarse scores crowd a few
//          bins), flushed into the query's global histogram;
//   find   x3: one block a query finds the bin holding the kk-th largest,
//          extends the prefix and lowers kk; after three levels the prefix
//          is the exact threshold T and kk the number of T-equal entries
//          to take, lowest rows first;
//   count  per block of rows: entries above T, entries equal to T;
//   scan   one block a query: exclusive prefixes over the blocks, in row
//          order, of the equal entries and of the selected ones;
//   write  per block: an ordered compaction (ballots and a block scan)
//          writes the selected entries at their place in row order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kSelThreads = 256;
constexpr int kSelRows = 4096;  // rows per block of the streaming passes
constexpr int kBins = 2048;     // 11-bit digits at shifts 21, 10 and 0
constexpr int kLevels = 3;
constexpr int kShift[kLevels] = {21, 10, 0};

struct SelState {
  uint32_t prefix;
  uint32_t mask;
  uint32_t kk;
  uint32_t pad;
};

__device__ __forceinline__ uint32_t entry_order(const float* row, int i) {
  return float_order(row[i] + 0.0f);
}

__global__ void sel_init(SelState* state, uint32_t* hist, int kc) {
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[static_cast<size_t>(q) * kBins + i] = 0;
  if (threadIdx.x == 0) state[q] = SelState{0u, 0u, static_cast<uint32_t>(kc), 0u};
}

// Grid (row blocks, queries).
__global__ void __launch_bounds__(kSelThreads) sel_hist(const float* __restrict__ scores, int n,
                                                         const SelState* __restrict__ state,
                                                         uint32_t* __restrict__ hist, int shift) {
  __shared__ uint32_t h[kBins];
  const int q = blockIdx.y;
  for (int i = threadIdx.x; i < kBins; i += kSelThreads) h[i] = 0;
  __syncthreads();
  const SelState st = state[q];
  const float* row = scores + static_cast<size_t>(q) * n;
  const int lane = threadIdx.x & 31;
  const int lo = blockIdx.x * kSelRows, hi = min(n, lo + kSelRows);
  for (int i0 = lo; i0 < hi; i0 += kSelThreads) {  // uniform trip count
    const int i = i0 + threadIdx.x;
    uint32_t bin = 0xffffffffu;  // no entry
    if (i < hi) {
      const uint32_t u = entry_order(row, i);
      if ((u & st.mask) == st.prefix) bin = (u >> shift) & (kBins - 1);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin != 0xffffffffu && lane == __ffs(peers) - 1) atomicAdd(&h[bin], __popc(peers));
  }
  __syncthreads();
  uint32_t* g = hist + static_cast<size_t>(q) * kBins;
  for (int i = threadIdx.x; i < kBins; i += kSelThreads)
    if (h[i]) atomicAdd(&g[i], h[i]);
}

// One block a query: the bin of the kk-th largest among the entries that
// match the prefix; zeroes the histogram for the next level.
__global__ void __launch_bounds__(kSelThreads) sel_find(SelState* state, uint32_t* hist, int shift) {
  constexpr int kPer = kBins / kSelThreads;  // bins a thread, highest first
  __shared__ uint32_t warp_tot[kSelThreads / 32];
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* g = hist + static_cast<size_t>(q) * kBins;
  const uint32_t kk = state[q].kk;
  uint32_t c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = g[kBins - 1 - (tid * kPer + j)];
    sum += c[j];
  }
  uint32_t incl = sum;  // inclusive scan over threads, highest bins first
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  uint32_t base = 0;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  incl += base;
  const uint32_t excl = incl - sum;
  if (excl < kk && kk <= incl) {  // exactly one thread
    uint32_t above = excl;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (above + c[j] >= kk) {
        const uint32_t digit = static_cast<uint32_t>(kBins - 1 - (tid * kPer + j));
        SelState st = state[q];
        st.prefix |= digit << shift;
        st.mask |= static_cast<uint32_t>(kBins - 1) << shift;
        st.kk = kk - above;
        state[q] = st;
        break;
      }
      above += c[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < kBins; i += kSelThreads) g[i] = 0;
}

// Grid (row blocks, queries): entries above and equal to the threshold.
__global__ void __launch_bounds__(kSelThreads) sel_count(const float* __restrict__ scores, int n,
                                                          const SelState* __restrict__ state,
                                                          int nblk, int* __restrict__ cnt) {
  __shared__ int tot[2];
  const int q = blockIdx.y;
  if (threadIdx.x < 2) tot[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t t = state[q].prefix;
  const float* row = scores + static_cast<size_t>(q) * n;
  const int lo = blockIdx.x * kSelRows, hi = min(n, lo + kSelRows);
  int gt = 0, eq = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kSelThreads) {
    const uint32_t u = entry_order(row, i);
    gt += u > t;
    eq += u == t;
  }
  gt = warp_sum_i(gt);
  eq = warp_sum_i(eq);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&tot[0], gt);
    atomicAdd(&tot[1], eq);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = cnt + (static_cast<size_t>(q) * nblk + blockIdx.x) * 4;
    c[0] = tot[0];
    c[1] = tot[1];
  }
}

// Block-wide exclusive scan of v (every thread calls it); returns the
// exclusive prefix and sets *total.
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int wsum[kSelThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int base = 0, all = 0;
  for (int w = 0; w < kSelThreads / 32; ++w) {
    base += w < warp ? wsum[w] : 0;
    all += wsum[w];
  }
  *total = all;
  return base + incl - v;
}

// One block a query: per row block, the equal entries before it (c[2]) and
// the selected entries before it (c[3]), in row order.
__global__ void __launch_bounds__(kSelThreads) sel_scan(const SelState* __restrict__ state, int nblk,
                                                         int* __restrict__ cnt) {
  const int q = blockIdx.x;
  const int need = static_cast<int>(state[q].kk);
  int eq_run = 0, sel_run = 0;
  for (int b0 = 0; b0 < nblk; b0 += kSelThreads) {  // uniform trip count
    const int b = b0 + threadIdx.x;
    int* c = cnt + (static_cast<size_t>(q) * nblk + (b < nblk ? b : 0)) * 4;
    const int gt = b < nblk ? c[0] : 0, eq = b < nblk ? c[1] : 0;
    int eq_tot, sel_tot;
    const int eq_before = eq_run + block_excl_scan(eq, &eq_tot);
    const int take = min(max(need - eq_before, 0), eq);
    const int sel_before = sel_run + block_excl_scan(gt + take, &sel_tot);
    if (b < nblk) {
      c[2] = eq_before;
      c[3] = sel_before;
    }
    eq_run += eq_tot;
    sel_run += sel_tot;
  }
}

// Grid (row blocks, queries): ordered compaction of the selected entries.
__global__ void __launch_bounds__(kSelThreads) sel_write(const float* __restrict__ scores, int n,
                                                          const SelState* __restrict__ state,
                                                          int nblk, const int* __restrict__ cnt,
                                                          int kc, float* __restrict__ vals,
                                                          int* __restrict__ rows,
                                                          float* __restrict__ floor_out) {
  const int q = blockIdx.y;
  const SelState st = state[q];
  const int need = static_cast<int>(st.kk);
  const int* c = cnt + (static_cast<size_t>(q) * nblk + blockIdx.x) * 4;
  int eq_run = c[2], sel_run = c[3];
  if (blockIdx.x == 0 && threadIdx.x == 0) floor_out[q] = order_float(st.prefix);
  const float* row = scores + static_cast<size_t>(q) * n;
  float* ov = vals + static_cast<size_t>(q) * kc;
  int* orow = rows + static_cast<size_t>(q) * kc;
  const int lo = blockIdx.x * kSelRows, hi = min(n, lo + kSelRows);
  for (int i0 = lo; i0 < hi; i0 += kSelThreads) {  // uniform trip count
    const int i = i0 + threadIdx.x;
    float s = 0.f;
    uint32_t u = 0;
    if (i < hi) {
      s = row[i];
      u = float_order(s + 0.0f);
    }
    const int eq = i < hi && u == st.prefix;
    int eq_tot;
    const int eq_rank = eq_run + block_excl_scan(eq, &eq_tot);
    const int sel = i < hi && (u > st.prefix || (eq && eq_rank < need));
    int sel_tot;
    const int pos = sel_run + block_excl_scan(sel, &sel_tot);
    if (sel) {
      ov[pos] = s;
      orow[pos] = i;
    }
    eq_run += eq_tot;
    sel_run += sel_tot;
  }
}

inline int sel_blocks(int n) { return (n + kSelRows - 1) / kSelRows; }

}  // namespace

extern "C" {

// Workspace bytes for perceive_select_topk over (nq, n) scores.
size_t perceive_select_topk_workspace(int nq, int n) {
  return static_cast<size_t>(nq) * (sizeof(SelState) + kBins * sizeof(uint32_t) +
                                    static_cast<size_t>(sel_blocks(n)) * 4 * sizeof(int));
}

// K6.  scores (nq, n) f32 contiguous; 1 <= kc <= n.  Writes vals/rows
// (nq, kc), ordered by row, and floor (nq,) = the kc-th score.
int perceive_select_topk(const float* scores, int nq, int n, int kc, float* vals, int* rows,
                         float* floor_out, void* workspace, void* stream) {
  if (nq < 1 || nq > 65535 || n < 1 || kc < 1 || kc > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = sel_blocks(n);
  SelState* state = static_cast<SelState*>(workspace);
  uint32_t* hist = reinterpret_cast<uint32_t*>(state + nq);
  int* cnt = reinterpret_cast<int*>(hist + static_cast<size_t>(nq) * kBins);
  const dim3 grid(nblk, nq);
  sel_init<<<nq, kSelThreads, 0, s>>>(state, hist, kc);
  for (int lv = 0; lv < kLevels; ++lv) {
    sel_hist<<<grid, kSelThreads, 0, s>>>(scores, n, state, hist, kShift[lv]);
    sel_find<<<nq, kSelThreads, 0, s>>>(state, hist, kShift[lv]);
  }
  sel_count<<<grid, kSelThreads, 0, s>>>(scores, n, state, nblk, cnt);
  sel_scan<<<nq, kSelThreads, 0, s>>>(state, nblk, cnt);
  sel_write<<<grid, kSelThreads, 0, s>>>(scores, n, state, nblk, cnt, kc, vals, rows, floor_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
