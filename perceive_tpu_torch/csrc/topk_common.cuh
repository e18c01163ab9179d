// Shared parts of the scan-top-k kernels (scan_topk.cu: K3; and, with
// hopper_common.cuh, scan_flat_bf16.cu: K1, scan_slab_rows.cu: K2 and K4,
// scan_slab_cols.cu: K8 and K9 slab, scan_flat_cols.cu: K7 and K9 flat)
// and of K5/K6 (scan_int2.cu, select_topk.cu):
// the 64-bit candidate keys and order values, the 4 x 4 byte transpose of
// the (D, N) layouts, the warp-wide select that ends pass 1, and pass 2
// with its block-wide radix select.
//
// A candidate is a 64-bit key: the order-preserving bits of the f32 score
// above the complement of the row index.  Keys are unique, so selection is
// exact, and equal scores order by the lower row first.  Key 0 marks "no
// row" (masked, or past the sweep); slots past the number of matching rows
// come out as (-inf, -1).
//
// Pass 1 (one kernel per tier and width) leaves, for every query and every
// block of kRows rows, the block's best min(k, kRows) keys in a workspace
// laid out cand[q][block][kc] (K3; the Hopper scans leave each row range's
// running list instead, cap keys a range, hopper_common.cuh).  Pass 2 (here) selects the top k of each
// query's candidates and bitonic-sorts them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 512;        // rows per pass-1 block
constexpr int kMaxDim = 1024;
constexpr int kMaxK = 8192;
constexpr int kMaxFilter = 16;
constexpr int kAllowAll = -2;     // allowed[0] sentinel: no source filter

struct SelectScratch {
  unsigned int hist[256];
  unsigned int count;
  int digit;
  unsigned int above;
  unsigned int bin;
};

__device__ __forceinline__ uint32_t float_order(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The key of a row whose score has order value ``order`` (float_order of
// the score plus +0.0, so that -0 and +0 tie on the row alone).
__device__ __forceinline__ u64 make_key(uint32_t order, int row) {
  return (static_cast<u64>(order) << 32) | static_cast<u64>(0xffffffffu - static_cast<uint32_t>(row));
}

// A 4 x 4 byte transpose: words w0..w3 hold byte i of row i of columns
// 0..3 (word j = column j, as the transposed (D, N) layouts load 4 rows of
// one dim); r[i] gets row i's bytes of columns 0..3, a dp4a operand.
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t* r) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ unsigned int warp_sum_u(unsigned int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether a row's source id passes validity and the filter (allow[] in
// shared memory, n_filter entries, allow[0] == kAllowAll: no filter).
__device__ __forceinline__ bool row_allowed(int s, const int* allow, int n_filter) {
  if (s < 0) return false;
  if (allow[0] == kAllowAll) return true;
  bool hit = false;
  for (int f = 0; f < n_filter; ++f) hit |= s == allow[f];
  return hit;
}

// Calls fn(key(i)) for this thread's share of i in [0, n), four reads in
// flight per thread (a selection streams its keys several times, and one
// block per query leaves few threads to hide the read latency).  Every
// thread runs the same number of rounds; past n it sees key 0.
template <class KeyFn, class Fn>
__device__ __forceinline__ void for_each_key(const KeyFn& key, int n, Fn fn) {
  constexpr int kUnroll = 4;
  for (int i0 = 0; i0 < n; i0 += kUnroll * blockDim.x) {
    u64 kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      kv[u] = i < n ? key(i) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fn(kv[u]);
  }
}

// Threshold T such that the non-zero keys >= T are exactly the best
// min(k, #non-zero) keys.  key(i) for i in [0, n).  Block-wide; every
// thread of the block must call it.
template <class KeyFn>
__device__ u64 select_threshold(const KeyFn& key, int n, int k, SelectScratch& ss) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) ss.count = 0;
  __syncthreads();
  unsigned int local = 0;
  for_each_key(key, n, [&](u64 kv) { local += kv != 0ull; });
  local = warp_sum_u(local);
  if (lane == 0 && local) atomicAdd(&ss.count, local);
  __syncthreads();
  const unsigned int nonzero = ss.count;
  if (nonzero <= static_cast<unsigned int>(k)) return 1ull;

  u64 prefix = 0, mask = 0;
  unsigned int kk = static_cast<unsigned int>(k);
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) ss.hist[i] = 0;
    __syncthreads();
    for_each_key(key, n, [&](u64 kv) {
      if (kv != 0ull && (kv & mask) == prefix) atomicAdd(&ss.hist[(kv >> shift) & 0xffu], 1u);
    });
    __syncthreads();
    if (tid < 32) {
      // lane l owns bins 255-8l .. 248-8l, highest first
      unsigned int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = ss.hist[255 - (lane * 8 + j)];
        sum += c[j];
      }
      unsigned int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned int excl = incl - sum;
      if (excl < kk && kk <= incl) {
        unsigned int above = excl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= kk) {
            ss.digit = 255 - (lane * 8 + j);
            ss.above = above;
            ss.bin = c[j];
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    const u64 digit = static_cast<u64>(ss.digit);
    kk -= ss.above;
    const unsigned int bin = ss.bin;
    prefix |= digit << shift;
    mask |= 0xffull << shift;
    if (bin == kk) break;  // every key under this prefix is selected
  }
  return prefix;
}

// Copy the non-zero keys >= thr to out (in no particular order); returns
// how many.  Block-wide; one atomic per warp and round.
template <class KeyFn>
__device__ int select_collect(const KeyFn& key, int n, u64 thr, u64* out, SelectScratch& ss) {
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (threadIdx.x == 0) ss.count = 0;
  __syncthreads();
  for_each_key(key, n, [&](u64 kv) {
    const bool take = kv != 0ull && kv >= thr;
    const unsigned int ballot = __ballot_sync(0xffffffffu, take);
    unsigned int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&ss.count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (take) out[base + __popc(ballot & ((1u << lane) - 1u))] = kv;
  });
  __syncthreads();
  return static_cast<int>(ss.count);
}

struct GlobalKeys {
  const u64* keys;
  __device__ u64 operator()(int i) const { return keys[i]; }
};

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp keeps the best min(kc, #rows) of one query's rn <= kRows scores
// sc[r] (-inf = no row) as keys out[0, kc), zero-filling the rest.  Lane l
// holds rows l, l + 32, ... as 32-bit order values (0 = no row); a binary
// search over the 32 bits finds the kc-th largest value T, and the rows
// above T plus the lowest-numbered rows equal to T are taken (the 64-bit
// key order: equal scores, lower row first).  No block barrier, no atomics.
__device__ void warp_select_block(const float* sc, int rn, int row0, int kc, u64* __restrict__ out) {
  constexpr int kPer = kRows / 32;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  uint32_t u[kPer];
  int n = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = j * 32 + lane;
    const float s = r < rn ? sc[r] : -INFINITY;
    u[j] = s == -INFINITY ? 0u : float_order(s + 0.0f);
    n += u[j] != 0u;
  }
  const int total = warp_sum_i(n);
  uint32_t t = 0;  // every row counts when there are at most kc
  int need = 0;    // rows equal to t to take, lowest first
  if (total > kc) {
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t c = t | (1u << bit);
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) cnt += u[j] >= c;
      if (warp_sum_i(cnt) >= kc) t = c;
    }
    int gt = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) gt += u[j] > t;
    need = kc - warp_sum_i(gt);  // >= 1: t is the kc-th largest value
  }
  int base = 0, eq_seen = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool eq = t != 0u && u[j] == t;
    const unsigned eqs = __ballot_sync(0xffffffffu, eq);
    const bool take = u[j] > t || (eq && eq_seen + __popc(eqs & lower) < need);
    const unsigned takes = __ballot_sync(0xffffffffu, take);
    if (take)
      out[base + __popc(takes & lower)] = make_key(u[j], row0 + j * 32 + lane);
    base += __popc(takes);
    eq_seen += __popc(eqs);
  }
  for (int j = base + lane; j < kc; j += 32) out[j] = 0ull;
}

// End of pass 1: for each of the qn queries of the tile, keep the best
// min(kc, rn) of the rn scores sc[i * pitch + r] (-inf = no row) as keys
// in cand[(q0 + i) * nblk + blk][0, kc), zero-filling the rest.  One warp
// per query; the scores must be visible to every warp (after a barrier).
__device__ void write_candidates(const float* sc, int pitch, int qn, int q0, int rn, int row0,
                                 int blk, int nblk, int kc, u64* __restrict__ cand) {
  for (int i = threadIdx.x >> 5; i < qn; i += blockDim.x >> 5)
    warp_select_block(sc + i * pitch, rn, row0, kc,
                      cand + (static_cast<size_t>(q0 + i) * nblk + blk) * kc);
}

// Pass 2: one block per query; sorted best-first output.
__global__ void __launch_bounds__(kThreads) scan_pass2(
    const u64* __restrict__ cand, int ncand, int k, int sort_n, float* __restrict__ vals,
    int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);  // [sort_n], sort_n = pow2 >= k
  __shared__ SelectScratch ss;
  const int tid = threadIdx.x;
  const GlobalKeys key{cand + static_cast<size_t>(blockIdx.x) * ncand};

  const u64 thr = select_threshold(key, ncand, k, ss);
  const int got = select_collect(key, ncand, thr, buf, ss);
  for (int i = got + tid; i < sort_n; i += kThreads) buf[i] = 0ull;
  __syncthreads();

  // bitonic sort, descending
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < sort_n / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = buf[lo], b = buf[hi];
        if ((a < b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  float* ov = vals + static_cast<size_t>(blockIdx.x) * k;
  int* orow = rows + static_cast<size_t>(blockIdx.x) * k;
  for (int i = tid; i < k; i += kThreads) {
    const u64 kv = buf[i];
    if (kv == 0ull) {
      ov[i] = -INFINITY;
      orow[i] = -1;
    } else {
      ov[i] = order_float(static_cast<uint32_t>(kv >> 32));
      orow[i] = static_cast<int>(0xffffffffu - static_cast<uint32_t>(kv & 0xffffffffull));
    }
  }
}

inline int n_blocks(int n_sweep) { return (n_sweep + kRows - 1) / kRows; }
inline int cand_per_block(int k) { return k < kRows ? k : kRows; }
inline int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

inline bool common_args_ok(int nq, int n_sweep, int k, int d, int n_filter) {
  return nq >= 1 && n_sweep >= 1 && k >= 1 && k <= kMaxK && d >= 1 && d <= kMaxDim &&
         n_filter >= 1 && n_filter <= kMaxFilter;
}

inline cudaError_t launch_pass2(const u64* cand, int nq, int ncand, int k, float* vals,
                                int* rows, cudaStream_t stream) {
  const int sort_n = pow2_at_least(k);
  const size_t smem = static_cast<size_t>(sort_n) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(scan_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  scan_pass2<<<nq, kThreads, smem, stream>>>(cand, ncand, k, sort_n, vals, rows);
  return cudaGetLastError();
}

}  // namespace
