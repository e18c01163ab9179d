// Shared parts of the scan-top-k kernels (with hopper_common.cuh,
// scan_flat_rows.cu: K1 and K3, scan_slab_rows.cu: K2 and K4,
// scan_slab_cols.cu: K8 and K9 slab, scan_flat_cols.cu: K7 and K9 flat)
// and of K5, K6 and K10 (scan_int2.cu, select_topk.cu): the 64-bit
// candidate keys and order values, the 4 x 4 byte transpose of the (D, N)
// layouts, and the block-wide radix select of the scans' pass 2.
//
// A candidate is a 64-bit key: the order-preserving bits of the f32 score
// above the complement of the row index.  Keys are unique, so selection is
// exact, and equal scores order by the lower row first.  Key 0 marks "no
// row" (masked, or past the sweep); slots past the number of matching rows
// come out as (-inf, -1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

inline int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

inline bool common_args_ok(int nq, int n_sweep, int k, int d, int n_filter) {
  return nq >= 1 && n_sweep >= 1 && k >= 1 && k <= kMaxK && d >= 1 && d <= kMaxDim &&
         n_filter >= 1 && n_filter <= kMaxFilter;
}

}  // namespace
