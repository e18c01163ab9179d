// Shared parts of the Hopper scan kernels (scan_flat_rows.cu: K1 and K3;
// scan_slab_rows.cu: K2 and K4; scan_slab_cols.cu: K8 and K9's slab
// kernel; scan_flat_cols.cu: K7 and K9's flat kernel): mbarriers, TMA
// loads and tensor maps (encoded on the host through
// cudaGetDriverEntryPoint, so nothing links libcuda), wgmma descriptors and
// the s8 product, the int8 epilogue's scaling, the running per-(query, row
// range) candidate lists that replace a select per row block, and the two
// pass 2s over those lists: one block a query (list_pass2), and a
// multi-block radix select (launch_keys_select) where the lists outgrow
// shared memory; launch_lists_pass2 takes the one the launch plan names.
//
// A list lives in the workspace, cand[q][range][cap] (it stays in L2).  A
// query's running threshold tau is the k-th best key of its list when the
// list was last compacted (0 before that): a key that does not beat tau is
// out of the range's top k.  A list holds 64 keys for k <= 32 (compacted by
// a 64-key sort in registers) and cap >= 2k past that (compacted by a
// bitwise search for the k-th key); at the end each block leaves its lists
// as they stand, zero-filled to cap, and list_pass2 selects over ranges x
// cap keys a query (or, past what it stages, launch_keys_select does).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the entry point comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kSortK = 32;     // k up to this: lists of kSortCap keys, sorted in registers
constexpr int kSortCap = 64;
constexpr size_t kSmemMax = 232448;  // per-block opt-in maximum on sm_90

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// Initialises the mbarriers (thread 0) and makes them visible to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma operands written by ordinary stores).
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Barrier `id` (1..15) over the first `count` threads of the block (a
// multiple of 32): the consumer warps, without the producer.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// box (c0 = innermost coordinate, c1 = outer) of a 2-d tensor map -> shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 1-d box (c0 = first element) of a tensor map -> shared memory
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// Byte offset of byte `b` of row `r` in a tile of 128-byte rows with the
// 128-byte swizzle (as TMA writes it and wgmma reads it): the 16-byte chunk
// index is XORed with the row's place in its 8-row group.  The tile must be
// 1024-byte aligned.
__device__ __forceinline__ int swz128(int r, int b) { return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15); }

// wgmma operand descriptor: a K-major tile of 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart.  Advancing along k by 32 bytes
// (16 bf16, 32 int8) adds 2.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  uint64_t desc = (smem_u32(p) & 0x3FFFFu) >> 4;
  desc |= 1ull << 16;                              // leading byte offset (unused when swizzled)
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  desc |= 1ull << 62;                              // 128-byte swizzle
  return desc;
}

// d[64] += A(64 x 32, shared, descriptor da) . B(128 x 32, shared, db)^T,
// int8 x int8 -> int32 (exact); scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// The bits of this thread's rows 8j + 2t + e of a 128-row tile (bit 2j +
// e): the row lies before `rows` and its source id (ids[r]) is live and,
// with a filter (n_filter > 0), allowed.  Four ballots, one per t: lane 2j
// + e tests row 8j + 2t' + e for each t'.
__device__ __forceinline__ uint32_t tile_valid(const int* ids, int rows, const int* allow, int n_filter, int t) {
  const int lane = threadIdx.x & 31;
  uint32_t v = 0;
#pragma unroll
  for (int tt = 0; tt < 4; ++tt) {
    const int r = 8 * (lane >> 1) + 2 * tt + (lane & 1);
    const int id = ids[r];
    bool ok = r < rows && id >= 0;
    if (n_filter > 0) {
      bool hit = false;
      for (int f = 0; f < n_filter; ++f) hit |= id == allow[f];
      ok = ok && hit;
    }
    const uint32_t b = __ballot_sync(0xffffffffu, ok);
    if (tt == t) v = b;
  }
  return v;
}

// The scores of an s8 wgmma tile: acc[4j + 2h + e] is the int32 dot of
// query (h ? b : a) and tile row 8j + 2t + e, srow the tile's row scales;
// f32(dot) * row scale * query scale, rounded in that order (__fmul_rn),
// bit for bit with the plain versions.
__device__ __forceinline__ void scale_tile(const int (&acc)[64], const float* srow, float sa, float sb, int t,
                                           float (&sc)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = srow[8 * j + 2 * t + e];
      sc[4 * j + e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]), s), sa);
      sc[4 * j + 2 + e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 + e]), s), sb);
    }
}

// One warp keeps the best k of the n keys list[0, n) (unique, non-zero,
// n > k): a bitwise search finds the k-th largest key T (stopping early
// once exactly k keys lie at or above the bits fixed so far), then the
// keys >= T move to list[0, k) in their order.  Returns T: every key below
// it is out of the list's top k.  The list lives in the workspace (L2), and
// the search reads it once a bit, so each lane keeps kBatch loads in
// flight: one L2 round trip a pass up to n = 512 (k = 256).
__device__ u64 warp_keep_top(u64* list, int n, int k) {
  constexpr int kBatch = 16;
  const int lane = threadIdx.x & 31;
  auto load = [&](int i0, u64 (&v)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < n ? list[i] : 0ull;
    }
  };
  u64 t = 0;
  for (int bit = 63; bit >= 0; --bit) {
    const u64 c = t | (1ull << bit);
    int cnt = 0;
    for (int i0 = 0; i0 < n; i0 += 32 * kBatch) {
      u64 v[kBatch];
      load(i0, v);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cnt += v[u] >= c;
    }
    cnt = warp_sum_i(cnt);
    if (cnt >= k) {
      t = c;
      if (cnt == k) break;
    }
  }
  // keys move down only: a batch is read whole before any of it is written
  const unsigned lower = (1u << lane) - 1u;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += 32 * kBatch) {
    u64 v[kBatch];
    load(i0, v);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool take = v[u] >= t;  // 0 past n
      const unsigned takes = __ballot_sync(0xffffffffu, take);
      if (take) list[base + __popc(takes & lower)] = v[u];
      base += __popc(takes);
    }
    __syncwarp();
  }
  return t;
}

__device__ __forceinline__ u64 shfl_xor_u64(u64 v, int m) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, static_cast<uint32_t>(v), m);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, static_cast<uint32_t>(v >> 32), m);
  return (static_cast<u64>(hi) << 32) | lo;
}

// One bitonic step between lanes `stride` apart: the lower lane keeps the
// larger key where keep_max_low, else the smaller.
__device__ __forceinline__ u64 bitonic_step(u64 x, int stride, bool keep_max_low) {
  const u64 y = shfl_xor_u64(x, stride);
  const bool low = (threadIdx.x & stride) == 0;
  return (low == keep_max_low) ? (x > y ? x : y) : (x < y ? x : y);
}

// Bitonic sort of the warp's 64 keys, best first: element e is register
// e / 32 of lane e % 32.
__device__ __forceinline__ void warp_sort64(u64& x0, u64& x1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: element lane against lane + 32, best first
        const u64 a = x0 > x1 ? x0 : x1, b = x0 > x1 ? x1 : x0;
        x0 = a;
        x1 = b;
        continue;
      }
      x0 = bitonic_step(x0, stride, ((lane & size) == 0));
      x1 = bitonic_step(x1, stride, (((32 + lane) & size) == 0));
    }
  }
}

// One warp keeps the best k of a full list of kSortCap keys (k <= kSortK)
// at list[0, k), best first, and returns the k-th key.
__device__ u64 warp_keep_top64(u64* list, int k) {
  const int lane = threadIdx.x & 31;
  u64 x0 = list[lane], x1 = list[32 + lane];
  warp_sort64(x0, x1);
  const u64 thr = __shfl_sync(0xffffffffu, x0, k - 1);
  __syncwarp();
  if (lane < k) list[lane] = x0;
  return thr;
}

// One warp compacts a full list of cap keys to its best k; returns the new tau.
__device__ __forceinline__ u64 warp_compact(u64* list, int cap, int k) {
  return cap == kSortCap ? warp_keep_top64(list, k) : warp_keep_top(list, cap, k);
}

// The epilogue of a wgmma tile of 16 queries (a warp) x 128 rows: acc[4j +
// 2h + e] is the score of query (h ? qb : qa) and tile row 8j + 2t + e,
// valid that row's bit (2j + e).  A score screens against the float of
// tau's score bits (queries past qn screen at +inf), then its key must beat
// tau; a key that does is appended to its list (a shared-memory atomic on
// cnt gives the slot), each lane taking its candidates by predicated
// selects so that no lane diverges into another's; when a list fills, the
// warp keeps its top k and raises tau.  list_of(query) is the query's list.
template <class ListOf>
__device__ __forceinline__ void append_tile(const float (&acc)[64], uint32_t valid, int row0, int qa, int qb,
                                            int qn, int wq0, u64* tau, int* cnt, const ListOf& list_of, int k,
                                            int cap) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  u64* list_a = list_of(qa);
  u64* list_b = list_of(qb);
  u64 ta = tau[qa], tb = tau[qb];
  const float fa = qa >= qn ? INFINITY : ta ? order_float(static_cast<uint32_t>(ta >> 32)) : -INFINITY;
  const float fb = qb >= qn ? INFINITY : tb ? order_float(static_cast<uint32_t>(tb >> 32)) : -INFINITY;
  uint32_t ma = 0, mb = 0;  // rows (bit 2j + e) whose score passes the screen, per query
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ma |= static_cast<uint32_t>(acc[4 * j + e] >= fa) << (2 * j + e);
      mb |= static_cast<uint32_t>(acc[4 * j + 2 + e] >= fb) << (2 * j + e);
    }
  ma &= valid;
  mb &= valid;
  // each lane appends its candidates, lowest j first; a group's four
  // scores come out of acc by predicated selects.  Keys that find their
  // list full are left in (ma, mb) for after the compaction.
  while (true) {
    uint32_t ra = 0, rb = 0;
    uint32_t groups = (ma | mb | ((ma | mb) >> 1)) & 0x55555555u;
    while (__any_sync(0xffffffffu, groups != 0)) {
      if (groups == 0) continue;
      const int j = (__ffs(groups) - 1) >> 1;
      groups &= groups - 1;
      float x[4];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        if (jj == j) {
          x[0] = acc[4 * jj];
          x[1] = acc[4 * jj + 1];
          x[2] = acc[4 * jj + 2];
          x[3] = acc[4 * jj + 3];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t bit = 1u << (2 * j + e);
          if (((h ? mb : ma) & bit) == 0) continue;
          const u64 key = make_key(float_order(x[2 * h + e] + 0.0f), row0 + 8 * j + 2 * t + e);
          if (key <= (h ? tb : ta)) continue;
          const int slot = atomicAdd(cnt + (h ? qb : qa), 1);
          if (slot < cap)
            (h ? list_b : list_a)[slot] = key;
          else
            (h ? rb : ra) |= bit;
        }
    }
    // the warp's full lists (those that turned a key away) keep their top k
    uint32_t full_q = (ra ? 1u << g : 0u) | (rb ? 1u << (g + 8) : 0u);
    full_q = __reduce_or_sync(0xffffffffu, full_q);
    if (full_q == 0) break;
    __syncwarp();
    while (full_q) {
      const int qq = wq0 + __ffs(full_q) - 1;
      full_q &= full_q - 1;
      const u64 thr = warp_compact(list_of(qq), cap, k);
      if (lane == 0) {
        tau[qq] = thr;
        cnt[qq] = k;
      }
      __syncwarp();
    }
    ta = tau[qa];
    tb = tau[qb];
    ma = ra;
    mb = rb;
  }
}

// Each of the warp's 16 queries' lists as it stands, zero-filled to cap keys.
template <class ListOf>
__device__ __forceinline__ void finish_lists(int wq0, int qn, const int* cnt, const ListOf& list_of, int cap) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int i = 0; i < 16; ++i) {
    const int qq = wq0 + i;
    if (qq >= qn) break;
    u64* list = list_of(qq);
    for (int j = min(cnt[qq], cap) + lane; j < cap; j += 32) list[j] = 0ull;
  }
}

// Pass 2 of the list-keeping kernels: one block a query selects the top k
// of its ranges x cap keys (topk_common.cuh's radix select) and sorts them
// best first.  Where they fit beside the sort buffer, the keys are first
// copied into shared memory with 16-byte loads, so the select's passes
// (one a byte of the key, until the k-th key is found) read shared memory
// rather than L2; else they read the workspace.
__global__ void __launch_bounds__(kThreads) list_pass2(const u64* __restrict__ cand, int ncand, int k, int sort_n,
                                                       bool staged, float* __restrict__ vals,
                                                       int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);  // [sort_n], sort_n = pow2 >= k
  __shared__ SelectScratch ss;
  const int tid = threadIdx.x;
  const u64* src = cand + static_cast<size_t>(blockIdx.x) * ncand;
  const u64* keys = src;
  if (staged) {  // ncand is even (cap is a multiple of 32): whole 16-byte pairs, 8 in flight a thread
    constexpr int kInFlight = 8;
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(buf + ((sort_n + 1) & ~1));
    const ulonglong2* from = reinterpret_cast<const ulonglong2*>(src);
    const int pairs = ncand / 2;
    for (int i0 = 0; i0 < pairs; i0 += kInFlight * kThreads) {
      ulonglong2 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads + tid;
        if (i < pairs) v[u] = from[i];
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads + tid;
        if (i < pairs) dst[i] = v[u];
      }
    }
    __syncthreads();
    keys = reinterpret_cast<const u64*>(dst);
  }
  const GlobalKeys key{keys};  // a generic pointer: shared memory or the workspace

  const u64 thr = select_threshold(key, ncand, k, ss);
  const int got = select_collect(key, ncand, thr, buf, ss);
  for (int i = got + tid; i < sort_n; i += kThreads) buf[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= sort_n; size <<= 1) {  // bitonic sort, descending
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
    ov[i] = kv ? order_float(static_cast<uint32_t>(kv >> 32)) : -INFINITY;
    orow[i] = kv ? static_cast<int>(0xffffffffu - static_cast<uint32_t>(kv & 0xffffffffull)) : -1;
  }
}

// -- host side ------------------------------------------------------------------

// Lets `kernel` take all the shared memory a block may have (kSmemMax, its
// static share included) on the current device: set once a device and
// process, not at every launch (a text query's scan launches in well under
// a millisecond, and its host time counts).  The smem of each launch still
// sets its occupancy.
template <auto kernel>
cudaError_t allow_smem() {
  static int done[64] = {0};  // by device; a race sets the attribute twice, harmlessly
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemMax - attr.sharedSizeBytes));
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return err;
}

// Launches list_pass2 over nq queries' ncand keys each.
inline cudaError_t launch_list_pass2(const u64* cand, int nq, int ncand, int k, float* vals, int* rows,
                                     cudaStream_t stream) {
  const int sort_n = pow2_at_least(k);
  const size_t sort_bytes = static_cast<size_t>(sort_n) * sizeof(u64);
  const size_t staged_bytes = static_cast<size_t>(((sort_n + 1) & ~1) + ncand) * sizeof(u64);
  const bool staged = staged_bytes + sizeof(SelectScratch) + 1024 <= kSmemMax;
  const size_t smem = staged ? staged_bytes : sort_bytes;
  const cudaError_t err = allow_smem<list_pass2>();
  if (err != cudaSuccess) return err;
  list_pass2<<<nq, kThreads, smem, stream>>>(cand, ncand, k, sort_n, staged, vals, rows);
  return cudaGetLastError();
}

// -- the multi-block select over a query's keys --------------------------------
//
// Past what list_pass2 stages in shared memory (ranges x cap keys a query:
// deep k over many ranges), one block a query would stream millions of
// keys from L2 several times.  Here every pass spreads a query's keys over
// many blocks, as K6 (select_topk.cu) does for scores: radix levels of 11
// bits over the 64-bit keys (bits 63..53, 52..42, 41..31, 30..20, 19..9,
// 8..0), each one launch in which every block adds the digits of its keys
// that match the prefix so far into a shared histogram, warp-aggregated
// (keys crowd a few bins), flushes it into the query's global histogram,
// and the last block to finish (a ticket on an atomic counter) finds the
// bin of the kk-th largest key, extends the prefix and lowers kk.  Keys
// are unique, so the levels end at the exact k-th key T (usually after the
// score's bits: a bin that holds exactly kk keys ends them early, and the
// later launches return at once); every non-zero key >= T is in the top
// k, equal scores lower row first, as every comparison here is by key.
// A collect pass copies those keys into a zeroed k-key buffer a query, and
// list_pass2 sorts it (staged: 2 x 8,192 keys fit) and writes (score, row).
// Launches: an init, six levels, the collect and list_pass2.

constexpr int kKsBins = 2048;    // 11-bit digits
constexpr int kKsLevels = 6;
constexpr int kKsKeys = 16384;   // keys a block of a streaming pass
constexpr int kKsUnroll = 4;     // loads in flight a thread

struct KeysState {  // one a query
  u64 prefix;       // the digits fixed so far; at the end the k-th key T
  u64 mask;
  uint32_t kk;      // keys still to take under the prefix
  uint32_t done;    // T is found: later levels return at once
  uint32_t arrive;  // blocks of the current level that have flushed
  uint32_t count;   // keys the collect pass has written
};

__device__ __forceinline__ int ks_shift(int level) { return level < kKsLevels - 1 ? 53 - 11 * level : 0; }
__device__ __forceinline__ int ks_bits(int level) { return level < kKsLevels - 1 ? 11 : 9; }

__global__ void keys_init(KeysState* __restrict__ st, uint32_t* __restrict__ hist, u64* __restrict__ out, int kpad,
                          int k) {
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < kKsBins; i += blockDim.x) hist[static_cast<size_t>(q) * kKsBins + i] = 0;
  for (int i = threadIdx.x; i < kpad; i += blockDim.x) out[static_cast<size_t>(q) * kpad + i] = 0ull;
  if (threadIdx.x == 0) st[q] = KeysState{0ull, 0ull, static_cast<uint32_t>(k), 0u, 0u, 0u};
}

// Calls fn(key) for the keys of this block's share [lo, hi) of one query's
// n keys, kKsUnroll loads in flight a thread; every thread runs the same
// rounds (past hi it sees key 0), so warp collectives may run inside fn.
template <class Fn>
__device__ __forceinline__ void ks_for_keys(const u64* keys, int lo, int hi, Fn fn) {
  for (int i0 = lo; i0 < hi; i0 += kKsUnroll * kThreads) {
    u64 kv[kKsUnroll];
#pragma unroll
    for (int u = 0; u < kKsUnroll; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      kv[u] = i < hi ? keys[i] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kKsUnroll; ++u) fn(kv[u]);
  }
}

// Grid (blocks of kKsKeys keys, queries): one radix level.
__global__ void __launch_bounds__(kThreads) keys_hist(const u64* __restrict__ cand, int n, KeysState* __restrict__ st,
                                                      uint32_t* __restrict__ hist, int level) {
  __shared__ uint32_t h[kKsBins];
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ int last;
  const int q = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const KeysState s0 = st[q];
  if (s0.done) return;  // block-uniform
  const int shift = ks_shift(level), bits = ks_bits(level);
  for (int i = tid; i < kKsBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const int lo = blockIdx.x * kKsKeys, hi = min(n, lo + kKsKeys);
  ks_for_keys(cand + static_cast<size_t>(q) * n, lo, hi, [&](u64 kv) {
    const uint32_t bin = kv != 0ull && (kv & s0.mask) == s0.prefix
                             ? static_cast<uint32_t>(kv >> shift) & ((1u << bits) - 1u)
                             : 0xffffffffu;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin != 0xffffffffu && lane == __ffs(peers) - 1) atomicAdd(&h[bin], static_cast<uint32_t>(__popc(peers)));
  });
  __syncthreads();
  uint32_t* g = hist + static_cast<size_t>(q) * kKsBins;
  for (int i = tid; i < kKsBins; i += kThreads)
    if (h[i]) atomicAdd(&g[i], h[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&st[q].arrive, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: the bin of the kk-th largest key, highest bins first
  __threadfence();
  constexpr int kPer = kKsBins / kThreads;
  const uint32_t kk = s0.kk;
  uint32_t c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = __ldcg(&g[kKsBins - 1 - (tid * kPer + j)]);
    sum += c[j];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  uint32_t base = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? warp_tot[w] : 0u;
    total += warp_tot[w];
  }
  incl += base;
  const uint32_t excl = incl - sum;
  if (level == 0 && total <= kk) {  // at most k non-zero keys: take them all
    if (tid == 0) {
      st[q].prefix = 1ull;
      st[q].done = 1u;
    }
  } else if (excl < kk && kk <= incl) {  // exactly one thread
    uint32_t above = excl;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (above + c[j] >= kk) {
        const u64 digit = static_cast<u64>(kKsBins - 1 - (tid * kPer + j));
        st[q].prefix = s0.prefix | (digit << shift);
        st[q].mask = s0.mask | (static_cast<u64>((1u << bits) - 1u) << shift);
        st[q].kk = kk - above;
        st[q].done = c[j] == kk - above;  // every key under the prefix is taken (always at the last level)
        break;
      }
      above += c[j];
    }
  }
  for (int i = tid; i < kKsBins; i += kThreads) g[i] = 0;
  if (tid == 0) st[q].arrive = 0u;
}

// Grid (blocks of kKsKeys keys, queries): the non-zero keys >= T into
// out[q][0, min(k, non-zero)), in no order.
__global__ void __launch_bounds__(kThreads) keys_collect(const u64* __restrict__ cand, int n,
                                                         KeysState* __restrict__ st, u64* __restrict__ out,
                                                         int kpad) {
  const int q = blockIdx.y, lane = threadIdx.x & 31;
  const u64 thr = st[q].prefix;
  u64* dst = out + static_cast<size_t>(q) * kpad;
  const int lo = blockIdx.x * kKsKeys, hi = min(n, lo + kKsKeys);
  ks_for_keys(cand + static_cast<size_t>(q) * n, lo, hi, [&](u64 kv) {
    const bool take = kv != 0ull && kv >= thr;
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    uint32_t slot = 0;
    if (lane == 0 && ballot) slot = atomicAdd(&st[q].count, static_cast<uint32_t>(__popc(ballot)));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (take) dst[slot + __popc(ballot & ((1u << lane) - 1u))] = kv;
  });
}

inline int keys_kpad(int k) { return (k + 31) / 32 * 32; }

// Scratch bytes of launch_keys_select for nq queries at depth k.
inline size_t keys_select_bytes(int nq, int k) {
  return static_cast<size_t>(nq) *
         (sizeof(KeysState) + kKsBins * sizeof(uint32_t) + static_cast<size_t>(keys_kpad(k)) * sizeof(u64));
}

// The top k of each of nq queries' ncand keys (cand[q][ncand]) into vals
// and rows, best first; scratch holds keys_select_bytes(nq, k) bytes,
// 16-byte aligned.
inline cudaError_t launch_keys_select(const u64* cand, int nq, int ncand, int k, float* vals, int* rows,
                                      void* scratch, cudaStream_t stream) {
  if (nq < 1 || nq > 65535) return cudaErrorInvalidValue;
  KeysState* st = static_cast<KeysState*>(scratch);
  uint32_t* hist = reinterpret_cast<uint32_t*>(st + nq);
  u64* out = reinterpret_cast<u64*>(hist + static_cast<size_t>(nq) * kKsBins);
  const int kpad = keys_kpad(k);
  const dim3 grid((ncand + kKsKeys - 1) / kKsKeys, nq);
  keys_init<<<nq, kThreads, 0, stream>>>(st, hist, out, kpad, k);
  for (int level = 0; level < kKsLevels; ++level) keys_hist<<<grid, kThreads, 0, stream>>>(cand, ncand, st, hist, level);
  keys_collect<<<grid, kThreads, 0, stream>>>(cand, ncand, st, out, kpad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_list_pass2(out, nq, kpad, k, vals, rows, stream);
}

// Pass 2 of a list-keeping scan over nq queries' ncand = ranges x cap keys:
// the multi-block select where the launch plan says so (`multi`, its
// scratch right after the lists), else list_pass2.
inline cudaError_t launch_lists_pass2(u64* cand, int nq, int ncand, int k, int multi, float* vals, int* rows,
                                      cudaStream_t stream) {
  if (multi) return launch_keys_select(cand, nq, ncand, k, vals, rows, cand + static_cast<size_t>(nq) * ncand, stream);
  return launch_list_pass2(cand, nq, ncand, k, vals, rows, stream);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-d (outer, inner) tensor whose outer index advances `stride` bytes,
// read in (box_outer x box_inner)-element boxes; past (outer, inner) the
// box reads zeros.
bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner, uint64_t outer,
                 uint64_t stride, uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (n,) vector of 4-byte elements (source ids, scales) read in boxes of
// `box` elements; past n, zeros.
bool make_map_1d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int n, int box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};  // unused at rank 1
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem[1] = {1};
  return fn(map, type, 1, const_cast<void*>(ptr), dims, strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The checks every list-based launch plan shares: cap fits k, the ranges
// cover the sweep in whole tiles of `tile` rows, and fit a grid dimension.
inline bool list_plan_ok(int n_sweep, int k, int ranges, int rows_per_range, int cap, int tile) {
  return (k <= kSortK ? cap == kSortCap : cap > k) && ranges >= 1 && ranges <= 65535 &&
         rows_per_range >= tile && rows_per_range % tile == 0 &&
         static_cast<long long>(ranges) * rows_per_range >= n_sweep;
}

}  // namespace

// The wgmma pass 1s over a row-major matrix (scan_slab_rows.cu): K2's
// (bf16) and K4's (int8 with row and query scales), and K1's and K3's for
// sweeps wider than their CUDA-core crossover (ops/topk.py
// `flat_rows_plan`).  Leave each (query, range) list in cand.
cudaError_t scan_bf16_wgmma_lists(const void* matrix, const int* src, const void* q, const int* allowed,
                                  int n_filter, int nq, int d, int n_sweep, int k, int qrows, int ranges,
                                  int rows_per_range, int cap, unsigned long long* cand, cudaStream_t s);
cudaError_t scan_s8_rows_wgmma_lists(const void* matrix, const float* scales, const int* src, const void* q,
                                     const float* qscale, const int* allowed, int n_filter, int nq, int d,
                                     int n_sweep, int k, int qrows, int ranges, int rows_per_range, int cap,
                                     unsigned long long* cand, cudaStream_t s);

// The s8 wgmma pass 1 over a column-major matrix (scan_slab_cols.cu): K8's
// and K9 slab's, and K7's and K9 flat's for sweeps wider than their
// CUDA-core crossover (ops/topk.py `flat_cols_plan`).  int4: the packed
// (d/2, ld) matrix, else the (d, ld) int8 companion.  Leaves each (query,
// range) list in cand.
cudaError_t scan_s8_cols_wgmma_lists(bool int4, const void* m, int ld, const float* scales, const int* src,
                                     const void* q, const float* qscale, const int* allowed, int n_filter, int nq,
                                     int d, int n_sweep, int k, int qrows, int ranges, int rows_per_range, int cap,
                                     unsigned long long* cand, cudaStream_t s);
