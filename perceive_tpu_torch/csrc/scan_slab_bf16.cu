// K2: exact scan with top-k selection over a bf16 matrix for batches of
// queries (sweeps of at least 256), a kernel of its own for Hopper.
//
// Replaces the TPU kernel perceive_tpu/ops/topk.py `pallas_topk_slabbed`
// (`_scan_kernel_slabbed`): top-k of q . matrix^T over rows [0, n_sweep),
// rows whose source id is -1 or outside `allowed` excluded, ties to the
// lower row, every comparison by the unique (score, ~row) keys of
// topk_common.cuh.
//
// What bounds it on the H100: operations.  At Q = 512 a 958,464 x 384
// sweep is 3.8e11 flop (0.36 ms at 989 TFLOP/s) against 0.74 GB of matrix
// (0.22 ms at 3.35 TB/s).  The first version (scan_slab.cu's template)
// lost to one matmul + topk: one block per (64 queries, 512 rows) ran a
// warp select per query over every 512 scores (~958K selects at Q = 512)
// and wrote min(k, 512) keys per query and block (479 KB a query) for
// pass 2 to read back several times.
//
// Design.  Pass 1 is persistent and threshold-pruned, like the TPU kernel's
// `_merge_tile_topk`, which merges a tile only while it beats the running
// buffer:
//   * about one block per SM: (query tiles) x (row ranges) ~ the SM count;
//     a block keeps its query tile (128 queries, two consumer warpgroups of
//     64; 64 and one warpgroup where 128 do not fit) resident in shared
//     memory and walks one contiguous row range in tiles of 128 rows;
//     blocks of one range are launched side by side, so its rows come from
//     L2 for all but the first;
//   * a producer warp streams each row tile as 64-dim boxes (128 rows x
//     128 bytes, 128-byte swizzle) through a ring of shared-memory stages
//     by TMA, completion on mbarriers; the tensor maps are encoded on the
//     host through cudaGetDriverEntryPoint, so nothing links libcuda;
//   * the consumer warpgroups score each box with wgmma m64n128k16 (bf16 ->
//     f32 in registers, A = queries, B = rows, both from shared memory);
//   * each tile's source ids come by TMA too, two tiles ahead, and each
//     consumer warp turns them into row-validity bits with four ballots;
//   * the epilogue: each query keeps a running threshold tau (the k-th best
//     key so far) and a candidate list in the workspace (it stays in L2):
//     64 keys for k <= 32, 2k past that.  A score screens against tau's
//     score in registers (64 compares a thread, no branches); a key that
//     beats tau is appended (a shared-memory atomic gives the slot), each
//     lane taking its candidates by predicated selects so that no lane
//     diverges into another's; when a list fills, its warp keeps the top k
//     (up to k = 32 a bitonic sort of the 64 keys in registers, past it a
//     bitwise search for the k-th key) and raises tau.  On random data
//     that is ~k ln(rows / k) appends a query and range instead of a select
//     over every row;
//   * at the end each block writes its lists as they stand (the range's
//     top k among them), cap keys a query: (ranges) x cap x 8 bytes a query
//     (about 17 KB at Q = 512, k = 32), and topk_common.cuh's pass 2 merges
//     them unchanged.
// What holds it back: the two warpgroups consume the same boxes in step,
// so each tile's epilogue (~k ln(rows / k) appends a query, and the
// compactions) runs between the tile's products instead of beside them;
// a stage is released only when both warpgroups are done with it, so one
// warpgroup's epilogue also stalls the other's products.

#include <cuda.h>  // CUtensorMap and its enums; the entry point comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kDimBox = 64;                       // dims a TMA box: 128 bytes, the swizzle span
constexpr int kRowTile = 128;                     // rows a wgmma tile (n = 128)
constexpr int kWgQueries = 64;                    // queries a consumer warpgroup (m = 64)
constexpr int kBoxBytes = kRowTile * kDimBox * 2;  // one ring stage: 16 KiB
constexpr int kSortK = 32;                        // k up to this: lists of kSortCap keys, sorted in registers
constexpr int kSortCap = 64;
constexpr size_t kSmemMax = 232448;               // per-block opt-in maximum on sm_90
constexpr int kMaxStages = 7;                     // ring stages, as many as fit up to this
constexpr int kSrcAhead = 2;                      // tiles whose source ids load ahead of their rows
constexpr int kSrcSlots = kSrcAhead + kMaxStages;  // >= kSrcAhead + ceil(stages / boxes a tile)

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

// box (c0 = first dim, c1 = first row) of a 2-d tensor map -> shared memory
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


// wgmma operand descriptor: a K-major tile of 128-byte rows, 128-byte
// swizzle (as TMA writes it), 8-row groups 1024 bytes apart.  Advancing
// along k by 16 bf16 adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  uint64_t desc = (smem_u32(p) & 0x3FFFFu) >> 4;
  desc |= 1ull << 16;                   // leading byte offset (unused when swizzled)
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  desc |= 1ull << 62;                   // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// d[64] += A(64 x 16, shared, descriptor da) . B(128 x 16, shared, db)^T;
// scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The bits of this thread's rows 8j + 2t + e of a tile (bit 2j + e): the
// row lies before `rows` and its source id (ids[r]) is live and, with a
// filter (n_filter > 0), allowed.  Four ballots, one per t: lane 2j + e
// tests row 8j + 2t' + e for each t'.
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

// One warp keeps the best k of the n keys list[0, n) (unique, non-zero,
// n > k): a bitwise search finds the k-th largest key T (stopping early
// once exactly k keys lie at or above the bits fixed so far), then the
// keys >= T move to list[0, k) in their order.  Returns T: every key below
// it is out of the list's top k.
__device__ u64 warp_keep_top(u64* list, int n, int k) {
  const int lane = threadIdx.x & 31;
  u64 t = 0;
  for (int bit = 63; bit >= 0; --bit) {
    const u64 c = t | (1ull << bit);
    int cnt = 0;
    for (int i = lane; i < n; i += 32) cnt += list[i] >= c;
    cnt = warp_sum_i(cnt);
    if (cnt >= k) {
      t = c;
      if (cnt == k) break;
    }
  }
  const unsigned lower = (1u << lane) - 1u;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const u64 key = i < n ? list[i] : 0ull;
    const bool take = i < n && key >= t;
    const unsigned takes = __ballot_sync(0xffffffffu, take);
    __syncwarp();
    if (take) list[base + __popc(takes & lower)] = key;
    base += __popc(takes);
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

// Grid (query tiles, row ranges); block: nwg consumer warpgroups + one
// producer warp.  cand[q][range][cap]: each (query, range)'s candidate
// list, kept there while the block runs.
__global__ void __launch_bounds__(2 * 128 + 32, 1) scan_slab_bf16(
    const __grid_constant__ CUtensorMap tmap_m, const __grid_constant__ CUtensorMap tmap_q,
    const __grid_constant__ CUtensorMap tmap_s, const int* __restrict__ allowed, int n_filter, int nq, int d,
    int n_sweep, int k, int cap, int rows_per_range, int nranges, int stages, int nwg,
    u64* __restrict__ cand) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int nbox = d / kDimBox;
  const int qrows = nwg * kWgQueries;
  unsigned char* qs = base;                                           // [nbox][qrows][128 B]
  unsigned char* ring = qs + static_cast<size_t>(nbox) * qrows * 128;  // [stages][128 rows][128 B]
  int* src_ring = reinterpret_cast<int*>(ring + static_cast<size_t>(stages) * kBoxBytes);  // [kSrcSlots][128]
  u64* tau = reinterpret_cast<u64*>(src_ring + kSrcSlots * kRowTile);  // [qrows]
  int* cnt = reinterpret_cast<int*>(tau + qrows);                    // [qrows]
  uint64_t* full = reinterpret_cast<uint64_t*>(cnt + qrows);         // [stages]
  uint64_t* empty = full + stages;                                   // [stages]
  uint64_t* qbar = empty + stages;
  uint64_t* src_full = qbar + 1;                                     // [kSrcSlots]
  int* allow = reinterpret_cast<int*>(src_full + kSrcSlots);         // [kMaxFilter]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * qrows;
  const int qn = min(qrows, nq - q0);
  const int range = blockIdx.y;
  const int row_lo = range * rows_per_range;
  const int row_hi = min(n_sweep, row_lo + rows_per_range);
  const int n_tiles = row_hi > row_lo ? (row_hi - row_lo + kRowTile - 1) / kRowTile : 0;

  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  if (tid < qrows) {
    tau[tid] = 0ull;
    cnt[tid] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, nwg * 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    for (int s = 0; s < kSrcSlots; ++s) mbar_init(src_full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == nwg * 4) {
    // producer: the query tile once, then every row tile box by box
    if (lane == 0) {
      mbar_expect_tx(qbar, static_cast<uint32_t>(nbox) * qrows * 128);
      for (int c = 0; c < nbox; ++c) tma_load(qs + static_cast<size_t>(c) * qrows * 128, &tmap_q, c * kDimBox, q0, qbar);
      // a tile's source ids load kSrcAhead tiles ahead of its rows; slot
      // reuse is safe: when box (tile, 0) may load, the consumers have
      // passed tile - ceil(stages / nbox), so every id kSrcSlots back is read
      auto load_src = [&](int t) {
        uint64_t* bar = src_full + t % kSrcSlots;
        mbar_expect_tx(bar, kRowTile * 4);
        tma_load_1d(src_ring + (t % kSrcSlots) * kRowTile, &tmap_s, row_lo + t * kRowTile, bar);
      };
      for (int t = 0; t < kSrcAhead && t < n_tiles; ++t) load_src(t);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < n_tiles; ++tile) {
        for (int c = 0; c < nbox; ++c) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, kBoxBytes);
          tma_load(ring + stage * kBoxBytes, &tmap_m, c * kDimBox, row_lo + tile * kRowTile, full + stage);
          if (c == 0 && tile + kSrcAhead < n_tiles) load_src(tile + kSrcAhead);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg, its warp w holds queries wg*64 + 16w + g (+8)
  const int wg = warp >> 2, wq0 = wg * kWgQueries + (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int qa = wq0 + g, qb = qa + 8;
  auto list_of = [&](int qq) -> u64* { return cand + (static_cast<size_t>(q0 + qq) * nranges + range) * cap; };
  u64* list_a = list_of(qa);
  u64* list_b = list_of(qb);
  const unsigned char* qa_tile = qs + wg * kWgQueries * 128;
  const bool allow_all = allow[0] == kAllowAll;
  mbar_wait(qbar, 0);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row0 = row_lo + tile * kRowTile;
    uint32_t valid = 0;  // rows 8j + 2t + e of the tile: bit 2j + e
    for (int c = 0; c < nbox; ++c) {
      mbar_wait(full + stage, phase);
      if (c == 0) {
        const int slot = tile % kSrcSlots;
        mbar_wait(src_full + slot, (tile / kSrcSlots) & 1);
        valid = tile_valid(src_ring + slot * kRowTile, row_hi - row0, allow, allow_all ? 0 : n_filter, t);
      }
      wgmma_fence();
      const uint64_t da = smem_desc(qa_tile + static_cast<size_t>(c) * qrows * 128);
      const uint64_t db = smem_desc(ring + stage * kBoxBytes);
#pragma unroll
      for (int kk = 0; kk < kDimBox / 16; ++kk) wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, c | kk);
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: acc[4j + 2h + e] is query (h ? qb : qa), row row0 + 8j + 2t
    // + e.  A score screens against the float of tau's score bits (queries
    // past nq screen at +inf), then its key must beat tau.
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
    // scores come out of acc by predicated selects, so no lane diverges
    // into code for another j.  Keys that find their list full are left
    // in (ma, mb) for after the compaction.
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
        const u64 thr = cap == kSortCap ? warp_keep_top64(list_of(qq), k) : warp_keep_top(list_of(qq), cap, k);
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

  // each (query, range) list as it stands, zero-filled to cap keys
  __syncwarp();
  for (int i = 0; i < 16; ++i) {
    const int qq = wq0 + i;
    if (qq >= qn) break;
    const int n = min(cnt[qq], cap);
    u64* list = list_of(qq);
    for (int j = n + lane; j < cap; j += 32) list[j] = 0ull;
  }
}

// -- host side ------------------------------------------------------------------

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

// A (rows, d) bf16 row-major tensor read in (box_rows x 64)-element boxes,
// 128-byte swizzled; rows past `rows` read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int d, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kDimBox), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (n,) int32 source ids read in boxes of kRowTile; past n, zeros.
bool make_src_map(CUtensorMap* map, const int* src, int n) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};  // unused at rank 1
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(kRowTile)};
  const cuuint32_t elem[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<int*>(src), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t plan_smem(int d, int nwg, int stages) {
  const int qrows = nwg * kWgQueries;
  return 1024 + static_cast<size_t>(d) * 2 * qrows + static_cast<size_t>(stages) * kBoxBytes + kSrcSlots * kRowTile * 4 +
         static_cast<size_t>(qrows) * 12 + static_cast<size_t>(2 * stages + 1 + kSrcSlots) * 8 + kMaxFilter * 4;
}

}  // namespace

extern "C" {

// K2: bf16 (n, d) matrix and (nq, d) queries, d a multiple of 64, both
// 16-byte aligned, and so is src.  The launch plan comes from the
// wrapper (ops/topk.py `slab_bf16_plan`): qrows (64 or 128) queries a
// block, `ranges` row ranges of rows_per_range rows (a multiple of 128)
// covering n_sweep, and each (query, range) list's capacity cap: 64 keys
// for k <= 32, else more than k.  Workspace: nq * ranges * cap * 8 bytes,
// the lists themselves.
int perceive_scan_slab_bf16(const void* matrix, const int* src, const void* q, const int* allowed,
                            int n_filter, int nq, int d, int n_sweep, int k, int qrows, int ranges,
                            int rows_per_range, int cap, float* vals, int* rows, void* workspace,
                            void* stream) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || d % kDimBox || (qrows != 64 && qrows != 128) ||
      (k <= kSortK ? cap != kSortCap : cap <= k) || ranges < 1 || ranges > 65535 ||
      rows_per_range < kRowTile || rows_per_range % kRowTile ||
      static_cast<long long>(ranges) * rows_per_range < n_sweep ||
      (reinterpret_cast<uintptr_t>(matrix) | reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(src)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nwg = qrows / kWgQueries;
  int stages = kMaxStages;
  while (stages >= 2 && plan_smem(d, nwg, stages) > kSmemMax) --stages;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = plan_smem(d, nwg, stages);
  CUtensorMap tmap_m, tmap_q, tmap_s;
  if (!make_map(&tmap_m, matrix, n_sweep, d, kRowTile) || !make_map(&tmap_q, q, nq, d, qrows) ||
      !make_src_map(&tmap_s, src, n_sweep))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(scan_slab_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* cand = static_cast<u64*>(workspace);
  const dim3 grid((nq + qrows - 1) / qrows, ranges);
  scan_slab_bf16<<<grid, qrows * 2 + 32, smem, s>>>(tmap_m, tmap_q, tmap_s, allowed, n_filter, nq, d, n_sweep, k, cap,
                                                   rows_per_range, ranges, stages, nwg, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_pass2(cand, nq, ranges * cap, k, vals, rows, s));
}


}  // extern "C"
