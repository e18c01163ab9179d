// The batch scans over column-major (transposed) matrices, one kernel for
// Hopper templated on its decode stage: K9's slab kernel (the packed-int4
// matrix) and K8 (the int2 tier's int8 companion), exact scans with top-k
// selection for batches of queries (sweeps of at least 256).  Its pass 1,
// with a tile of 64 queries (one consumer warpgroup) or 128, also serves
// K7 and K9 flat (scan_flat_cols.cu) past their CUDA-core crossover
// (`scan_s8_cols_wgmma_lists`).
//
// Replaces the TPU kernels perceive_tpu/ops/topk.py `pallas_topk_int4_slabbed`
// (`_scan_kernel_int4_slabbed`) and `pallas_topk_int8t_slabbed`
// (`_scan_kernel_int8t_slabbed`): top-k of int8-query scores over rows [0,
// n_sweep) of a transposed matrix of ld columns (ld, its capacity).  K9's
// is the (D/2, ld) packed matrix, whose byte [r, n] holds dim r of row n in
// the low nibble, biased +8, and dim r + D/2 in the high nibble, two's
// complement; K8's the (D, ld) int8 companion, byte [r, n] dim r of row n.
// Scores are f32(exact int32 dot) * row scale * query scale, rounded in
// that order (__fmul_rn), bit for bit with the plain versions (ops/topk.py
// `scores_int4`, `scores_int8t`); rows whose source id is -1 or outside
// `allowed` are excluded, ties go to the lower row, and every comparison
// is by the unique (score, ~row) keys of topk_common.cuh.
//
// What bounds them on the H100: operations.  At Q = 512 a 25,165,824 x 384
// sweep is 9.9e12 int8 operations (5.0 ms at 1,979 TOP/s) against 4.8 GB of
// packed matrix (1.4 ms at 3.35 TB/s); K8 over 3,809,280 rows 1.5e12 (0.72
// ms) against 1.5 GB (0.44 ms).  The first versions (one block per (64
// queries, 512 rows), min(k, 512) keys kept per query and block) took ~1 s
// at int4 and 65 ms at int8: the workspace was as large as the matrix, a
// budget split each sweep into launches of few queries, each re-reading
// the whole matrix, and the grid's y dimension, the row block, refused
// sweeps past 33,553,920 rows.
//
// Design, K2's (scan_slab_rows.cu) with a decode stage:
//   * about one block per SM: (query tiles of 128) x (row ranges) ~ the SM
//     count; no grid dimension grows with the rows.  A block keeps its
//     query tile resident (two consumer warpgroups of 64 queries) and walks
//     one contiguous row range in tiles of 128 rows; blocks of one range
//     are launched side by side, so its bytes come from L2 for all but the
//     first;
//   * a producer warp streams each row tile as boxes of byte-rows x 128
//     rows (64 packed byte-rows, 8 KiB; or 128 int8 dims, 16 KiB) by TMA
//     through a ring of shared-memory stages, with the tile's source ids
//     and row scales two tiles ahead, completion on mbarriers;
//   * the consumers decode each box in registers (4 x 4 byte transposes;
//     at int4 then the low nibbles less 8 and the sign-extended high
//     nibbles) into one 128-byte K-slice of the 128 rows, written with the
//     128-byte swizzle to one of two decode buffers; the query tile is
//     staged in the decoded dim order (int4: dims r.. then r + D/2..; int8:
//     the natural order);
//   * wgmma m64n128k32 (s8 x s8 -> s32, exact) scores each slice, A = the
//     warpgroup's 64 queries, B = the decoded rows, both from shared
//     memory; a box's products run while the next box decodes;
//   * the epilogue scales each int32 dot (hopper_common.cuh `scale_tile`)
//     and keeps K2's running per-(query, range) lists (hopper_common.cuh);
//     pass 2 (hopper_common.cuh `list_pass2`) selects over ranges x cap keys
//     a query, staged in shared memory where they fit.
// Why A is not the decoded rows from registers: the accumulator would then
// hold rows x queries, spreading each query over all eight warps, and the
// lists, which one warp owns per query in K2's epilogue, would need
// block-wide barriers to compact.  Writing the decoded slice to shared
// memory keeps the epilogue K2's.
// What holds it back: the decode and its barrier run on the consumer
// warps, between products; the two warpgroups consume each slice in step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kRowTile = 128;                      // rows a tile (wgmma n = 128)
constexpr int kWgQueries = 64;                     // queries a consumer warpgroup (m = 64)
constexpr int kSliceBytes = kRowTile * 128;        // a decoded K-slice: 128 rows x 128 bytes
constexpr int kMaxStages = 8;
constexpr int kSrcAhead = 2;  // tiles whose source ids and scales load ahead of their rows
// a tile's ids and scales are read in its last slice's epilogue: when the
// producer may load box (tile, 0), the consumers have decoded box (tile,
// 0) - stages and so finished the epilogues of every tile up to tile -
// ceil((stages + 1) / slices) - 1; slot reuse kSrcSlots back is then safe
constexpr int kSrcSlots = kSrcAhead + kMaxStages + 2;

// a[j] for a j known only at run time, by selects (an indexed register
// array would go to local memory).  The decodes store each lane's rows in
// an order rotated by lane / 2, so that the lanes of a half-warp (uint2
// stores) or of a quarter-warp (uint4) hit distinct 16-byte chunks.
__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int j) {
  uint32_t v = a[0];
#pragma unroll
  for (int jj = 1; jj < 4; ++jj)
    if (j == jj) v = a[jj];
  return v;
}

// 4 int8 values from the low nibbles of a packed word, less the bias of 8:
// each byte (s | 0x80) - 8 stays >= 0x78, so no borrow crosses bytes, and
// the final XOR turns 0x80 + (s - 8) into s - 8 in two's complement
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t w) {
  return (((w & 0x0f0f0f0fu) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// 4 int8 values from the high nibbles, sign-extended: h ^ 8 is h + 8 for
// the 4-bit two's complement h, then as nibbles_lo
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t w) {
  return ((((w >> 4) & 0x0f0f0f0fu) ^ 0x88888888u) - 0x08080808u) ^ 0x80808080u;
}

// K9: the packed (D/2, ld) int4 matrix.  A ring stage holds 64 byte-rows;
// K-slice c of a row holds dims 64c.. (the low nibbles) then D/2 + 64c..
// (the high).
struct Int4Cols {
  static constexpr int kByteRows = 64;
  static constexpr int kDimsPerByteRow = 2;
  // the first dim of 16-byte chunk h of K-slice c
  __device__ __forceinline__ static int dim(int c, int h, int d) { return (h < 4 ? 0 : d / 2) + 64 * c + 16 * (h & 3); }
  // The consumers (ctid in [0, 256)) decode one ring stage, packed
  // byte-rows [64c, 64c + 64) x 128 rows ([byte-row][row], 128 bytes a
  // byte-row), into the 128-byte K-slice of each row, 128-byte swizzled.
  // Warp w takes byte-rows 8w..8w+7, lane l rows 4l..4l+3: eight word loads
  // (lane l on bank l), two 4 x 4 byte transposes, then per row 8 bytes of
  // low-nibble dims and 8 of high.
  __device__ __forceinline__ static void decode(const unsigned char* stage, unsigned char* dst, int ctid) {
    const int w = ctid >> 5, l = ctid & 31;
    uint32_t x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = *reinterpret_cast<const uint32_t*>(stage + (8 * w + i) * kRowTile + 4 * l);
    uint32_t a[4], b[4];  // a[j]: row 4l + j, byte-rows 8w..8w+3; b[j]: 8w+4..8w+7
    transpose4x4(x[0], x[1], x[2], x[3], a);
    transpose4x4(x[4], x[5], x[6], x[7], b);
    const int rot = (l >> 1) & 3;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = (ii + rot) & 3;
      const uint32_t wa = pick4(a, j), wb = pick4(b, j);
      const int n = 4 * l + j;
      *reinterpret_cast<uint2*>(dst + swz128(n, 8 * w)) = make_uint2(nibbles_lo(wa), nibbles_lo(wb));
      *reinterpret_cast<uint2*>(dst + swz128(n, 64 + 8 * w)) = make_uint2(nibbles_hi(wa), nibbles_hi(wb));
    }
  }
};

// K8: the (D, ld) int8 companion.  A ring stage holds 128 byte-rows (dims);
// K-slice c of a row holds dims 128c.. in their natural order.
struct Int8Cols {
  static constexpr int kByteRows = 128;
  static constexpr int kDimsPerByteRow = 1;
  __device__ __forceinline__ static int dim(int c, int h, int) { return 128 * c + 16 * h; }
  // Warp w takes dims 16w..16w+15, lane l rows 4l..4l+3: sixteen word loads
  // (lane l on bank l), four 4 x 4 byte transposes, then one 16-byte store
  // a row (chunk w of its K-slice); the rotated row order puts the 8 lanes
  // of a quarter-warp on 8 distinct chunks.
  __device__ __forceinline__ static void decode(const unsigned char* stage, unsigned char* dst, int ctid) {
    const int w = ctid >> 5, l = ctid & 31;
    uint32_t r[4][4];  // r[m][j]: row 4l + j, dims 16w + 4m..
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const unsigned char* p = stage + (16 * w + 4 * m) * kRowTile + 4 * l;
      transpose4x4(*reinterpret_cast<const uint32_t*>(p), *reinterpret_cast<const uint32_t*>(p + kRowTile),
                   *reinterpret_cast<const uint32_t*>(p + 2 * kRowTile),
                   *reinterpret_cast<const uint32_t*>(p + 3 * kRowTile), r[m]);
    }
    const int rot = (l >> 1) & 3;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = (ii + rot) & 3;
      *reinterpret_cast<uint4*>(dst + swz128(4 * l + j, 16 * w)) =
          make_uint4(pick4(r[0], j), pick4(r[1], j), pick4(r[2], j), pick4(r[3], j));
    }
  }
};

// Grid (query tiles, row ranges); block: NWG consumer warpgroups (two for
// the batch scans; one for K7's and K9 flat's 64-query tiles,
// scan_flat_cols.cu) + one producer warp.  cand[q][range][cap]: each
// (query, range)'s candidate list, kept there while the block runs.
template <class Dec, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) scan_slab_cols(
    const __grid_constant__ CUtensorMap tmap_m, const __grid_constant__ CUtensorMap tmap_s,
    const __grid_constant__ CUtensorMap tmap_scale, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int k, int cap, int rows_per_range,
    int nranges, int stages, u64* __restrict__ cand) {
  constexpr int kStageBytes = Dec::kByteRows * kRowTile;
  constexpr int kQRows = NWG * kWgQueries;  // queries a block
  constexpr int kConsumers = NWG * 128;     // consumer threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int nslice = d / 128;  // K-slices (ring boxes) a tile
  unsigned char* qs = base;                                               // [nslice][128 queries][128 B]
  unsigned char* dec = qs + static_cast<size_t>(nslice) * kQRows * 128;  // [2][128 rows][128 B]
  unsigned char* ring = dec + 2 * kSliceBytes;                            // [stages][byte-rows][128 rows]
  int* src_ring = reinterpret_cast<int*>(ring + static_cast<size_t>(stages) * kStageBytes);  // [kSrcSlots][128]
  float* scl_ring = reinterpret_cast<float*>(src_ring + kSrcSlots * kRowTile);              // [kSrcSlots][128]
  float* qsc = scl_ring + kSrcSlots * kRowTile;                                              // [kQRows]
  u64* tau = reinterpret_cast<u64*>(qsc + kQRows);                                           // [kQRows]
  int* cnt = reinterpret_cast<int*>(tau + kQRows);                                           // [kQRows]
  uint64_t* full = reinterpret_cast<uint64_t*>(cnt + kQRows);                                // [stages]
  uint64_t* empty = full + stages;                                                           // [stages]
  uint64_t* src_full = empty + stages;                                                       // [kSrcSlots]
  int* allow = reinterpret_cast<int*>(src_full + kSrcSlots);                                 // [kMaxFilter]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQRows;
  const int qn = min(kQRows, nq - q0);
  const int range = blockIdx.y;
  const int row_lo = range * rows_per_range;
  const int row_hi = min(n_sweep, row_lo + rows_per_range);
  const int n_tiles = row_hi > row_lo ? (row_hi - row_lo + kRowTile - 1) / kRowTile : 0;

  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  if (tid < kQRows) {
    tau[tid] = 0ull;
    cnt[tid] = 0;
    qsc[tid] = tid < qn ? qscale[q0 + tid] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < kSrcSlots; ++s) mbar_init(src_full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: every row tile slice by slice, ids and scales two tiles ahead
    if (lane == 0) {
      auto load_src = [&](int t) {
        uint64_t* bar = src_full + t % kSrcSlots;
        mbar_expect_tx(bar, kRowTile * 8);
        tma_load_1d(src_ring + (t % kSrcSlots) * kRowTile, &tmap_s, row_lo + t * kRowTile, bar);
        tma_load_1d(scl_ring + (t % kSrcSlots) * kRowTile, &tmap_scale, row_lo + t * kRowTile, bar);
      };
      for (int t = 0; t < kSrcAhead && t < n_tiles; ++t) load_src(t);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < n_tiles; ++tile) {
        for (int c = 0; c < nslice; ++c) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, kStageBytes);
          tma_load(ring + stage * kStageBytes, &tmap_m, row_lo + tile * kRowTile, c * Dec::kByteRows, full + stage);
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

  // consumers.  The query tile, in the decoded dim order: 16-byte chunk h
  // of K-slice c of query r holds dims Dec::dim(c, h, d).., swizzled.
  for (int i = tid; i < nslice * kQRows * 8; i += kConsumers) {
    const int h = i & 7, r = (i >> 3) % kQRows, c = i / (8 * kQRows);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < qn) v = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(q0 + r) * d + Dec::dim(c, h, d));
    *reinterpret_cast<uint4*>(qs + static_cast<size_t>(c) * kQRows * 128 + swz128(r, 16 * h)) = v;
  }

  // warpgroup wg, its warp w holds queries wg*64 + 16w + g (+8)
  const int wg = warp >> 2, wq0 = wg * kWgQueries + (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int qa = wq0 + g, qb = qa + 8;
  auto list_of = [&](int qq) -> u64* { return cand + (static_cast<size_t>(q0 + qq) * nranges + range) * cap; };
  const unsigned char* qa_tile = qs + wg * kWgQueries * 128;
  const bool allow_all = allow[0] == kAllowAll;

  int stage = 0;
  uint32_t phase = 0;
  auto decode_next = [&](unsigned char* dst) {
    mbar_wait(full + stage, phase);
    Dec::decode(ring + stage * kStageBytes, dst, tid);
    if constexpr (NWG == 1) Dec::decode(ring + stage * kStageBytes, dst, tid + 128);  // the other four warps' share
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  };
  const int total = n_tiles * nslice;
  if (total > 0) decode_next(dec);
  fence_async_smem();  // the query tile, for wgmma
  named_barrier(1, kConsumers);

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int i = 0; i < total; ++i) {
    const int tile = i / nslice, c = i - tile * nslice;
    wgmma_fence();
    const uint64_t da = smem_desc(qa_tile + static_cast<size_t>(c) * kQRows * 128);
    const uint64_t db = smem_desc(dec + (i & 1) * kSliceBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, c | kk);
    wgmma_commit();
    // the next slice decodes into the other buffer while these products run
    if (i + 1 < total) decode_next(dec + ((i + 1) & 1) * kSliceBytes);
    wgmma_wait_all();
    named_barrier(1, kConsumers);  // the next slice is whole; this one is read
    if (c != nslice - 1) continue;

    // epilogue: acc[4j + 2h + e] is the dot of query (h ? qb : qa) and
    // tile row 8j + 2t + e
    const int row0 = row_lo + tile * kRowTile;
    const int slot = tile % kSrcSlots;
    mbar_wait(src_full + slot, (tile / kSrcSlots) & 1);
    const uint32_t valid = tile_valid(src_ring + slot * kRowTile, row_hi - row0, allow, allow_all ? 0 : n_filter, t);
    float sc[64];
    scale_tile(acc, scl_ring + slot * kRowTile, qsc[qa], qsc[qb], t, sc);
    append_tile(sc, valid, row0, qa, qb, qn, wq0, tau, cnt, list_of, k, cap);
  }
  finish_lists(wq0, qn, cnt, list_of, cap);
}

template <class Dec, int NWG>
size_t plan_smem(int d, int stages) {
  constexpr int kQRows = NWG * kWgQueries;
  return 1024 + static_cast<size_t>(d / 128) * kQRows * 128 + 2 * kSliceBytes +
         static_cast<size_t>(stages) * Dec::kByteRows * kRowTile + kSrcSlots * kRowTile * 8 + kQRows * (4 + 8 + 4) +
         static_cast<size_t>(2 * stages + kSrcSlots) * 8 + kMaxFilter * 4;
}

// Pass 1 of K8, K9 slab and (past their crossover, ops/topk.py
// `flat_cols_plan`) K7 and K9 flat into cand: the transposed (d /
// kDimsPerByteRow, ld) matrix (ld, its capacity, a multiple of 16: TMA
// strides are), (ld,) f32 row scales, int8 queries (nq, d) with (nq,) f32
// scales; d a multiple of 128; matrix, scales, src and q 16-byte aligned.
// The launch plan comes from the wrapper (`slab_s8_plan`, `flat_cols_plan`):
// qrows (64: one consumer warpgroup, or 128: two) queries a block, `ranges`
// row ranges of rows_per_range rows (a multiple of 128) covering n_sweep,
// and each (query, range) list's capacity cap: 64 keys for k <= 32, else
// more than k.  cand: nq * ranges * cap keys, the lists themselves.
template <class Dec, int NWG>
cudaError_t cols_lists(const void* m, int ld, const float* scales, const int* src, const void* q,
                       const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                       int ranges, int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  int stages = kMaxStages;
  while (stages >= 2 && plan_smem<Dec, NWG>(d, stages) > kSmemMax) --stages;
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = plan_smem<Dec, NWG>(d, stages);
  CUtensorMap tmap_m, tmap_s, tmap_scale;
  if (!make_map_2d(&tmap_m, CU_TENSOR_MAP_DATA_TYPE_UINT8, m, n_sweep, d / Dec::kDimsPerByteRow, ld, kRowTile,
                   Dec::kByteRows, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_1d(&tmap_s, CU_TENSOR_MAP_DATA_TYPE_INT32, src, n_sweep, kRowTile) ||
      !make_map_1d(&tmap_scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, n_sweep, kRowTile))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<scan_slab_cols<Dec, NWG>>();
  if (err != cudaSuccess) return err;
  constexpr int kQRows = NWG * kWgQueries;
  const dim3 grid((nq + kQRows - 1) / kQRows, ranges);
  scan_slab_cols<Dec, NWG><<<grid, NWG * 128 + 32, smem, s>>>(
      tmap_m, tmap_s, tmap_scale, static_cast<const int8_t*>(q), qscale, allowed, n_filter, nq, d, n_sweep, k, cap,
      rows_per_range, ranges, stages, cand);
  return cudaGetLastError();
}

template <class Dec>
cudaError_t scan_cols_lists(const void* m, int ld, const float* scales, const int* src, const void* q,
                            const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                            int qrows, int ranges, int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || d % 128 || ld % 16 || n_sweep > ld ||
      (qrows != kWgQueries && qrows != 2 * kWgQueries) ||
      !list_plan_ok(n_sweep, k, ranges, rows_per_range, cap, kRowTile) || scales == nullptr || qscale == nullptr ||
      (reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(src) |
       reinterpret_cast<uintptr_t>(q)) % 16)
    return cudaErrorInvalidValue;
  return qrows == kWgQueries
             ? cols_lists<Dec, 1>(m, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, ranges,
                                  rows_per_range, cap, cand, s)
             : cols_lists<Dec, 2>(m, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, ranges,
                                  rows_per_range, cap, cand, s);
}

// Both C entries: pass 1 (scan_cols_lists, 128 queries a block), then
// list_pass2 over ranges x cap keys a query.  Workspace: nq * ranges * cap
// * 8 bytes.
template <class Dec>
int launch_cols(const void* m, int ld, const float* scales, const int* src, const void* q, const float* qscale,
                const int* allowed, int n_filter, int nq, int d, int n_sweep, int k, int qrows, int ranges,
                int rows_per_range, int cap, float* vals, int* rows, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* cand = static_cast<u64*>(workspace);
  const cudaError_t err = scan_cols_lists<Dec>(m, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k,
                                               qrows, ranges, rows_per_range, cap, cand, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_list_pass2(cand, nq, ranges * cap, k, vals, rows, s));
}

}  // namespace

cudaError_t scan_s8_cols_wgmma_lists(bool int4, const void* m, int ld, const float* scales, const int* src,
                                     const void* q, const float* qscale, const int* allowed, int n_filter, int nq,
                                     int d, int n_sweep, int k, int qrows, int ranges, int rows_per_range, int cap,
                                     unsigned long long* cand, cudaStream_t s) {
  return int4 ? scan_cols_lists<Int4Cols>(m, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qrows,
                                          ranges, rows_per_range, cap, cand, s)
              : scan_cols_lists<Int8Cols>(m, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qrows,
                                          ranges, rows_per_range, cap, cand, s);
}

extern "C" {

// K9's slab kernel: the packed (d/2, ld) int4 matrix (launch_cols).
int perceive_scan_slab_int4(const void* m4t, int ld, const float* scales, const int* src, const void* q,
                            const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                            int qrows, int ranges, int rows_per_range, int cap, float* vals, int* rows,
                            void* workspace, void* stream) {
  return launch_cols<Int4Cols>(m4t, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qrows, ranges,
                               rows_per_range, cap, vals, rows, workspace, stream);
}

// K8: the int2 tier's (d, ld) int8 companion (launch_cols).
int perceive_scan_topk_int8t_slab(const void* m8t, int ld, const float* scales, const int* src, const void* q,
                                  const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep,
                                  int k, int qrows, int ranges, int rows_per_range, int cap, float* vals, int* rows,
                                  void* workspace, void* stream) {
  return launch_cols<Int8Cols>(m8t, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qrows, ranges,
                               rows_per_range, cap, vals, rows, workspace, stream);
}

}  // extern "C"
