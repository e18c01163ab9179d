// K7 and K9's flat kernel: exact scans with top-k selection over the
// column-major (transposed) matrices for fewer than 256 queries (every
// text query's sweep of the int4 tier, and every escalation of the int2
// tier), one kernel for Hopper templated on its decode: K7 over the int2
// tier's (D, ld) int8 companion, K9 flat over the (D/2, ld) packed-int4
// matrix (the int4 tier, and the int2 tier's int4 companion).
//
// Replaces the TPU kernels perceive_tpu/ops/topk.py
// `pallas_topk_int8t_unsorted` (`_scan_kernel_int8t`) and
// `pallas_topk_int4_unsorted` (`_scan_kernel_int4`): top-k of int8-query
// scores over rows [0, n_sweep) of a transposed matrix of ld columns.  K9's
// byte [r, n] holds dim r of row n in the low nibble, biased +8, and dim r
// + D/2 in the high nibble, two's complement; K7's byte [r, n] is dim r of
// row n.  Scores are f32(exact int32 dot) * row scale * query scale,
// rounded in that order (__fmul_rn), bit for bit with the plain versions
// (ops/topk.py `scores_int8t`, `scores_int4`); rows whose source id is -1
// or outside `allowed` are excluded, ties go to the lower row, and every
// comparison is by the unique (score, ~row) keys of topk_common.cuh.
//
// What bounds them on the H100: device-memory bytes.  At Q = 1 a
// 25,165,824-row packed sweep reads 4.8 GB (1.43 ms at 3.35 TB/s), K7 over
// 3,809,280 rows 1.46 GB (0.44 ms), for 2 * D int8 operations a row and
// query.  The first kernel took 44.5 and 2.9 ms: a block per
// (8 queries, 256 rows) with plain loads, a select over every 512-row
// block that kept min(k, 512) keys per block and query (49,152 blocks x
// 256 keys a query at 25M rows), and a pass 2 of one block a query over
// all of them; its workspace grew with the rows (4 GiB for K9).
//
// Design, K1's CUDA-core template (scan_flat_rows.cu) with a decode:
//   * persistent blocks over contiguous row ranges, (query tiles of QT =
//     1, 2, 4, 8 or 16) x (ranges) ~ two blocks an SM; no launch dimension
//     grows with the rows;
//   * a producer warp streams each 128-row tile as boxes of 64 byte-rows x
//     128 rows (8 KiB) by TMA through a ring of shared-memory stages, the
//     tile's source ids and row scales two tiles ahead, completion on
//     mbarriers;
//   * one consumer warpgroup scores the tile on the CUDA cores: warp w
//     takes byte-rows 16w..16w+15 of each box, a thread 4 adjacent rows,
//     one 32-bit word a byte-row (a warp reads 128 contiguous bytes: no
//     bank conflict), and 4 x 4 byte transposes give each row's dp4a
//     operands.  At int8 `__dp4a` against the query bytes; at int4 the low
//     nibbles (p & 15) and the high nibbles XOR 8 are unsigned bytes in
//     [0, 16) that `dp4a.u32.s32` takes as they are, so the decode is three
//     operations a word, and the biases (-8 each) come back as -8 * the
//     sum of the query's bytes, added once a row;
//   * the four warps' partial dots go to a shared-memory tile; the
//     epilogue (one warp owns each query) adds them, scales, masks and
//     keeps K1's running threshold tau and per-(query, range) list
//     (hopper_common.cuh): ballot appends, barrier-free compactions.  At
//     Q = 1 almost no row passes tau after the first tiles;
//   * past the crossover width (ops/topk.py FLAT_COLS_CORE_QUERIES, by
//     decode, measured on the card) K8's and K9 slab's wgmma pass 1
//     (scan_slab_cols.cu) with a tile of 64 queries (128 past 64), so a
//     sweep of up to 64 queries reads the matrix once;
//   * pass 2: list_pass2 where ranges x cap keys a query stage in shared
//     memory, else hopper_common.cuh's multi-block radix select (deep k:
//     the escalations' k >= 1,024 at millions of rows).
// What holds it back: a block's consumer warpgroup alternates scoring and
// the epilogue, and the partial-dot tile costs a barrier a tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kRowTile = 128;                   // rows a tile
constexpr int kBoxRows = 64;                    // byte-rows a box (ring stage)
constexpr int kBoxBytes = kBoxRows * kRowTile;  // 8 KiB
constexpr int kConsumers = 128;                 // one consumer warpgroup
constexpr int kWarpRows = kBoxRows / 4;         // byte-rows a consumer warp takes of a box
constexpr int kMaxStages = 12;
constexpr int kSrcAhead = 2;  // tiles whose source ids and scales load ahead of their rows
// a tile's ids and scales are read in its epilogue: when the producer may
// load box (tile, 0), every consumer warp has released box (tile, 0) -
// stages and so finished the epilogues up to tile - ceil(stages / boxes) -
// 1; slot reuse kSrcSlots back is then safe
constexpr int kSrcSlots = kSrcAhead + kMaxStages + 2;
constexpr size_t kTwoPerSm = 115712;  // the most a block may take for two to share an SM

// d = dp4a of the unsigned bytes of a with the signed bytes of b, plus c
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t u4_at(const uint4& v, int g) {
  return g == 0 ? v.x : g == 1 ? v.y : g == 2 ? v.z : v.w;
}

// The shared-memory bytes of a launch (layout in scan_flat_cols, in this
// order): halves = 2 at int4 (the low- and high-nibble dims of each
// byte-row), 1 at int8; brpad = the byte-rows padded to whole boxes.
inline size_t plan_smem(int qt, int halves, int brpad, int stages) {
  return 1024 + static_cast<size_t>(stages) * kBoxBytes + kSrcSlots * kRowTile * 8 +
         static_cast<size_t>(qt) * 2 * 4 * kRowTile * 4 + static_cast<size_t>(qt) * halves * brpad +
         static_cast<size_t>(qt) * (4 + 4 + 8 + 4) + 8 + static_cast<size_t>(2 * stages + kSrcSlots) * 8 +
         kMaxFilter * 4;
}

// Grid (query tiles of QT, row ranges); block: one consumer warpgroup + one
// producer warp.  cand[q][range][cap]: each (query, range)'s candidate
// list, kept there while the block runs.
template <bool kInt4, int QT>
__global__ void __launch_bounds__(kConsumers + 32, 2) scan_flat_cols(
    const __grid_constant__ CUtensorMap tmap_m, const __grid_constant__ CUtensorMap tmap_s,
    const __grid_constant__ CUtensorMap tmap_scale, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int k, int cap, int rows_per_range,
    int nranges, int stages, u64* __restrict__ cand) {
  constexpr int H = kInt4 ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int byte_rows = kInt4 ? d / 2 : d;
  const int nbox = (byte_rows + kBoxRows - 1) / kBoxRows;
  const int brpad = nbox * kBoxRows;
  // the TMA destinations first: the ring, then the ids and scales (128-byte aligned)
  unsigned char* ring = base;                                                                 // [stages][64][128 rows]
  int* src_ring = reinterpret_cast<int*>(ring + static_cast<size_t>(stages) * kBoxBytes);  // [kSrcSlots][128]
  float* scl_ring = reinterpret_cast<float*>(src_ring + kSrcSlots * kRowTile);              // [kSrcSlots][128]
  int* part = reinterpret_cast<int*>(scl_ring + kSrcSlots * kRowTile);                       // [2][4 warps][QT][128]
  unsigned char* qs = reinterpret_cast<unsigned char*>(part + 2 * 4 * QT * kRowTile);        // [QT][H][brpad]
  float* qsc = reinterpret_cast<float*>(qs + QT * H * brpad);                                // [QT]
  int* corr = reinterpret_cast<int*>(qsc + QT);                                              // [QT]
  u64* tau = reinterpret_cast<u64*>(corr + QT);                                              // [QT]
  int* cnt = reinterpret_cast<int*>(tau + QT);                                               // [QT]
  uint64_t* full = reinterpret_cast<uint64_t*>(cnt + QT + (QT & 1));                         // [stages]
  uint64_t* empty = full + stages;                                                           // [stages]
  uint64_t* src_full = empty + stages;                                                       // [kSrcSlots]
  int* allow = reinterpret_cast<int*>(src_full + kSrcSlots);                                 // [kMaxFilter]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QT;
  const int qn = min(QT, nq - q0);
  const int range = blockIdx.y;
  const int row_lo = range * rows_per_range;
  const int row_hi = min(n_sweep, row_lo + rows_per_range);
  const int n_tiles = row_hi > row_lo ? (row_hi - row_lo + kRowTile - 1) / kRowTile : 0;

  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  if (tid < QT) {
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
    // producer: every row tile box by box, ids and scales kSrcAhead tiles ahead
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
        for (int c = 0; c < nbox; ++c) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, kBoxBytes);
          tma_load(ring + stage * kBoxBytes, &tmap_m, row_lo + tile * kRowTile, c * kBoxRows, full + stage);
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

  // consumers: stage the queries by byte-row, qs[i][h][br] = dim br (h = 0)
  // or byte_rows + br (h = 1) of query i, zeros past the dims and past nq
  for (int i = tid; i < QT * H * brpad; i += kConsumers) {
    const int br = i % brpad, h = (i / brpad) % H, r = i / (H * brpad);
    qs[i] = r < qn && br < byte_rows ? static_cast<unsigned char>(q[static_cast<size_t>(q0 + r) * d + h * byte_rows + br])
                                     : 0;
  }
  // int4: the biases, -8 * the sum of the query's bytes (warp w owns
  // queries w, w + 4, ..., as in the epilogue: no barrier before its reads)
  for (int i = warp; i < QT; i += kConsumers / 32) {
    int sum = 0;
    if (kInt4 && i < qn)
      for (int j = lane; j < d; j += 32) sum += q[static_cast<size_t>(q0 + i) * d + j];
    sum = warp_sum_i(sum);
    if (lane == 0) corr[i] = -8 * sum;
  }
  named_barrier(1, kConsumers);

  const unsigned lower = (1u << lane) - 1u;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row0 = row_lo + tile * kRowTile;
    const int rows = row_hi - row0;
    int acc[QT][4];
#pragma unroll
    for (int i = 0; i < QT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int c = 0; c < nbox; ++c) {
      mbar_wait(full + stage, phase);
      // x[g][j]: row 4 * lane + j, byte-rows 16w + 4g .. + 3 of the box
      const unsigned char* box = ring + stage * kBoxBytes + warp * kWarpRows * kRowTile + 4 * lane;
      uint32_t x[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const unsigned char* p = box + 4 * g * kRowTile;
        transpose4x4(*reinterpret_cast<const uint32_t*>(p), *reinterpret_cast<const uint32_t*>(p + kRowTile),
                     *reinterpret_cast<const uint32_t*>(p + 2 * kRowTile),
                     *reinterpret_cast<const uint32_t*>(p + 3 * kRowTile), x[g]);
      }
      const int br0 = c * kBoxRows + warp * kWarpRows;
      uint32_t y[4][4];  // int4: the high nibbles XOR 8; x keeps the low ones
      if constexpr (kInt4) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            y[g][j] = ((x[g][j] >> 4) & 0x0f0f0f0fu) ^ 0x08080808u;
            x[g][j] &= 0x0f0f0f0fu;
          }
      }
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const uint4 ql = *reinterpret_cast<const uint4*>(qs + i * H * brpad + br0);
        if constexpr (kInt4) {
          const uint4 qh = *reinterpret_cast<const uint4*>(qs + (i * H + 1) * brpad + br0);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = dp4a_us(y[g][j], u4_at(qh, g), dp4a_us(x[g][j], u4_at(ql, g), acc[i][j]));
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(static_cast<int>(x[g][j]), static_cast<int>(u4_at(ql, g)), acc[i][j]);
        }
      }
      // release the stage once its words are used.  The proxy fence orders
      // this warp's generic-proxy reads of it before the TMA (async-proxy)
      // write that reuses it: a release right after the loads, without it,
      // let that write land first (wrong dots for a few rows, seen on the
      // card)
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // this warp's partial dots of rows 4 * lane .. + 3; the other buffer,
    // last read a tile ago, is free
    int* pb = part + (tile & 1) * 4 * QT * kRowTile;
#pragma unroll
    for (int i = 0; i < QT; ++i)
      *reinterpret_cast<int4*>(pb + (warp * QT + i) * kRowTile + 4 * lane) =
          make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    named_barrier(1, kConsumers);

    // epilogue: warp w owns queries w, w + 4, ...; a key that beats tau is
    // appended (ballot ranks give the slots); a full list keeps its top k
    const int slot = tile % kSrcSlots;
    const int* ids = src_ring + slot * kRowTile;
    const float* srow = scl_ring + slot * kRowTile;
    if (warp < qn) mbar_wait(src_full + slot, (tile / kSrcSlots) & 1);
    for (int i = warp; i < qn; i += kConsumers / 32) {
      u64* list = cand + (static_cast<size_t>(q0 + i) * nranges + range) * cap;
      u64 thr = tau[i];
      int n = cnt[i];
#pragma unroll
      for (int m = 0; m < kRowTile / 32; ++m) {
        const int r = 32 * m + lane;
        const int* pr = pb + i * kRowTile + r;
        const int dot = pr[0] + pr[QT * kRowTile] + pr[2 * QT * kRowTile] + pr[3 * QT * kRowTile] + corr[i];
        const bool ok = r < rows && row_allowed(ids[r], allow, n_filter);
        const float s = __fmul_rn(__fmul_rn(__int2float_rn(dot), srow[r]), qsc[i]);
        const u64 key = ok ? make_key(float_order(s + 0.0f), row0 + r) : 0ull;
        bool take = key > thr;
        while (true) {
          const unsigned b = __ballot_sync(0xffffffffu, take);
          if (b == 0) break;
          const int room = cap - n, rank = __popc(b & lower);
          if (take && rank < room) {
            list[n + rank] = key;
            take = false;
          }
          if (__popc(b) <= room) {
            n += __popc(b);
            break;
          }
          __syncwarp();
          thr = warp_compact(list, cap, k);
          n = k;
          take = take && key > thr;
        }
      }
      __syncwarp();
      if (lane == 0) {
        tau[i] = thr;
        cnt[i] = n;
      }
    }
  }

  // each (query, range) list as it stands, zero-filled to cap keys
  __syncwarp();
  for (int i = warp; i < qn; i += kConsumers / 32) {
    u64* list = cand + (static_cast<size_t>(q0 + i) * nranges + range) * cap;
    for (int j = cnt[i] + lane; j < cap; j += 32) list[j] = 0ull;
  }
}

template <bool kInt4, int QT>
cudaError_t launch(const CUtensorMap& tmap_m, const CUtensorMap& tmap_s, const CUtensorMap& tmap_scale,
                   const int8_t* q, const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep,
                   int k, int ranges, int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  const int halves = kInt4 ? 2 : 1;
  const int byte_rows = kInt4 ? d / 2 : d;
  const int brpad = (byte_rows + kBoxRows - 1) / kBoxRows * kBoxRows;
  // two blocks an SM where three stages fit beside each other, else one
  int stages = kMaxStages;
  while (stages >= 3 && plan_smem(QT, halves, brpad, stages) > kTwoPerSm) --stages;
  if (stages < 3) {
    stages = kMaxStages;
    while (stages >= 2 && plan_smem(QT, halves, brpad, stages) > kSmemMax) --stages;
    if (stages < 2) return cudaErrorInvalidValue;
  }
  const size_t smem = plan_smem(QT, halves, brpad, stages);
  cudaError_t err = allow_smem<scan_flat_cols<kInt4, QT>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + QT - 1) / QT, ranges);
  scan_flat_cols<kInt4, QT><<<grid, kConsumers + 32, smem, s>>>(tmap_m, tmap_s, tmap_scale, q, qscale, allowed,
                                                                  n_filter, nq, d, n_sweep, k, cap, rows_per_range,
                                                                  ranges, stages, cand);
  return cudaGetLastError();
}

template <bool kInt4>
cudaError_t launch_cores(int qt, const CUtensorMap& m, const CUtensorMap& sm, const CUtensorMap& sc, const int8_t* q,
                         const float* qs, const int* al, int nf, int nq, int d, int ns, int k, int ranges, int rpr,
                         int cap, u64* cand, cudaStream_t s) {
  switch (qt) {
    case 1: return launch<kInt4, 1>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 2: return launch<kInt4, 2>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 4: return launch<kInt4, 4>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 8: return launch<kInt4, 8>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 16: return launch<kInt4, 16>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    default: return cudaErrorInvalidValue;
  }
}

// Both C entries: K7 (the (d, ld) int8 companion) and K9 flat (the packed
// (d/2, ld) matrix, d the queries' width), with (ld,) f32 row scales and
// int8 queries (nq, d) with (nq,) f32 scales; ld a multiple of 16 (TMA
// strides are), d a multiple of 16 (int8) or 32 (int4); matrix, scales and
// src 16-byte aligned.  The launch plan comes from the wrapper (ops/topk.py
// `flat_cols_plan`): qt queries a block (1, 2, 4, 8 or 16 on the CUDA
// cores; 64 or 128 on the tensor cores, d a multiple of 128 only),
// `ranges` row ranges of rows_per_range rows (a multiple of 128) covering
// n_sweep, each (query, range) list's capacity cap (64 keys for k <= 32,
// else more than k), and multi: pass 2 by the multi-block select.
// Workspace: nq * ranges * cap * 8 bytes of lists, then with multi
// perceive_keys_select_workspace(nq, k) bytes.
template <bool kInt4>
int scan_flat(const void* m, int ld, const float* scales, const int* src, const void* q, const float* qscale,
              const int* allowed, int n_filter, int nq, int d, int n_sweep, int k, int qt, int ranges,
              int rows_per_range, int cap, int multi, float* vals, int* rows, void* workspace, void* stream) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || d % (kInt4 ? 32 : 16) || ld % 16 || n_sweep > ld ||
      scales == nullptr || qscale == nullptr || !list_plan_ok(n_sweep, k, ranges, rows_per_range, cap, kRowTile) ||
      (reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(src) |
       reinterpret_cast<uintptr_t>(workspace)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* cand = static_cast<u64*>(workspace);
  cudaError_t err;
  if (qt == 64 || qt == 128) {
    err = scan_s8_cols_wgmma_lists(kInt4, m, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qt,
                                   ranges, rows_per_range, cap, cand, s);
  } else {
    CUtensorMap tmap_m, tmap_s, tmap_scale;
    if (!make_map_2d(&tmap_m, CU_TENSOR_MAP_DATA_TYPE_UINT8, m, n_sweep, kInt4 ? d / 2 : d, ld, kRowTile, kBoxRows,
                     CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map_1d(&tmap_s, CU_TENSOR_MAP_DATA_TYPE_INT32, src, n_sweep, kRowTile) ||
        !make_map_1d(&tmap_scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, n_sweep, kRowTile))
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_cores<kInt4>(qt, tmap_m, tmap_s, tmap_scale, static_cast<const int8_t*>(q), qscale, allowed,
                              n_filter, nq, d, n_sweep, k, ranges, rows_per_range, cap, cand, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_lists_pass2(cand, nq, ranges * cap, k, multi, vals, rows, s));
}

}  // namespace

extern "C" {

// Scratch bytes of the multi-block pass 2 (hopper_common.cuh
// `launch_keys_select`) for nq queries at depth k, past the lists.
size_t perceive_keys_select_workspace(int nq, int k) { return keys_select_bytes(nq, k); }

// K7: the int2 tier's (d, ld) int8 companion (scan_flat).
int perceive_scan_flat_int8t(const void* m8t, int ld, const float* scales, const int* src, const void* q,
                             const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                             int qt, int ranges, int rows_per_range, int cap, int multi, float* vals, int* rows,
                             void* workspace, void* stream) {
  return scan_flat<false>(m8t, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qt, ranges,
                          rows_per_range, cap, multi, vals, rows, workspace, stream);
}

// K9 flat: the packed (d/2, ld) int4 matrix (scan_flat).
int perceive_scan_flat_int4(const void* m4t, int ld, const float* scales, const int* src, const void* q,
                            const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                            int qt, int ranges, int rows_per_range, int cap, int multi, float* vals, int* rows,
                            void* workspace, void* stream) {
  return scan_flat<true>(m4t, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qt, ranges,
                         rows_per_range, cap, multi, vals, rows, workspace, stream);
}

}  // extern "C"
