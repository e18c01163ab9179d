// The batch scans over row-major matrices, one kernel for Hopper templated
// on the operand type: K2 (bf16) and K4 (int8 with row scales), exact scans
// with top-k selection for batches of queries (sweeps of at least 256).
// Their pass 1 also serves K1 and K3 (scan_flat_rows.cu) for sweeps wider
// than FLAT_ROWS_CORE_QUERIES (ops/topk.py), with a tile of 64 queries
// (`scan_bf16_wgmma_lists`, `scan_s8_rows_wgmma_lists`).
//
// Replaces the TPU kernels perceive_tpu/ops/topk.py `pallas_topk_slabbed`
// (`_scan_kernel_slabbed`: top-k of q . matrix^T) and
// `pallas_topk_int8_slabbed` (`_scan_kernel_int8_slabbed`: top-k of
// f32(int32 dot) * row scale * query scale, rounded in that order
// (__fmul_rn), bit for bit with the plain version, ops/topk.py
// `scores_int8`), over rows [0, n_sweep), rows whose source id is -1 or
// outside `allowed` excluded, ties to the lower row, every comparison by the
// unique (score, ~row) keys of topk_common.cuh.
//
// What bounds them on the H100: operations.  At Q = 512 a 958,464 x 384
// bf16 sweep is 3.8e11 flop (0.36 ms at 989 TFLOP/s) against 0.74 GB of
// matrix (0.22 ms at 3.35 TB/s); a 2,064,384 x 384 int8 sweep 8.1e11 int8
// operations (0.41 ms at 1,979 TOP/s) against 0.80 GB (0.24 ms).  The first
// versions lost to one matmul + topk: one block per (64 queries, 512 rows)
// ran a warp select per query over every 512 scores and wrote min(k, 512)
// keys per query and block for pass 2; at int8 (K4's first kernel,
// mma.sync without TMA) the workspace split a sweep of 2,048 queries at k =
// 128 into launches that each re-read the matrix, and its grid's y
// dimension, the row block, refused sweeps past 33,553,920 rows.
//
// Design.  Pass 1 is persistent and threshold-pruned, like the TPU kernel's
// `_merge_tile_topk`, which merges a tile only while it beats the running
// buffer:
//   * about one block per SM: (query tiles) x (row ranges) ~ the SM count,
//     no grid dimension grows with the rows; a block keeps its query tile
//     (128 queries, two consumer warpgroups of 64; at bf16 64 and one
//     warpgroup where 128 do not fit) resident in shared memory and walks
//     one contiguous row range in tiles of 128 rows; blocks of one range
//     are launched side by side, so its rows come from L2 for all but the
//     first;
//   * a producer warp streams each row tile as 128-byte boxes (128 rows x
//     64 bf16 or 128 int8 dims, 128-byte swizzle) through a ring of
//     shared-memory stages by TMA, completion on mbarriers; the tensor
//     maps are encoded on the host through cudaGetDriverEntryPoint, so
//     nothing links libcuda.  Int8 rows are K-major as they are stored,
//     which is what wgmma needs of 8-bit operands: no decode pass;
//   * the consumer warpgroups score each box with wgmma straight from the
//     ring (bf16: m64n128k16 -> f32; int8: m64n128k32 s8 -> s32, exact),
//     A = queries, B = rows, both from shared memory;
//   * each tile's source ids (and at int8 its row scales) come by TMA too,
//     two tiles ahead, and each consumer warp turns the ids into
//     row-validity bits with four ballots;
//   * the epilogue (at int8 after scaling each dot, hopper_common.cuh
//     `scale_tile`): each query keeps a running threshold tau (the k-th
//     best key so far) and a candidate list in the workspace (it stays in
//     L2): 64 keys for k <= 32, 2k past that.  A score screens against
//     tau's score in registers (64 compares a thread, no branches); a key
//     that beats tau is appended (a shared-memory atomic gives the slot),
//     each lane taking its candidates by predicated selects so that no lane
//     diverges into another's; when a list fills, its warp keeps the top k
//     (up to k = 32 a bitonic sort of the 64 keys in registers, past it a
//     bitwise search for the k-th key) and raises tau.  On random data
//     that is ~k ln(rows / k) appends a query and range instead of a select
//     over every row;
//   * at the end each block writes its lists as they stand (the range's
//     top k among them), cap keys a query: (ranges) x cap x 8 bytes a query
//     (about 17 KB at Q = 512, k = 32), and hopper_common.cuh's list_pass2
//     selects over them.
// What holds it back: the two warpgroups consume the same boxes in step,
// so each tile's epilogue (~k ln(rows / k) appends a query, and the
// compactions) runs between the tile's products instead of beside them;
// a stage is released only when both warpgroups are done with it, so one
// warpgroup's epilogue also stalls the other's products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kRowTile = 128;                     // rows a wgmma tile (n = 128)
constexpr int kWgQueries = 64;                    // queries a consumer warpgroup (m = 64)
constexpr int kBoxBytes = kRowTile * 128;         // one ring stage: 128 rows x 128 bytes, 16 KiB
constexpr int kMaxStages = 7;                     // ring stages, as many as fit up to this
constexpr int kSrcAhead = 2;                      // tiles whose source ids load ahead of their rows

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

// The operand types.  A box is 128 bytes of each row, which the four
// wgmma k-steps of 32 bytes consume (descriptor + 2 a step).
struct Bf16Rows {  // K2: no scales; a tile's ids are read at its first box
  typedef float Acc;
  static constexpr bool kScaled = false;
  static constexpr int kElem = 2;
  static constexpr int kSrcSlots = kSrcAhead + kMaxStages;  // >= kSrcAhead + ceil(stages / boxes a tile)
  __device__ __forceinline__ static void box(float* acc, uint64_t da, uint64_t db, int first) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, first | kk);
  }
};

struct S8Rows {  // K4: row scales beside the ids, read in the tile's epilogue
  typedef int Acc;
  static constexpr bool kScaled = true;
  static constexpr int kElem = 1;
  // when box (tile, 0) may load, the consumers have released box (tile, 0)
  // - stages, so every epilogue up to tile - ceil(stages / boxes) - 1 is
  // done: reuse kSrcSlots back is safe from 3 + ceil(stages / boxes) slots
  static constexpr int kSrcSlots = kSrcAhead + kMaxStages + 2;
  __device__ __forceinline__ static void box(int* acc, uint64_t da, uint64_t db, int first) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, first | kk);
  }
};

// Grid (query tiles, row ranges); block: nwg consumer warpgroups + one
// producer warp.  cand[q][range][cap]: each (query, range)'s candidate
// list, kept there while the block runs.  tmap_scale and qscale are read
// at int8 only.
template <class Op>
__global__ void __launch_bounds__(2 * 128 + 32, 1) scan_slab_rows(
    const __grid_constant__ CUtensorMap tmap_m, const __grid_constant__ CUtensorMap tmap_q,
    const __grid_constant__ CUtensorMap tmap_s, const __grid_constant__ CUtensorMap tmap_scale,
    const float* __restrict__ qscale, const int* __restrict__ allowed, int n_filter, int nq, int d,
    int n_sweep, int k, int cap, int rows_per_range, int nranges, int stages, int nwg,
    u64* __restrict__ cand) {
  constexpr int kSrcSlots = Op::kSrcSlots;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int nbox = d * Op::kElem / 128;
  const int qrows = nwg * kWgQueries;
  unsigned char* qs = base;                                           // [nbox][qrows][128 B]
  unsigned char* ring = qs + static_cast<size_t>(nbox) * qrows * 128;  // [stages][128 rows][128 B]
  int* src_ring = reinterpret_cast<int*>(ring + static_cast<size_t>(stages) * kBoxBytes);  // [kSrcSlots][128]
  float* scl_ring = reinterpret_cast<float*>(src_ring + kSrcSlots * kRowTile);  // int8: [kSrcSlots][128]
  float* qsc = scl_ring + (Op::kScaled ? kSrcSlots * kRowTile : 0);              // int8: [qrows]
  u64* tau = reinterpret_cast<u64*>(qsc + (Op::kScaled ? qrows : 0));            // [qrows]
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
    if constexpr (Op::kScaled) qsc[tid] = tid < qn ? qscale[q0 + tid] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, nwg * 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    for (int s = 0; s < kSrcSlots; ++s) mbar_init(src_full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == nwg * 4) {
    // producer: the query tile once, then every row tile box by box
    if (lane == 0) {
      mbar_expect_tx(qbar, static_cast<uint32_t>(nbox) * qrows * 128);
      for (int c = 0; c < nbox; ++c)
        tma_load(qs + static_cast<size_t>(c) * qrows * 128, &tmap_q, c * 128 / Op::kElem, q0, qbar);
      // a tile's source ids (and scales) load kSrcAhead tiles ahead of its
      // rows; slot reuse kSrcSlots back is safe (the operand types' notes)
      auto load_src = [&](int t) {
        uint64_t* bar = src_full + t % kSrcSlots;
        mbar_expect_tx(bar, kRowTile * (Op::kScaled ? 8 : 4));
        tma_load_1d(src_ring + (t % kSrcSlots) * kRowTile, &tmap_s, row_lo + t * kRowTile, bar);
        if constexpr (Op::kScaled)
          tma_load_1d(scl_ring + (t % kSrcSlots) * kRowTile, &tmap_scale, row_lo + t * kRowTile, bar);
      };
      for (int t = 0; t < kSrcAhead && t < n_tiles; ++t) load_src(t);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < n_tiles; ++tile) {
        for (int c = 0; c < nbox; ++c) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, kBoxBytes);
          tma_load(ring + stage * kBoxBytes, &tmap_m, c * 128 / Op::kElem, row_lo + tile * kRowTile, full + stage);
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
  const unsigned char* qa_tile = qs + wg * kWgQueries * 128;
  const bool allow_all = allow[0] == kAllowAll;
  mbar_wait(qbar, 0);

  typename Op::Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row0 = row_lo + tile * kRowTile;
    const int slot = tile % kSrcSlots;
    uint32_t valid = 0;  // rows 8j + 2t + e of the tile: bit 2j + e
    for (int c = 0; c < nbox; ++c) {
      mbar_wait(full + stage, phase);
      if (c == 0) {
        mbar_wait(src_full + slot, (tile / kSrcSlots) & 1);
        valid = tile_valid(src_ring + slot * kRowTile, row_hi - row0, allow, allow_all ? 0 : n_filter, t);
      }
      wgmma_fence();
      Op::box(acc, smem_desc(qa_tile + static_cast<size_t>(c) * qrows * 128), smem_desc(ring + stage * kBoxBytes), c);
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if constexpr (Op::kScaled) {
      float sc[64];
      scale_tile(acc, scl_ring + slot * kRowTile, qsc[qa], qsc[qb], t, sc);
      append_tile(sc, valid, row0, qa, qb, qn, wq0, tau, cnt, list_of, k, cap);
    } else {
      append_tile(acc, valid, row0, qa, qb, qn, wq0, tau, cnt, list_of, k, cap);
    }
  }
  finish_lists(wq0, qn, cnt, list_of, cap);
}

// -- host side ------------------------------------------------------------------

template <class Op>
size_t plan_smem(int d, int nwg, int stages) {
  const int qrows = nwg * kWgQueries;
  const size_t per_slot = kRowTile * (Op::kScaled ? 8 : 4);
  return 1024 + static_cast<size_t>(d) * Op::kElem * qrows + static_cast<size_t>(stages) * kBoxBytes +
         Op::kSrcSlots * per_slot + static_cast<size_t>(qrows) * (Op::kScaled ? 16 : 12) +
         static_cast<size_t>(2 * stages + 1 + Op::kSrcSlots) * 8 + kMaxFilter * 4;
}

// Pass 1 of K2 or K4 into cand: matrix (n, d) and queries (nq, d) of the
// operand type, row scales and query scales at int8 (else null).
template <class Op>
cudaError_t scan_rows_lists(const void* matrix, const float* scales, const int* src, const void* q,
                            const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep,
                            int k, int qrows, int ranges, int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || (d * Op::kElem) % 128 || (qrows != 64 && qrows != 128) ||
      !list_plan_ok(n_sweep, k, ranges, rows_per_range, cap, kRowTile) ||
      (reinterpret_cast<uintptr_t>(matrix) | reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(src) |
       reinterpret_cast<uintptr_t>(scales)) % 16 ||
      (Op::kScaled && (scales == nullptr || qscale == nullptr)))
    return cudaErrorInvalidValue;
  const int nwg = qrows / kWgQueries;
  int stages = kMaxStages;
  while (stages >= 2 && plan_smem<Op>(d, nwg, stages) > kSmemMax) --stages;
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = plan_smem<Op>(d, nwg, stages);
  CUtensorMap tmap_m, tmap_q, tmap_s, tmap_scale;
  const CUtensorMapDataType type = Op::kScaled ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t box = 128 / Op::kElem;
  const uint64_t row_bytes = static_cast<uint64_t>(d) * Op::kElem;
  if (!make_map_2d(&tmap_m, type, matrix, d, n_sweep, row_bytes, box, kRowTile, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tmap_q, type, q, d, nq, row_bytes, box, qrows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_1d(&tmap_s, CU_TENSOR_MAP_DATA_TYPE_INT32, src, n_sweep, kRowTile))
    return cudaErrorInvalidValue;
  tmap_scale = tmap_s;  // read at int8 only
  if (Op::kScaled && !make_map_1d(&tmap_scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, n_sweep, kRowTile))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<scan_slab_rows<Op>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + qrows - 1) / qrows, ranges);
  scan_slab_rows<Op><<<grid, qrows * 2 + 32, smem, s>>>(tmap_m, tmap_q, tmap_s, tmap_scale, qscale, allowed,
                                                       n_filter, nq, d, n_sweep, k, cap, rows_per_range, ranges,
                                                       stages, nwg, cand);
  return cudaGetLastError();
}

}  // namespace

cudaError_t scan_bf16_wgmma_lists(const void* matrix, const int* src, const void* q, const int* allowed,
                                  int n_filter, int nq, int d, int n_sweep, int k, int qrows, int ranges,
                                  int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  return scan_rows_lists<Bf16Rows>(matrix, nullptr, src, q, nullptr, allowed, n_filter, nq, d, n_sweep, k, qrows,
                                   ranges, rows_per_range, cap, cand, s);
}

cudaError_t scan_s8_rows_wgmma_lists(const void* matrix, const float* scales, const int* src, const void* q,
                                     const float* qscale, const int* allowed, int n_filter, int nq, int d,
                                     int n_sweep, int k, int qrows, int ranges, int rows_per_range, int cap,
                                     u64* cand, cudaStream_t s) {
  return scan_rows_lists<S8Rows>(matrix, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qrows, ranges,
                                 rows_per_range, cap, cand, s);
}

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* cand = static_cast<u64*>(workspace);
  const cudaError_t err = scan_bf16_wgmma_lists(matrix, src, q, allowed, n_filter, nq, d, n_sweep, k, qrows, ranges,
                                                rows_per_range, cap, cand, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_list_pass2(cand, nq, ranges * cap, k, vals, rows, s));
}

// K4: int8 (n, d) matrix with (n,) f32 row scales, int8 (nq, d) queries
// with (nq,) f32 scales; d a multiple of 128; matrix, scales, src and q
// 16-byte aligned.  The launch plan comes from the wrapper (ops/topk.py
// `slab_s8_plan`), as K2's with qrows 128 at every d.  Workspace: nq *
// ranges * cap * 8 bytes.
int perceive_scan_topk_slab(const void* matrix, const float* scales, const int* src, const void* q,
                            const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                            int qrows, int ranges, int rows_per_range, int cap, float* vals, int* rows,
                            void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* cand = static_cast<u64*>(workspace);
  const cudaError_t err = scan_s8_rows_wgmma_lists(matrix, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep,
                                                   k, qrows, ranges, rows_per_range, cap, cand, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_list_pass2(cand, nq, ranges * cap, k, vals, rows, s));
}

}  // extern "C"
