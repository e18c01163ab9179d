// K2: exact scan with top-k selection over a bf16 matrix for batches of
// queries (sweeps of at least 256), a kernel of its own for Hopper.  Its
// pass 1 also serves K1 (scan_flat_bf16.cu) for bf16 sweeps wider than
// FLAT_CORE_QUERIES (ops/topk.py), with a tile of 64 queries
// (`scan_bf16_wgmma_lists`).
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

constexpr int kDimBox = 64;                       // dims a TMA box: 128 bytes, the swizzle span
constexpr int kRowTile = 128;                     // rows a wgmma tile (n = 128)
constexpr int kWgQueries = 64;                    // queries a consumer warpgroup (m = 64)
constexpr int kBoxBytes = kRowTile * kDimBox * 2;  // one ring stage: 16 KiB
constexpr int kMaxStages = 7;                     // ring stages, as many as fit up to this
constexpr int kSrcAhead = 2;                      // tiles whose source ids load ahead of their rows
constexpr int kSrcSlots = kSrcAhead + kMaxStages;  // >= kSrcAhead + ceil(stages / boxes a tile)

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
    mbar_init_fence();
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

    append_tile(acc, valid, row0, qa, qb, qn, wq0, tau, cnt, list_of, k, cap);
  }
  finish_lists(wq0, qn, cnt, list_of, cap);
}

// -- host side ------------------------------------------------------------------

size_t plan_smem(int d, int nwg, int stages) {
  const int qrows = nwg * kWgQueries;
  return 1024 + static_cast<size_t>(d) * 2 * qrows + static_cast<size_t>(stages) * kBoxBytes + kSrcSlots * kRowTile * 4 +
         static_cast<size_t>(qrows) * 12 + static_cast<size_t>(2 * stages + 1 + kSrcSlots) * 8 + kMaxFilter * 4;
}

}  // namespace

cudaError_t scan_bf16_wgmma_lists(const void* matrix, const int* src, const void* q, const int* allowed,
                                  int n_filter, int nq, int d, int n_sweep, int k, int qrows, int ranges,
                                  int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || d % kDimBox || (qrows != 64 && qrows != 128) ||
      !list_plan_ok(n_sweep, k, ranges, rows_per_range, cap, kRowTile) ||
      (reinterpret_cast<uintptr_t>(matrix) | reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(src)) % 16)
    return cudaErrorInvalidValue;
  const int nwg = qrows / kWgQueries;
  int stages = kMaxStages;
  while (stages >= 2 && plan_smem(d, nwg, stages) > kSmemMax) --stages;
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = plan_smem(d, nwg, stages);
  CUtensorMap tmap_m, tmap_q, tmap_s;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map_2d(&tmap_m, bf16, matrix, d, n_sweep, 2ull * d, kDimBox, kRowTile, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tmap_q, bf16, q, d, nq, 2ull * d, kDimBox, qrows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_1d(&tmap_s, CU_TENSOR_MAP_DATA_TYPE_INT32, src, n_sweep, kRowTile))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<scan_slab_bf16>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + qrows - 1) / qrows, ranges);
  scan_slab_bf16<<<grid, qrows * 2 + 32, smem, s>>>(tmap_m, tmap_q, tmap_s, allowed, n_filter, nq, d, n_sweep, k, cap,
                                                   rows_per_range, ranges, stages, nwg, cand);
  return cudaGetLastError();
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


}  // extern "C"
