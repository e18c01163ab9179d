// K1: exact scan with top-k selection over a bf16 or f32 matrix for fewer
// than 256 queries (every text query, and every executor drain of fewer
// than 256), a kernel of its own for Hopper.
//
// Replaces the TPU kernel perceive_tpu/ops/topk.py `pallas_topk_unsorted`
// (`_scan_kernel` + `_merge_tile_topk`): top-k of q . matrix^T over rows
// [0, n_sweep), rows whose source id is -1 or outside `allowed` excluded,
// ties to the lower row, every comparison by the unique (score, ~row) keys
// of topk_common.cuh.  Products accumulate in f32.
//
// What bounds it on the H100: device-memory bytes.  At Q = 1 a 958,464 x
// 384 bf16 sweep reads 736 MB (0.22 ms at 3.35 TB/s) for 0.7 GFLOP.  The
// first version (scan_topk.cu) took 0.63 ms: a warp streamed one row at a
// time with one or two 16-byte loads a lane (few bytes in flight), re-read
// the matrix for every 16 queries, ran a select over every 512-row block
// and finished with one block per query over all blocks' candidates.
//
// Design.  Persistent blocks over contiguous row ranges, threshold-pruned
// like the TPU kernel's `_merge_tile_topk`:
//   * (query tiles) x (row ranges) ~ two blocks per SM on the CUDA cores,
//     one on the tensor cores; blocks of one range launch side by side, so
//     the range comes from device memory once;
//   * a producer warp streams each 128-row tile as boxes of 128 bytes of
//     every row (64 bf16 or 32 f32 dims, 128-byte swizzle) by TMA through
//     a ring of shared-memory stages, the tile's source ids two tiles
//     ahead, completion on mbarriers;
//   * on the CUDA cores (every f32 sweep, and bf16 sweeps of at most
//     FLAT_CORE_QUERIES, ops/topk.py), up to 16 queries a block: one
//     consumer warpgroup scores each tile into a shared-memory score tile
//     with f32 FMAs, a thread a row, the queries in shared memory as f32
//     (the swizzle puts the 8 rows of a quarter-warp on 8 distinct
//     chunks); the epilogue keeps a running threshold tau and a candidate
//     list per (query, range) (hopper_common.cuh): one warp owns each
//     query, so appends take ballots and compactions no barrier.  At Q = 1
//     almost no row passes tau after the first tiles;
//   * on the tensor cores (bf16, more queries, d a multiple of 64), K2's
//     pass 1 (scan_slab_rows.cu: wgmma m64n128k16 with the query tile
//     resident) with a tile of 64 queries, or 128 past 64 queries, so that
//     a sweep of up to 64 queries reads each row once;
//   * pass 2 (hopper_common.cuh `list_pass2`) selects over ranges x cap keys a
//     query, staged in shared memory where they fit.
// What holds it back: on the CUDA cores a block's consumer warpgroup
// alternates scoring and the epilogue, and the score tile costs a barrier
// a tile.  Pass 2 is one block a query: past k = 512 at ~2M rows and more
// (ranges x 2k keys) it is the larger part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kRowTile = 128;             // rows a tile
constexpr int kBoxBytes = kRowTile * 128;  // a ring stage: 128 bytes of 128 rows
constexpr int kConsumers = 128;           // one consumer warpgroup
constexpr int kScPitch = kRowTile + 8;    // floats a query's row of the score tile
constexpr int kMaxStages = 8;
constexpr int kSrcAhead = 2;                       // tiles whose source ids load ahead of their rows
constexpr int kSrcSlots = kSrcAhead + kMaxStages;  // >= kSrcAhead + ceil(stages / boxes a tile)
constexpr size_t kTwoPerSm = 115712;               // the most a block may take for two to share an SM

template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;  // values in 16 bytes
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void widen(const uint4& v, float* x) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
};
template <> struct Elem<float> {
  static constexpr int kPerChunk = 4;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ __forceinline__ static void widen(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static float to_float(float v) { return v; }
};

// The shared-memory bytes of a launch (layout in scan_flat, in this order):
// the query tile holds every dim of its queries as f32.
inline size_t plan_smem(int qt, int nbox, int elem, int stages) {
  return 1024 + static_cast<size_t>(stages) * kBoxBytes + kSrcSlots * kRowTile * 4 +
         static_cast<size_t>(qt) * nbox * (128 / elem) * 4 + 2ull * qt * kScPitch * 4 + static_cast<size_t>(qt) * 12 +
         8 + static_cast<size_t>(2 * stages + kSrcSlots) * 8 + kMaxFilter * 4;
}

// Grid (query tiles of QT, row ranges); block: one consumer warpgroup + one
// producer warp.  cand[q][range][cap]: each (query, range)'s candidate
// list, kept there while the block runs.
template <typename T, int QT>
__global__ void __launch_bounds__(kConsumers + 32, 2) scan_flat(
    const __grid_constant__ CUtensorMap tmap_m, const __grid_constant__ CUtensorMap tmap_s,
    const T* __restrict__ q, const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int k,
    int cap, int rows_per_range, int nranges, int stages, u64* __restrict__ cand) {
  constexpr int E = 128 / sizeof(T);  // dims a box
  constexpr int V = Elem<T>::kPerChunk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int nbox = (d + E - 1) / E;
  const int dpad = nbox * E;
  // the TMA destinations first: the ring 1024-byte aligned (the swizzle), the ids 128
  unsigned char* ring = base;                                                    // [stages][128 rows][128 B]
  int* src_ring = reinterpret_cast<int*>(ring + static_cast<size_t>(stages) * kBoxBytes);  // [kSrcSlots][128]
  float* qs = reinterpret_cast<float*>(src_ring + kSrcSlots * kRowTile);                   // [QT][dpad]
  float* sc = qs + QT * dpad;                                                               // [2][QT][kScPitch]
  u64* tau = reinterpret_cast<u64*>(sc + 2 * QT * kScPitch);                                // [QT]
  int* cnt = reinterpret_cast<int*>(tau + QT);                              // [QT]
  uint64_t* full = reinterpret_cast<uint64_t*>(cnt + QT + (QT & 1));        // [stages]
  uint64_t* empty = full + stages;                                          // [stages]
  uint64_t* src_full = empty + stages;                                      // [kSrcSlots]
  int* allow = reinterpret_cast<int*>(src_full + kSrcSlots);                // [kMaxFilter]

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
    // producer: every row tile box by box; a tile's source ids load
    // kSrcAhead tiles ahead of its rows (slot reuse as in K2)
    if (lane == 0) {
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
          tma_load(ring + stage * kBoxBytes, &tmap_m, c * E, row_lo + tile * kRowTile, full + stage);
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

  // consumers: stage the query tile as f32 (zeros past nq and past d)
  for (int i = tid; i < QT * dpad; i += kConsumers) {
    const int r = i / dpad, dim = i - r * dpad;
    qs[i] = r < qn && dim < d ? Elem<T>::to_float(q[static_cast<size_t>(q0 + r) * d + dim]) : 0.f;
  }
  named_barrier(1, kConsumers);

  const unsigned lower = (1u << lane) - 1u;
  int stage = 0;
  uint32_t phase = 0;
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  };

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row0 = row_lo + tile * kRowTile;
    const int rows = row_hi - row0;
    float* scb = sc + (tile & 1) * QT * kScPitch;
    const int slot = tile % kSrcSlots;
    const int* ids = src_ring + slot * kRowTile;
    // thread r scores tile row r for every query of the tile
    const int r = tid;
    float acc[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) acc[i] = 0.f;
    bool ok = false;
    for (int c = 0; c < nbox; ++c) {
      mbar_wait(full + stage, phase);
      if (c == 0) {
        mbar_wait(src_full + slot, (tile / kSrcSlots) & 1);
        ok = r < rows && row_allowed(ids[r], allow, n_filter);
      }
      const unsigned char* box = ring + stage * kBoxBytes;
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        float x[V];
        Elem<T>::widen(*reinterpret_cast<const uint4*>(box + swz128(r, 16 * h)), x);
        const float* qp = qs + c * E + h * V;
#pragma unroll
        for (int i = 0; i < QT; ++i) {
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 w = *reinterpret_cast<const float4*>(qp + i * dpad + e);
            acc[i] = fmaf(x[e], w.x, acc[i]);
            acc[i] = fmaf(x[e + 1], w.y, acc[i]);
            acc[i] = fmaf(x[e + 2], w.z, acc[i]);
            acc[i] = fmaf(x[e + 3], w.w, acc[i]);
          }
        }
      }
      release();
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) scb[i * kScPitch + r] = ok ? acc[i] : -INFINITY;
    // the score tile is whole; the other buffer, last read a tile ago, is free
    named_barrier(1, kConsumers);

    // epilogue: warp w owns queries w, w + 4, ...; a key that beats tau is
    // appended (ballot ranks give the slots); a full list keeps its top k
    for (int i = warp; i < qn; i += kConsumers / 32) {
      u64* list = cand + (static_cast<size_t>(q0 + i) * nranges + range) * cap;
      u64 thr = tau[i];
      int n = cnt[i];
#pragma unroll
      for (int m = 0; m < kRowTile / 32; ++m) {
        const int r = 32 * m + lane;
        const float s = scb[i * kScPitch + r];
        const u64 key = s != -INFINITY ? make_key(float_order(s + 0.0f), row0 + r) : 0ull;
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

template <typename T, int QT>
cudaError_t launch(const CUtensorMap& tmap_m, const CUtensorMap& tmap_s, const void* q, const int* allowed,
                   int n_filter, int nq, int d, int n_sweep, int k, int ranges, int rows_per_range, int cap,
                   u64* cand, cudaStream_t s) {
  const int nbox = (d * static_cast<int>(sizeof(T)) + 127) / 128;
  // two blocks an SM where three stages fit beside each other, else one
  int stages = kMaxStages;
  while (stages >= 3 && plan_smem(QT, nbox, sizeof(T), stages) > kTwoPerSm) --stages;
  if (stages < 3) {
    stages = kMaxStages;
    while (stages >= 2 && plan_smem(QT, nbox, sizeof(T), stages) > kSmemMax) --stages;
    if (stages < 2) return cudaErrorInvalidValue;
  }
  const size_t smem = plan_smem(QT, nbox, sizeof(T), stages);
  cudaError_t err = allow_smem<scan_flat<T, QT>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + QT - 1) / QT, ranges);
  scan_flat<T, QT><<<grid, kConsumers + 32, smem, s>>>(tmap_m, tmap_s, static_cast<const T*>(q), allowed,
                                                             n_filter, nq, d, n_sweep, k, cap, rows_per_range,
                                                             ranges, stages, cand);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(int qt, const CUtensorMap& m, const CUtensorMap& sm, const void* q, const int* allowed,
                       int n_filter, int nq, int d, int n_sweep, int k, int ranges, int rpr, int cap, u64* cand,
                       cudaStream_t s) {
  switch (qt) {
    case 1: return launch<T, 1>(m, sm, q, allowed, n_filter, nq, d, n_sweep, k, ranges, rpr, cap, cand, s);
    case 2: return launch<T, 2>(m, sm, q, allowed, n_filter, nq, d, n_sweep, k, ranges, rpr, cap, cand, s);
    case 4: return launch<T, 4>(m, sm, q, allowed, n_filter, nq, d, n_sweep, k, ranges, rpr, cap, cand, s);
    case 8: return launch<T, 8>(m, sm, q, allowed, n_filter, nq, d, n_sweep, k, ranges, rpr, cap, cand, s);
    case 16: return launch<T, 16>(m, sm, q, allowed, n_filter, nq, d, n_sweep, k, ranges, rpr, cap, cand, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1.  dtype: 0 = float32, 1 = bfloat16 (matrix and queries alike); rows
// of a multiple of 16 bytes; matrix, src and q 16-byte aligned.  The
// launch plan comes from the wrapper (ops/topk.py `flat_bf16_plan`): qt
// queries a block (1, 2, 4, 8 or 16 on the CUDA cores; 64 or 128 on the
// tensor cores, bf16 with d a multiple of 64 only), `ranges` row ranges of
// rows_per_range rows (a multiple of 128) covering n_sweep, and each
// (query, range) list's capacity cap: 64 keys for k <= 32, else more than
// k.  Workspace: nq * ranges * cap * 8 bytes, the lists themselves.
int perceive_scan_flat_bf16(const void* matrix, int dtype, const int* src, const void* q, const int* allowed,
                            int n_filter, int nq, int d, int n_sweep, int k, int qt, int ranges, int rows_per_range,
                            int cap, float* vals, int* rows, void* workspace, void* stream) {
  const size_t elem = dtype == 1 ? 2 : 4;
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || (dtype != 0 && dtype != 1) || (d * elem) % 16 ||
      !list_plan_ok(n_sweep, k, ranges, rows_per_range, cap, kRowTile) ||
      (reinterpret_cast<uintptr_t>(matrix) | reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(src)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* cand = static_cast<u64*>(workspace);
  cudaError_t err;
  if (qt == 64 || qt == 128) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    err = scan_bf16_wgmma_lists(matrix, src, q, allowed, n_filter, nq, d, n_sweep, k, qt, ranges, rows_per_range, cap,
                                cand, s);
  } else {
    CUtensorMap tmap_m, tmap_s;
    const CUtensorMapDataType type = dtype == 1 ? Elem<__nv_bfloat16>::kMap : Elem<float>::kMap;
    if (!make_map_2d(&tmap_m, type, matrix, d, n_sweep, d * elem, static_cast<uint32_t>(128 / elem), kRowTile,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_1d(&tmap_s, CU_TENSOR_MAP_DATA_TYPE_INT32, src, n_sweep, kRowTile))
      return static_cast<int>(cudaErrorInvalidValue);
    err = dtype == 0 ? launch_fma<float>(qt, tmap_m, tmap_s, q, allowed, n_filter, nq, d, n_sweep, k, ranges,
                                         rows_per_range, cap, cand, s)
                     : launch_fma<__nv_bfloat16>(qt, tmap_m, tmap_s, q, allowed, n_filter, nq, d, n_sweep, k, ranges,
                                                 rows_per_range, cap, cand, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_list_pass2(cand, nq, ranges * cap, k, vals, rows, s));
}

}  // extern "C"
