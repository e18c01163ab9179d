// K1 and K3: exact scans with top-k selection over a row-major matrix for
// fewer than 256 queries (every text query, every escalation and every
// executor drain of fewer than 256), one kernel for Hopper templated on the
// operand: K1 over a bf16 or f32 matrix, K3 over the int8 tier's matrix
// with its row scales.
//
// Replaces the TPU kernels perceive_tpu/ops/topk.py `pallas_topk_unsorted`
// (`_scan_kernel` + `_merge_tile_topk`: top-k of q . matrix^T, products
// summed in f32) and `pallas_topk_int8_unsorted` (`_scan_kernel_int8`:
// top-k of f32(int32 dot) * row scale * query scale, rounded in that order
// (__fmul_rn), bit for bit with the plain version, ops/topk.py
// `scores_int8`), over rows [0, n_sweep), rows whose source id is -1 or
// outside `allowed` excluded, ties to the lower row, every comparison by the
// unique (score, ~row) keys of topk_common.cuh.
//
// What bounds them on the H100: device-memory bytes.  At Q = 1 a 958,464 x
// 384 bf16 sweep reads 736 MB (0.22 ms at 3.35 TB/s), a 2,064,384 x 384
// int8 sweep 793 MB and 8 MB of scales (0.24 ms), for 2 * D operations a
// row and query.  The first kernel took 0.63 ms (bf16) and
// 1.80 ms (int8, k = 128): a warp streamed one row at a time with one
// 16-byte load a lane (24 of 32 lanes busy at 384 int8 dims), re-read the
// matrix for every 16 queries, ran a select over every 512-row block and
// finished with one block a query over all blocks' candidates (every row
// at the escalations' k >= 512).
//
// Design.  Persistent blocks over contiguous row ranges, threshold-pruned
// like the TPU kernel's `_merge_tile_topk`:
//   * (query tiles) x (row ranges) ~ two blocks per SM on the CUDA cores,
//     one on the tensor cores; blocks of one range launch side by side, so
//     the range comes from device memory once;
//   * a producer warp streams each 128-row tile as boxes of 128 bytes of
//     every row (64 bf16, 32 f32 or 128 int8 dims, 128-byte swizzle) by
//     TMA through a ring of shared-memory stages, the tile's source ids (and
//     at int8 its row scales) two tiles ahead, completion on mbarriers;
//   * on the CUDA cores (every f32 sweep, and sweeps of at most
//     FLAT_ROWS_CORE_QUERIES[operand], ops/topk.py), up to 16 queries a
//     block: one consumer warpgroup scores each tile into a shared-memory
//     score tile, a thread a row, the queries staged in shared memory once
//     a block (the swizzle puts the 8 rows of a quarter-warp on 8 distinct
//     chunks): f32 FMAs at bf16 and f32, `__dp4a` into an exact int32 at
//     int8, then scaled; the epilogue keeps a running threshold tau and a
//     candidate list per (query, range) (hopper_common.cuh): one warp owns
//     each query, so appends take ballots and compactions no barrier.  At
//     Q = 1 almost no row passes tau after the first tiles;
//   * on the tensor cores (wider sweeps, d a multiple of 64 at bf16 and of
//     128 at int8), K2's and K4's pass 1 (scan_slab_rows.cu: wgmma with the
//     query tile resident) with a tile of 64 queries, or 128 past 64
//     queries, so that a sweep of up to 64 queries reads each row once;
//   * pass 2 (hopper_common.cuh `launch_lists_pass2`): `list_pass2` where
//     a query's ranges x cap keys stage in shared memory, else the
//     multi-block radix select (deep k: the escalations' k >= 512 at
//     millions of rows).
// What holds it back: on the CUDA cores a block's consumer warpgroup
// alternates scoring and the epilogue, and the score tile costs a barrier
// a tile.

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
constexpr int kSrcAhead = 2;  // tiles whose source ids and scales load ahead of their rows
// a tile's ids and scales are read at its first box: when the producer may
// load box (tile, 0), the consumers have released box (tile, 0) - stages and
// so read the ids of every tile up to tile - ceil(stages / boxes a tile);
// slot reuse kSrcSlots back is then safe
constexpr int kSrcSlots = kSrcAhead + kMaxStages;
constexpr size_t kTwoPerSm = 115712;  // the most a block may take for two to share an SM

// The operands of the CUDA-core pass: how a box's 16-byte chunk of a row
// meets the staged queries (Q: the staged element; V dims a chunk), and
// how a row's sum becomes its score.
struct Bf16Op {
  typedef float Q;
  typedef float Acc;
  static constexpr int kBytes = 2;
  static constexpr bool kScaled = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static float stage(const void* q, size_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  }
  template <int QT>
  __device__ __forceinline__ static void chunk(float (&acc)[QT], const uint4& v, const float* qp, int dpad) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float x[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
#pragma unroll
    for (int i = 0; i < QT; ++i)
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 q = *reinterpret_cast<const float4*>(qp + i * dpad + e);
        acc[i] = fmaf(x[e], q.x, acc[i]);
        acc[i] = fmaf(x[e + 1], q.y, acc[i]);
        acc[i] = fmaf(x[e + 2], q.z, acc[i]);
        acc[i] = fmaf(x[e + 3], q.w, acc[i]);
      }
  }
  __device__ __forceinline__ static float score(float acc, float, float) { return acc; }
};

struct F32Op {
  typedef float Q;
  typedef float Acc;
  static constexpr int kBytes = 4;
  static constexpr bool kScaled = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ __forceinline__ static float stage(const void* q, size_t i) { return static_cast<const float*>(q)[i]; }
  template <int QT>
  __device__ __forceinline__ static void chunk(float (&acc)[QT], const uint4& v, const float* qp, int dpad) {
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(qp + i * dpad);
      acc[i] = fmaf(__uint_as_float(v.x), q.x, acc[i]);
      acc[i] = fmaf(__uint_as_float(v.y), q.y, acc[i]);
      acc[i] = fmaf(__uint_as_float(v.z), q.z, acc[i]);
      acc[i] = fmaf(__uint_as_float(v.w), q.w, acc[i]);
    }
  }
  __device__ __forceinline__ static float score(float acc, float, float) { return acc; }
};

struct S8Op {  // K3: int8 rows with f32 row scales, int8 queries with f32 scales
  typedef int8_t Q;
  typedef int Acc;
  static constexpr int kBytes = 1;
  static constexpr bool kScaled = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static int8_t stage(const void* q, size_t i) { return static_cast<const int8_t*>(q)[i]; }
  template <int QT>
  __device__ __forceinline__ static void chunk(int (&acc)[QT], const uint4& v, const int8_t* qp, int dpad) {
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const uint4 q = *reinterpret_cast<const uint4*>(qp + i * dpad);
      acc[i] = __dp4a(static_cast<int>(v.x), static_cast<int>(q.x), acc[i]);
      acc[i] = __dp4a(static_cast<int>(v.y), static_cast<int>(q.y), acc[i]);
      acc[i] = __dp4a(static_cast<int>(v.z), static_cast<int>(q.z), acc[i]);
      acc[i] = __dp4a(static_cast<int>(v.w), static_cast<int>(q.w), acc[i]);
    }
  }
  // f32(dot) * row scale * query scale, rounded in that order
  __device__ __forceinline__ static float score(int acc, float srow, float sq) {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), srow), sq);
  }
};

// The shared-memory bytes of a launch (layout in scan_flat, in this order):
// the query tile holds every dim of its queries, padded to whole boxes.
template <class Op>
size_t plan_smem(int qt, int nbox, int stages) {
  return 1024 + static_cast<size_t>(stages) * kBoxBytes + kSrcSlots * kRowTile * (Op::kScaled ? 8 : 4) +
         static_cast<size_t>(qt) * nbox * (128 / Op::kBytes) * sizeof(typename Op::Q) +
         2ull * qt * kScPitch * 4 + static_cast<size_t>(qt) * 16 + static_cast<size_t>(2 * stages + kSrcSlots) * 8 +
         kMaxFilter * 4;
}

// Grid (query tiles of QT, row ranges); block: one consumer warpgroup + one
// producer warp.  cand[q][range][cap]: each (query, range)'s candidate
// list, kept there while the block runs.  tmap_scale and qscale are read
// at int8 only.
template <class Op, int QT>
__global__ void __launch_bounds__(kConsumers + 32, 2) scan_flat(
    const __grid_constant__ CUtensorMap tmap_m, const __grid_constant__ CUtensorMap tmap_s,
    const __grid_constant__ CUtensorMap tmap_scale, const void* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int k, int cap, int rows_per_range,
    int nranges, int stages, u64* __restrict__ cand) {
  typedef typename Op::Q Q;
  constexpr int E = 128 / Op::kBytes;  // dims a box
  constexpr int V = 16 / Op::kBytes;   // dims a 16-byte chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int nbox = (d + E - 1) / E;
  const int dpad = nbox * E;
  // the TMA destinations first: the ring 1024-byte aligned (the swizzle), the ids and scales 128
  unsigned char* ring = base;                                                              // [stages][128 rows][128 B]
  int* src_ring = reinterpret_cast<int*>(ring + static_cast<size_t>(stages) * kBoxBytes);  // [kSrcSlots][128]
  float* scl_ring = reinterpret_cast<float*>(src_ring + kSrcSlots * kRowTile);             // int8: [kSrcSlots][128]
  Q* qs = reinterpret_cast<Q*>(scl_ring + (Op::kScaled ? kSrcSlots * kRowTile : 0));       // [QT][dpad]
  float* sc = reinterpret_cast<float*>(qs + QT * dpad);                                    // [2][QT][kScPitch]
  u64* tau = reinterpret_cast<u64*>(sc + 2 * QT * kScPitch);                               // [QT]
  int* cnt = reinterpret_cast<int*>(tau + QT);                                             // [QT]
  float* qsc = reinterpret_cast<float*>(cnt + QT);                                         // [QT]
  uint64_t* full = reinterpret_cast<uint64_t*>(qsc + QT);                                  // [stages]
  uint64_t* empty = full + stages;                                                         // [stages]
  uint64_t* src_full = empty + stages;                                                     // [kSrcSlots]
  int* allow = reinterpret_cast<int*>(src_full + kSrcSlots);                               // [kMaxFilter]

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
    qsc[tid] = Op::kScaled && tid < qn ? qscale[q0 + tid] : 0.f;
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
    // producer: every row tile box by box; a tile's source ids (and
    // scales) load kSrcAhead tiles ahead of its rows
    if (lane == 0) {
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

  // consumers: stage the query tile (zeros past nq and past d)
  for (int i = tid; i < QT * dpad; i += kConsumers) {
    const int r = i / dpad, dim = i - r * dpad;
    qs[i] = r < qn && dim < d ? Op::stage(q, static_cast<size_t>(q0 + r) * d + dim) : Q(0);
  }
  named_barrier(1, kConsumers);

  const unsigned lower = (1u << lane) - 1u;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row0 = row_lo + tile * kRowTile;
    const int rows = row_hi - row0;
    float* scb = sc + (tile & 1) * QT * kScPitch;
    const int slot = tile % kSrcSlots;
    // thread r scores tile row r for every query of the tile
    const int r = tid;
    typename Op::Acc acc[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) acc[i] = 0;
    bool ok = false;
    float srow = 0.f;
    for (int c = 0; c < nbox; ++c) {
      mbar_wait(full + stage, phase);
      if (c == 0) {
        mbar_wait(src_full + slot, (tile / kSrcSlots) & 1);
        ok = r < rows && row_allowed(src_ring[slot * kRowTile + r], allow, n_filter);
        if constexpr (Op::kScaled) srow = scl_ring[slot * kRowTile + r];
      }
      const unsigned char* box = ring + stage * kBoxBytes;
#pragma unroll
      for (int h = 0; h < 8; ++h)
        Op::template chunk<QT>(acc, *reinterpret_cast<const uint4*>(box + swz128(r, 16 * h)), qs + c * E + h * V,
                               dpad);
      // release the stage once its words are used.  The proxy fence orders
      // this warp's generic-proxy reads of it before the TMA (async-proxy)
      // write that reuses it (the fault it cured in scan_flat_cols.cu)
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) scb[i * kScPitch + r] = ok ? Op::score(acc[i], srow, qsc[i]) : -INFINITY;
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
        const int rr = 32 * m + lane;
        const float s = scb[i * kScPitch + rr];
        const u64 key = s != -INFINITY ? make_key(float_order(s + 0.0f), row0 + rr) : 0ull;
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

template <class Op, int QT>
cudaError_t launch(const CUtensorMap& tmap_m, const CUtensorMap& tmap_s, const CUtensorMap& tmap_scale, const void* q,
                   const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                   int ranges, int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  const int nbox = (d * Op::kBytes + 127) / 128;
  // two blocks an SM where three stages fit beside each other, else one
  int stages = kMaxStages;
  while (stages >= 3 && plan_smem<Op>(QT, nbox, stages) > kTwoPerSm) --stages;
  if (stages < 3) {
    stages = kMaxStages;
    while (stages >= 2 && plan_smem<Op>(QT, nbox, stages) > kSmemMax) --stages;
    if (stages < 2) return cudaErrorInvalidValue;
  }
  const size_t smem = plan_smem<Op>(QT, nbox, stages);
  cudaError_t err = allow_smem<scan_flat<Op, QT>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + QT - 1) / QT, ranges);
  scan_flat<Op, QT><<<grid, kConsumers + 32, smem, s>>>(tmap_m, tmap_s, tmap_scale, q, qscale, allowed, n_filter,
                                                        nq, d, n_sweep, k, cap, rows_per_range, ranges, stages, cand);
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_cores(int qt, const CUtensorMap& m, const CUtensorMap& sm, const CUtensorMap& sc, const void* q,
                         const float* qs, const int* al, int nf, int nq, int d, int ns, int k, int ranges, int rpr,
                         int cap, u64* cand, cudaStream_t s) {
  switch (qt) {
    case 1: return launch<Op, 1>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 2: return launch<Op, 2>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 4: return launch<Op, 4>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 8: return launch<Op, 8>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    case 16: return launch<Op, 16>(m, sm, sc, q, qs, al, nf, nq, d, ns, k, ranges, rpr, cap, cand, s);
    default: return cudaErrorInvalidValue;
  }
}

// Pass 1 on the CUDA cores: the tensor maps of the matrix (128-byte boxes
// of 128 rows), its ids and (int8) its scales, then the launch.
template <class Op>
cudaError_t scan_cores(int qt, const void* matrix, const float* scales, const int* src, const void* q,
                       const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                       int ranges, int rows_per_range, int cap, u64* cand, cudaStream_t s) {
  CUtensorMap tmap_m, tmap_s, tmap_scale;
  if (!make_map_2d(&tmap_m, Op::kMap, matrix, d, n_sweep, static_cast<uint64_t>(d) * Op::kBytes, 128 / Op::kBytes,
                   kRowTile, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_1d(&tmap_s, CU_TENSOR_MAP_DATA_TYPE_INT32, src, n_sweep, kRowTile))
    return cudaErrorInvalidValue;
  tmap_scale = tmap_s;  // read at int8 only
  if (Op::kScaled && !make_map_1d(&tmap_scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, n_sweep, kRowTile))
    return cudaErrorInvalidValue;
  return launch_cores<Op>(qt, tmap_m, tmap_s, tmap_scale, q, qscale, allowed, n_filter, nq, d, n_sweep, k, ranges,
                          rows_per_range, cap, cand, s);
}

}  // namespace

extern "C" {

// The scan kernels' largest k and dim (topk_common.cuh).
int perceive_scan_topk_max_k() { return kMaxK; }
int perceive_scan_topk_max_dim() { return kMaxDim; }

const char* perceive_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// K1 and K3.  dtype: 0 = float32, 1 = bfloat16 (matrix and queries alike),
// 2 = int8 (K3: (n,) f32 row scales, (nq,) f32 query scales; null
// otherwise); rows of a multiple of 16 bytes; matrix, scales, src, q and
// the workspace 16-byte aligned.  The launch plan comes from the wrapper
// (ops/topk.py `flat_rows_plan`): qt queries a block (1, 2, 4, 8 or 16 on
// the CUDA cores; 64 or 128 on the tensor cores, bf16 with d a multiple of
// 64 or int8 with d a multiple of 128), `ranges` row ranges of
// rows_per_range rows (a multiple of 128) covering n_sweep, each (query,
// range) list's capacity cap (64 keys for k <= 32, else more than k), and
// multi: pass 2 by the multi-block select.  Workspace: nq * ranges * cap *
// 8 bytes of lists, then with multi perceive_keys_select_workspace(nq, k)
// bytes.
int perceive_scan_flat_rows(const void* matrix, int dtype, const float* scales, const int* src, const void* q,
                            const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                            int qt, int ranges, int rows_per_range, int cap, int multi, float* vals, int* rows,
                            void* workspace, void* stream) {
  const size_t elem = dtype == 2 ? 1 : dtype == 1 ? 2 : 4;
  const bool s8 = dtype == 2;
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || dtype < 0 || dtype > 2 || (d * elem) % 16 ||
      !list_plan_ok(n_sweep, k, ranges, rows_per_range, cap, kRowTile) ||
      (s8 && (scales == nullptr || qscale == nullptr)) ||
      (reinterpret_cast<uintptr_t>(matrix) | reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(src) |
       reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(workspace)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* cand = static_cast<u64*>(workspace);
  cudaError_t err;
  if (qt == 64 || qt == 128) {
    if (dtype == 1)
      err = scan_bf16_wgmma_lists(matrix, src, q, allowed, n_filter, nq, d, n_sweep, k, qt, ranges, rows_per_range,
                                  cap, cand, s);
    else if (s8)
      err = scan_s8_rows_wgmma_lists(matrix, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, qt, ranges,
                                     rows_per_range, cap, cand, s);
    else
      err = cudaErrorInvalidValue;
  } else if (s8) {
    err = scan_cores<S8Op>(qt, matrix, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, k, ranges,
                           rows_per_range, cap, cand, s);
  } else if (dtype == 1) {
    err = scan_cores<Bf16Op>(qt, matrix, nullptr, src, q, nullptr, allowed, n_filter, nq, d, n_sweep, k, ranges,
                             rows_per_range, cap, cand, s);
  } else {
    err = scan_cores<F32Op>(qt, matrix, nullptr, src, q, nullptr, allowed, n_filter, nq, d, n_sweep, k, ranges,
                            rows_per_range, cap, cand, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_lists_pass2(cand, nq, ranges * cap, k, multi, vals, rows, s));
}

}  // extern "C"
