// K5: masked int2 coarse scores, (Q, n_sweep) f32 written to device memory,
// with no selection inside (K6, select_topk.cu, selects afterwards).
// K10: the same scores with a per-tile top-M epilogue (the "tiletop"
// select), so the (Q, n_sweep) scores never reach device memory.
//
// Replace the TPU kernels perceive_tpu/ops/topk.py `pallas_int2_scores`
// (`_scan_kernel_int2_scores`) and `pallas_int2_scores_tiletop`
// (`_scan_kernel_int2_tiletop`).
//
// Layout: the coarse matrix is (D/4, N) uint8, transposed; byte [r, n]
// packs dims r, r + D/4, r + 2D/4, r + 3D/4 of row n as 2-bit crumbs.
// Planes 0-2 hold c with level 2c - 3; plane 3 holds t in two's complement
// with level 2t + 1.  Flipping the top bit of the byte turns t into a c of
// the same rule (t = 0, 1, -2, -1 -> c = 2, 3, 0, 1), so every level is
// 2c - 3 and
//     sum_d q_d * level_d = 2 * sum_d q_d * c_d - 3 * sum_d q_d,
// an exact int32.  The four crumbs of a byte spread into the four bytes of
// one word (values 0..3, the same bits as signed or unsigned bytes), and
// one __dp4a takes them against the query bytes q[r], q[r + D/4],
// q[r + 2D/4], q[r + 3D/4], gathered once per block into shared memory.
// The score is __fmul_rn(__fmul_rn(f32(acc), row scale), query scale), in
// that order and with no fast math, so it equals the plain version
// (ops/int2.py `scores_int2`, the JAX `xla_scores_int2`) bit for bit.
// Rows whose source id is negative or not allowed score -inf.
//
// What bounds K5 on the H100: at Q = 1 over 4,194,304 x 384 it reads
// 403 MB of packed bytes plus 34 MB of scales and ids, and writes 17 MB of
// scores (0.13 ms at 3.35 TB/s); the decode is ~8 integer operations a
// byte, so at one query it is near the integer-throughput line too.  A
// thread takes 4 adjacent rows and reads one 32-bit word a plane-row: a
// warp reads 128 contiguous bytes a load; the decode of a byte is shared
// by every query of the block's tile.
//
// K10 keeps, for each query, tile t of tile_n rows and lane l < 128, the
// best p = M / 128 scores of the bin {t * tile_n + s * 128 + l}, ordered by
// (score descending, lower s first), and writes them at t * M + j * 128 + l
// with their global rows.  A bin with fewer than p finite scores fills its
// remaining places with (-inf, t * tile_n + l): the TPU kernel's p passes of
// argmax with the taken places masked to -inf return the first index once
// every score left is -inf.  The tile geometry is the JAX package's tile
// picker (ops/int2.py `_pick_tile_int2`): it defines the bins, so it is
// kept; the block shape is this kernel's own.  One block a (tile, query):
// 256 threads score the tile as K5 does into shared memory (at most 12,288
// f32, 48 KiB), then 128 threads each walk one lane bin (stride 128: no
// bank conflicts) and keep p <= 4 entries in registers.  It reads what K5
// reads and writes (Q, T * M) pairs instead of (Q, n_sweep) scores: bound
// by the packed bytes, ~0.12 ms at Q = 1 over 3,809,280 x 384.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kInt2Threads = 256;
constexpr int kInt2Rows = 4 * kInt2Threads;  // rows per block, 4 a thread
constexpr int kInt2QueryTile = 8;            // queries per block
constexpr int kInt2MaxD4 = kMaxDim / 4;

// The crumbs of byte b (its top crumb already flipped) in the low 2 bits of
// the four bytes of a word.
__device__ __forceinline__ int spread_crumbs(uint32_t b) {
  return static_cast<int>((b & 0x3u) | ((b << 6) & 0x300u) | ((b << 12) & 0x30000u) |
                          ((b << 18) & 0x3000000u));
}

// Grid (row blocks, query tiles).
__global__ void __launch_bounds__(kInt2Threads) int2_scores_kernel(
    const uint8_t* __restrict__ packed, int ld, const float* __restrict__ scales,
    const int* __restrict__ src, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep,
    float* __restrict__ out) {
  __shared__ int qw[kInt2QueryTile][kInt2MaxD4];
  __shared__ int qsum[kInt2QueryTile];
  __shared__ float qsc[kInt2QueryTile];
  __shared__ int allow[kMaxFilter];

  const int tid = threadIdx.x;
  const int d4 = d / 4;
  const int q0 = blockIdx.y * kInt2QueryTile;
  const int qn = min(kInt2QueryTile, nq - q0);
  for (int i = tid; i < qn * d4; i += kInt2Threads) {
    const int qi = i / d4, r = i - qi * d4;
    const int8_t* qq = q + static_cast<size_t>(q0 + qi) * d;
    const uint32_t b0 = static_cast<uint8_t>(qq[r]), b1 = static_cast<uint8_t>(qq[r + d4]);
    const uint32_t b2 = static_cast<uint8_t>(qq[r + 2 * d4]), b3 = static_cast<uint8_t>(qq[r + 3 * d4]);
    qw[qi][r] = static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
  }
  if (tid < qn) {
    int s = 0;
    const int8_t* qq = q + static_cast<size_t>(q0 + tid) * d;
    for (int j = 0; j < d; ++j) s += qq[j];
    qsum[tid] = s;
    qsc[tid] = qscale[q0 + tid];
  }
  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  __syncthreads();

  const int row = blockIdx.x * kInt2Rows + 4 * tid;  // this thread's 4 rows
  if (row >= n_sweep) return;
  int acc[kInt2QueryTile][4];
#pragma unroll
  for (int i = 0; i < kInt2QueryTile; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(packed + row);
  const int ldw = ld / 4;
#pragma unroll 4
  for (int r = 0; r < d4; ++r) {
    const uint32_t w = __ldg(p + static_cast<size_t>(r) * ldw) ^ 0x80808080u;
    const int c0 = spread_crumbs(w & 0xffu), c1 = spread_crumbs((w >> 8) & 0xffu);
    const int c2 = spread_crumbs((w >> 16) & 0xffu), c3 = spread_crumbs(w >> 24);
#pragma unroll
    for (int i = 0; i < kInt2QueryTile; ++i) {
      if (i < qn) {
        const int x = qw[i][r];
        acc[i][0] = __dp4a(c0, x, acc[i][0]);
        acc[i][1] = __dp4a(c1, x, acc[i][1]);
        acc[i][2] = __dp4a(c2, x, acc[i][2]);
        acc[i][3] = __dp4a(c3, x, acc[i][3]);
      }
    }
  }
  bool ok[4];
  float srow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ok[j] = row + j < n_sweep && row_allowed(src[row + j], allow, n_filter);
    srow[j] = row + j < n_sweep ? scales[row + j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kInt2QueryTile; ++i) {
    if (i < qn) {
      float* o = out + static_cast<size_t>(q0 + i) * n_sweep + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (row + j < n_sweep) {
          const int dot = 2 * acc[i][j] - 3 * qsum[i];
          o[j] = ok[j] ? __fmul_rn(__fmul_rn(__int2float_rn(dot), srow[j]), qsc[i]) : -INFINITY;
        }
      }
    }
  }
}


constexpr int kTileTopMaxTile = 12288;  // the widest int2 tile: 48 KiB of f32
constexpr int kTileTopMaxP = 4;         // M <= 512 (_INT2_TILETOP_MAX)

// The best P (score, sublane) of lane l's bin in scores[s * 128 + l],
// s < sub, ordered by (score descending, lower sublane first); finite
// scores only, the rest of the places (-inf, 0).
template <int P>
__device__ __forceinline__ void lane_top(const float* scores, int sub, int l, float* bv, int* bs) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    bv[j] = -INFINITY;
    bs[j] = 0;
  }
  for (int s = 0; s < sub; ++s) {
    const float v = scores[s * 128 + l];
    if (v > bv[P - 1]) {
      bv[P - 1] = v;
      bs[P - 1] = s;
#pragma unroll
      for (int j = P - 1; j > 0; --j) {  // strictly better moves up: ties keep the lower sublane first
        if (bv[j] > bv[j - 1]) {
          const float tv = bv[j];
          bv[j] = bv[j - 1];
          bv[j - 1] = tv;
          const int ts = bs[j];
          bs[j] = bs[j - 1];
          bs[j - 1] = ts;
        }
      }
    }
  }
}

template <int P>
__device__ __forceinline__ void write_lane_top(const float* scores, int sub, int l, int tile_n,
                                               float* vals, int* rows) {
  float bv[P];
  int bs[P];
  lane_top<P>(scores, sub, l, bv, bs);
  const int row0 = blockIdx.x * tile_n + l;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    vals[j * 128 + l] = bv[j];
    rows[j * 128 + l] = row0 + bs[j] * 128;
  }
}

// Grid (tiles, queries); dynamic shared memory: tile_n f32 scores.
__global__ void __launch_bounds__(kInt2Threads) int2_tiletop_kernel(
    const uint8_t* __restrict__ packed, int ld, const float* __restrict__ scales,
    const int* __restrict__ src, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int d, int tile_n, int m_top,
    float* __restrict__ vals, int* __restrict__ rows) {
  extern __shared__ float4 tile_scores4[];
  float* tile_scores = reinterpret_cast<float*>(tile_scores4);
  __shared__ int qw[kInt2MaxD4];
  __shared__ int allow[kMaxFilter];
  __shared__ int qsum;

  const int tid = threadIdx.x;
  const int d4 = d / 4;
  const int qi = blockIdx.y;
  const int8_t* qq = q + static_cast<size_t>(qi) * d;
  for (int r = tid; r < d4; r += kInt2Threads) {
    const uint32_t b0 = static_cast<uint8_t>(qq[r]), b1 = static_cast<uint8_t>(qq[r + d4]);
    const uint32_t b2 = static_cast<uint8_t>(qq[r + 2 * d4]), b3 = static_cast<uint8_t>(qq[r + 3 * d4]);
    qw[r] = static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
  }
  if (tid < 32) {
    int s = 0;
    for (int j = tid; j < d; j += 32) s += qq[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) qsum = s;
  }
  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  __syncthreads();

  // the tile's masked scores, 4 adjacent rows a thread, as K5 computes them
  const float qsc = qscale[qi];
  const int tile0 = blockIdx.x * tile_n;
  const int ldw = ld / 4;
  for (int r0 = 4 * tid; r0 < tile_n; r0 += 4 * kInt2Threads) {
    const int row = tile0 + r0;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(packed + row);
    int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int r = 0; r < d4; ++r) {
      const uint32_t w = __ldg(p + static_cast<size_t>(r) * ldw) ^ 0x80808080u;
      const int x = qw[r];
      acc[0] = __dp4a(spread_crumbs(w & 0xffu), x, acc[0]);
      acc[1] = __dp4a(spread_crumbs((w >> 8) & 0xffu), x, acc[1]);
      acc[2] = __dp4a(spread_crumbs((w >> 16) & 0xffu), x, acc[2]);
      acc[3] = __dp4a(spread_crumbs(w >> 24), x, acc[3]);
    }
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dot = 2 * acc[j] - 3 * qsum;
      sc[j] = row_allowed(src[row + j], allow, n_filter)
                  ? __fmul_rn(__fmul_rn(__int2float_rn(dot), scales[row + j]), qsc)
                  : -INFINITY;
    }
    tile_scores4[r0 / 4] = make_float4(sc[0], sc[1], sc[2], sc[3]);
  }
  __syncthreads();

  // the epilogue: lane bin l of this tile, its best p
  if (tid < 128) {
    const int sub = tile_n / 128;
    const size_t out0 = static_cast<size_t>(qi) * gridDim.x * m_top + static_cast<size_t>(blockIdx.x) * m_top;
    float* v = vals + out0;
    int* rw = rows + out0;
    switch (m_top / 128) {
      case 1: write_lane_top<1>(tile_scores, sub, tid, tile_n, v, rw); break;
      case 2: write_lane_top<2>(tile_scores, sub, tid, tile_n, v, rw); break;
      case 3: write_lane_top<3>(tile_scores, sub, tid, tile_n, v, rw); break;
      default: write_lane_top<4>(tile_scores, sub, tid, tile_n, v, rw); break;
    }
  }
}

}  // namespace

extern "C" {

// K5.  packed: (d/4, ld) uint8 with ld (the capacity) a multiple of 4;
// scores the first n_sweep rows into out (nq, n_sweep) f32.
int perceive_int2_scores(const uint8_t* packed, int ld, const float* scales, const int* src,
                         const int8_t* q, const float* qscale, const int* allowed, int n_filter,
                         int nq, int d, int n_sweep, float* out, void* stream) {
  if (nq < 1 || n_sweep < 1 || n_sweep > ld || ld % 4 || d < 4 || d % 4 || d > kMaxDim ||
      n_filter < 1 || n_filter > kMaxFilter || reinterpret_cast<uintptr_t>(packed) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_sweep + kInt2Rows - 1) / kInt2Rows, (nq + kInt2QueryTile - 1) / kInt2QueryTile);
  int2_scores_kernel<<<grid, kInt2Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, out);
  return static_cast<int>(cudaGetLastError());
}

// K10.  packed: (d/4, ld) uint8 with ld a multiple of 4; the first n_sweep
// rows (a multiple of tile_n, itself a multiple of 512 and at most 12,288)
// in n_sweep / tile_n tiles; m_top a multiple of 128, at most 512.  Writes
// vals (nq, T * m_top) f32 and rows (nq, T * m_top) int32.
int perceive_int2_tiletop(const uint8_t* packed, int ld, const float* scales, const int* src,
                          const int8_t* q, const float* qscale, const int* allowed, int n_filter,
                          int nq, int d, int n_sweep, int tile_n, int m_top, float* vals, int* rows,
                          void* stream) {
  if (nq < 1 || nq > 65535 || n_sweep < 1 || n_sweep > ld || ld % 4 || d < 4 || d % 4 || d > kMaxDim ||
      n_filter < 1 || n_filter > kMaxFilter || reinterpret_cast<uintptr_t>(packed) % 4 || tile_n < 512 ||
      tile_n % 512 || tile_n > kTileTopMaxTile || n_sweep % tile_n || m_top < 128 || m_top % 128 ||
      m_top > 128 * kTileTopMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tile_n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(int2_tiletop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kTileTopMaxTile * static_cast<int>(sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_sweep / tile_n, nq);
  int2_tiletop_kernel<<<grid, kInt2Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, ld, scales, src, q, qscale, allowed, n_filter, d, tile_n, m_top, vals, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
