// K5: masked int2 coarse scores, (Q, n_sweep) f32 written to device memory,
// with no selection inside (K6, select_topk.cu, selects afterwards).
//
// Replaces the TPU kernel perceive_tpu/ops/topk.py `pallas_int2_scores`
// (`_scan_kernel_int2_scores`).
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
// What bounds it on the H100: at Q = 1 over 4,194,304 x 384 it reads
// 403 MB of packed bytes plus 34 MB of scales and ids, and writes 17 MB of
// scores (0.13 ms at 3.35 TB/s); the decode is ~8 integer operations a
// byte, so at one query it is near the integer-throughput line too.  A
// thread takes 4 adjacent rows and reads one 32-bit word a plane-row: a
// warp reads 128 contiguous bytes a load; the decode of a byte is shared
// by every query of the block's tile.

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

}  // extern "C"
