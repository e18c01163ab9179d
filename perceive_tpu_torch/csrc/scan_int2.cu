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
// q[r + 2D/4], q[r + 3D/4] (K10), or a plane's crumbs of four plane-rows
// against the query bytes of that plane (K5, below).
// The score is __fmul_rn(__fmul_rn(f32(acc), row scale), query scale), in
// that order and with no fast math, so it equals the plain version
// (ops/int2.py `scores_int2`, the JAX `xla_scores_int2`) bit for bit.
// Rows whose source id is negative or not allowed score -inf.
//
// What bounds K5 on the H100: at Q = 1 over 3,809,280 x 384 it reads 366
// MB of packed bytes plus 30 MB of scales and ids, and writes 15 MB of
// scores (0.12 ms at 3.35 TB/s).  The first kernel took 0.30 ms: a block
// per 1,024 rows gathered the query words and summed the query's bytes on
// one thread before it read anything, then read one 4-byte word a
// plane-row, few bytes in flight, and spread each byte's crumbs with ~8
// integer operations.  Design: persistent blocks (about two an SM) stride
// over tiles of 256 x R rows with the query words and the sums of the
// query's bytes (a warp reduction) staged once a block; a thread takes R
// adjacent rows (16 at up to 2 queries, 8 or 4 past that) and loads R
// bytes of four plane-rows at a time (16-byte loads at one query), two
// such groups in flight; a 4 x 4 byte transpose gives each row one word of its four plane-rows, and
// its crumb c comes out as (word >> 2c) & 0x03030303 against the query's
// bytes of plane c at those plane-rows: ~3.4 integer operations a byte at
// one query.  Ids and scales are read once a tile with 16-byte loads, and
// the scores written with 16-byte stores, a warp's contiguous.
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
// 256 threads score the tile into shared memory (at most 12,288 f32, 48
// KiB), four adjacent rows a thread, one 4-byte word a plane-row, each
// byte's crumbs spread into one word against the query bytes, then 128 threads each walk one lane bin (stride 128: no
// bank conflicts) and keep p <= 4 entries in registers.  It reads what K5
// reads and writes (Q, T * M) pairs instead of (Q, n_sweep) scores: bound
// by the packed bytes, ~0.12 ms at Q = 1 over 3,809,280 x 384.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kInt2Threads = 256;
constexpr int kInt2QueryTile = 8;  // queries per block at most
constexpr int kInt2MaxD4 = kMaxDim / 4;
constexpr int kInt2MaxGroups = kInt2MaxD4 / 4;  // groups of four plane-rows
constexpr int kInt2BlocksPerSm = 2;

// The crumbs of byte b (its top crumb already flipped) in the low 2 bits of
// the four bytes of a word.
__device__ __forceinline__ int spread_crumbs(uint32_t b) {
  return static_cast<int>((b & 0x3u) | ((b << 6) & 0x300u) | ((b << 12) & 0x30000u) |
                          ((b << 18) & 0x3000000u));
}

// R bytes of one plane-row (R adjacent rows) as R / 4 words.
template <int R>
__device__ __forceinline__ void load_rows(const uint8_t* p, uint32_t (&w)[R / 4]) {
  if constexpr (R == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (R == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

// K5.  Grid (blocks, query tiles of QT): block b takes the tiles of
// kInt2Threads * R rows b, b + gridDim.x, ...; thread t rows R t .. R t +
// R - 1 of each.  qw[i][c][g]: the bytes of query i at dims c D/4 + 4g ..
// + 3 (zero past D/4), a dp4a operand against crumbs c of plane-rows 4g ..
// 4g + 3.
template <int QT, int R>
__global__ void __launch_bounds__(kInt2Threads) int2_scores_kernel(
    const uint8_t* __restrict__ packed, int ld, const float* __restrict__ scales,
    const int* __restrict__ src, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep,
    float* __restrict__ out) {
  __shared__ uint32_t qw[QT][4][kInt2MaxGroups];
  __shared__ int qsum[QT];
  __shared__ float qsc[QT];
  __shared__ int allow[kMaxFilter];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d4 = d / 4, ng = (d4 + 3) / 4;
  const int q0 = blockIdx.y * QT;
  const int qn = min(QT, nq - q0);
  for (int i = tid; i < QT * 4 * ng; i += kInt2Threads) {
    const int qi = i / (4 * ng), c = (i / ng) % 4, g = i % ng;
    uint32_t w = 0;
    if (qi < qn)
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < d4)
          w |= static_cast<uint32_t>(static_cast<uint8_t>(q[static_cast<size_t>(q0 + qi) * d + c * d4 + 4 * g + j]))
               << (8 * j);
    qw[qi][c][g] = w;
  }
  for (int qi = warp; qi < QT; qi += kInt2Threads / 32) {  // the query's byte sum, a warp's reduction
    int s = 0;
    if (qi < qn)
      for (int j = lane; j < d; j += 32) s += q[static_cast<size_t>(q0 + qi) * d + j];
    s = warp_sum_i(s);
    if (lane == 0) {
      qsum[qi] = s;
      qsc[qi] = qi < qn ? qscale[q0 + qi] : 0.f;
    }
  }
  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  __syncthreads();

  const int tile_rows = kInt2Threads * R;
  const int n_tiles = (n_sweep + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * tile_rows + R * tid;  // this thread's R rows
    if (row >= n_sweep) continue;
    int acc[QT][R];
#pragma unroll
    for (int i = 0; i < QT; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = 0;
    const uint8_t* p = packed + row;
    // groups of four plane-rows, two in flight: w[h][pr] holds plane-row
    // 4(g + h) + pr of the R rows (zeros past D/4)
    for (int g = 0; g < ng; g += 2) {
      uint32_t w[2][4][R / 4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          const int r = 4 * (g + h) + pr;
          if (r < d4) {
            load_rows<R>(p + static_cast<size_t>(r) * ld, w[h][pr]);
          } else {
#pragma unroll
            for (int u = 0; u < R / 4; ++u) w[h][pr][u] = 0;  // past D/4: against zero query bytes
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (g + h >= ng) break;
#pragma unroll
        for (int u = 0; u < R / 4; ++u) {
          uint32_t rw[4];  // rw[e]: row 4u + e's bytes at the group's four plane-rows
          transpose4x4(w[h][0][u] ^ 0x80808080u, w[h][1][u] ^ 0x80808080u, w[h][2][u] ^ 0x80808080u,
                       w[h][3][u] ^ 0x80808080u, rw);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int m = static_cast<int>((rw[e] >> (2 * c)) & 0x03030303u);
#pragma unroll
              for (int i = 0; i < QT; ++i)
                acc[i][4 * u + e] = __dp4a(m, static_cast<int>(qw[i][c][g + h]), acc[i][4 * u + e]);
            }
        }
      }
    }
    // ids and scales once a tile; the scores with 16-byte stores where the
    // rows are whole and the row pitch keeps them aligned
    int ids[R];
    float srow[R];
#pragma unroll
    for (int u = 0; u < R / 4; ++u) {
      const int4 iv = *reinterpret_cast<const int4*>(src + row + 4 * u);
      const float4 sv = *reinterpret_cast<const float4*>(scales + row + 4 * u);
      ids[4 * u] = iv.x, ids[4 * u + 1] = iv.y, ids[4 * u + 2] = iv.z, ids[4 * u + 3] = iv.w;
      srow[4 * u] = sv.x, srow[4 * u + 1] = sv.y, srow[4 * u + 2] = sv.z, srow[4 * u + 3] = sv.w;
    }
    bool ok[R];
#pragma unroll
    for (int j = 0; j < R; ++j) ok[j] = row + j < n_sweep && row_allowed(ids[j], allow, n_filter);
    const bool vec = row + R <= n_sweep && (n_sweep & 3) == 0;
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (i >= qn) break;
      float sc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int dot = 2 * acc[i][j] - 3 * qsum[i];
        sc[j] = ok[j] ? __fmul_rn(__fmul_rn(__int2float_rn(dot), srow[j]), qsc[i]) : -INFINITY;
      }
      float* o = out + static_cast<size_t>(q0 + i) * n_sweep + row;
      if (vec) {
#pragma unroll
        for (int u = 0; u < R / 4; ++u)
          reinterpret_cast<float4*>(o)[u] = make_float4(sc[4 * u], sc[4 * u + 1], sc[4 * u + 2], sc[4 * u + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (row + j < n_sweep) o[j] = sc[j];
      }
    }
  }
}

template <int QT, int R>
cudaError_t launch_int2_scores(const uint8_t* packed, int ld, const float* scales, const int* src, const int8_t* q,
                               const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep,
                               float* out, cudaStream_t s) {
  static int sms[64] = {0};  // by device, read once a process
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  // about kInt2BlocksPerSm blocks an SM over the query tiles, each taking
  // an equal count of row tiles
  const int qtiles = (nq + QT - 1) / QT;
  const int tiles = (n_sweep + kInt2Threads * R - 1) / (kInt2Threads * R);
  const int most = max(1, kInt2BlocksPerSm * sms[dev] / qtiles);
  const int per = (tiles + most - 1) / most;
  const dim3 grid((tiles + per - 1) / per, qtiles);
  int2_scores_kernel<QT, R><<<grid, kInt2Threads, 0, s>>>(packed, ld, scales, src, q, qscale, allowed, n_filter, nq,
                                                          d, n_sweep, out);
  return cudaGetLastError();
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

// K5.  packed: (d/4, ld) uint8 with ld (the capacity) a multiple of 16;
// scores the first n_sweep rows into out (nq, n_sweep) f32; packed,
// scales, src and out 16-byte aligned.  Query tiles of up to 8: 16 rows a
// thread up to 2 queries, 8 up to 4, 4 past that (the accumulators of 8
// queries x 8 rows took 244 registers, one block an SM: 0.44 ms at Q = 8
// against 0.35 with 4 rows on an H100, chip_smoke.py, PERF.md section 6).
int perceive_int2_scores(const uint8_t* packed, int ld, const float* scales, const int* src,
                         const int8_t* q, const float* qscale, const int* allowed, int n_filter,
                         int nq, int d, int n_sweep, float* out, void* stream) {
  if (nq < 1 || nq > 65535 * kInt2QueryTile || n_sweep < 1 || n_sweep > ld || ld % 16 || d < 4 || d % 4 ||
      d > kMaxDim || n_filter < 1 || n_filter > kMaxFilter ||
      (reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(src) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t (*launch)(const uint8_t*, int, const float*, const int*, const int8_t*, const float*, const int*, int,
                        int, int, int, float*, cudaStream_t) =
      nq == 1 ? launch_int2_scores<1, 16>
      : nq == 2 ? launch_int2_scores<2, 16>
      : nq <= 4 ? launch_int2_scores<4, 8>
                : launch_int2_scores<8, 4>;
  return static_cast<int>(launch(packed, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, out, s));
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
