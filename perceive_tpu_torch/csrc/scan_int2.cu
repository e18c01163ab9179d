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
// an exact int32, which __dp4a takes a plane's crumbs of four plane-rows
// at a time against the query bytes of that plane.
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
// kept; the block shape is this kernel's own.  It reads what K5 reads and
// writes (Q, T * M) pairs instead of (Q, n_sweep) scores: bound by the
// packed bytes, ~0.12 ms at Q = 1 over 3,809,280 x 384.  The first kernel
// took 0.32 ms, more than K5 + K6: one block a (tile, query) scored the
// whole tile with K5's first decode (4-byte loads, ~8 operations a byte),
// so at Q = 1 the 310 tiles of 12,288 rows left 46 of 132 SMs a third
// block, and 128 of its 256 threads walked the lane bins alone after a
// barrier.  Design: K5's decode and query tiles (the block reads each row
// once for up to 8 queries), and a tile split over a cluster of blocks
// (parts of 2R sublanes: 3 at one query), so the grid's units are K5's
// 4,096-row tiles.  After each pass of 2R sublanes the scores sit in shared
// memory and every (query, lane) of the block walks them into a running
// best p kept there; at the end the cluster's blocks merge their lanes'
// lists through distributed shared memory in rank order (the lower
// sublanes first, so equal scores keep the lower sublane) and write them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kInt2Threads = 256;
constexpr int kInt2QueryTile = 8;  // queries per block at most
constexpr int kInt2MaxD4 = kMaxDim / 4;
constexpr int kInt2MaxGroups = kInt2MaxD4 / 4;  // groups of four plane-rows
constexpr int kInt2BlocksPerSm = 2;

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

// The bytes of queries q0 .. q0 + qn - 1 as dp4a operands: qw[i][c][g]
// holds query i's bytes at dims c D/4 + 4g .. + 3 (zero past D/4 and past
// qn), against crumbs c of plane-rows 4g .. 4g + 3; qsum[i] the sum of its
// bytes (a warp reduction), qsc[i] its scale; allow the source filter.
// Block-wide; ends in a __syncthreads.
template <int QT>
__device__ __forceinline__ void stage_int2_queries(const int8_t* __restrict__ q, const float* __restrict__ qscale,
                                                   const int* __restrict__ allowed, int n_filter, int d, int q0,
                                                   int qn, uint32_t (*qw)[4][kInt2MaxGroups], int* qsum, float* qsc,
                                                   int* allow) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d4 = d / 4, ng = (d4 + 3) / 4;
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
}

// acc[i][j] = the int32 sum over the crumbs c_d of row j of the R adjacent
// rows at p (plane-row stride ld) of query i's bytes times c_d: plane-rows
// in groups of four, two groups in flight; a 4 x 4 byte transpose gives
// each row one word of a group's four plane-rows, and crumb c is (word >>
// 2c) & 0x03030303 against the query's bytes of plane c there.
template <int QT, int R>
__device__ __forceinline__ void int2_dots(const uint8_t* p, int ld, int d4, const uint32_t (*qw)[4][kInt2MaxGroups],
                                          int (&acc)[QT][R]) {
  const int ng = (d4 + 3) / 4;
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0;
  // w[h][pr] holds plane-row 4(g + h) + pr of the R rows (zeros past D/4)
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
}

// The ids and scales of rows row .. row + R - 1 (16-byte loads), and
// whether each lies before n_sweep and passes the filter.
template <int R>
__device__ __forceinline__ void int2_row_meta(const float* __restrict__ scales, const int* __restrict__ src, int row,
                                              int n_sweep, const int* allow, int n_filter, float (&srow)[R],
                                              bool (&ok)[R]) {
  int ids[R];
#pragma unroll
  for (int u = 0; u < R / 4; ++u) {
    const int4 iv = *reinterpret_cast<const int4*>(src + row + 4 * u);
    const float4 sv = *reinterpret_cast<const float4*>(scales + row + 4 * u);
    ids[4 * u] = iv.x, ids[4 * u + 1] = iv.y, ids[4 * u + 2] = iv.z, ids[4 * u + 3] = iv.w;
    srow[4 * u] = sv.x, srow[4 * u + 1] = sv.y, srow[4 * u + 2] = sv.z, srow[4 * u + 3] = sv.w;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) ok[j] = row + j < n_sweep && row_allowed(ids[j], allow, n_filter);
}

// The masked score: f32(2 acc - 3 qsum) * row scale * query scale, in that
// order, or -inf.
__device__ __forceinline__ float int2_score(int acc, int qsum, float srow, float qsc, bool ok) {
  return ok ? __fmul_rn(__fmul_rn(__int2float_rn(2 * acc - 3 * qsum), srow), qsc) : -INFINITY;
}

// K5.  Grid (blocks, query tiles of QT): block b takes the tiles of
// kInt2Threads * R rows b, b + gridDim.x, ...; thread t rows R t .. R t +
// R - 1 of each.
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

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * QT;
  const int qn = min(QT, nq - q0);
  stage_int2_queries<QT>(q, qscale, allowed, n_filter, d, q0, qn, qw, qsum, qsc, allow);

  const int tile_rows = kInt2Threads * R;
  const int n_tiles = (n_sweep + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * tile_rows + R * tid;  // this thread's R rows
    if (row >= n_sweep) continue;
    int acc[QT][R];
    int2_dots<QT, R>(packed + row, ld, d / 4, qw, acc);
    // ids and scales once a tile; the scores with 16-byte stores where the
    // rows are whole and the row pitch keeps them aligned
    float srow[R];
    bool ok[R];
    int2_row_meta<R>(scales, src, row, n_sweep, allow, n_filter, srow, ok);
    const bool vec = row + R <= n_sweep && (n_sweep & 3) == 0;
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (i >= qn) break;
      float sc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) sc[j] = int2_score(acc[i][j], qsum[i], srow[j], qsc[i], ok[j]);
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

constexpr int kTileTopMaxP = 4;      // M / 128 <= 4 (M <= 512, _INT2_TILETOP_MAX)
constexpr int kTileTopMaxParts = 8;  // blocks a tile: a portable cluster

// K10's shared memory: a pass's scores sc[QT][kInt2Threads * R / 128][128]
// (2R sublanes), then the running lists of every (query, lane) of the
// block's part, lv/ls[QT][kTileTopMaxP][128] (score, sublane).
template <int QT, int R>
constexpr int tiletop_smem() {
  return (QT * (kInt2Threads * R / 128) * 128 + 2 * QT * kTileTopMaxP * 128) * 4;
}

// Inserts (v, s) into the best P of a lane, ordered by (score descending,
// lower sublane first): the entries arrive in order of sublane (or of the
// parts' ranges, each part's list in its own order), so only a strictly
// greater score moves up.
template <int P>
__device__ __forceinline__ void lane_insert(float (&bv)[P], int (&bs)[P], float v, int s) {
  if (!(v > bv[P - 1])) return;
  bv[P - 1] = v;
  bs[P - 1] = s;
#pragma unroll
  for (int j = P - 1; j > 0; --j) {
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

// One (query, lane) list lv/ls[j * 128] (j < P) walks sublanes s0 .. s1 - 1
// of a pass whose scores are sc[(s - s0) * 128].
template <int P>
__device__ __forceinline__ void lane_walk(float* lv, int* ls, const float* sc, int s0, int s1) {
  float bv[P];
  int bs[P];
#pragma unroll
  for (int j = 0; j < P; ++j) bv[j] = lv[j * 128], bs[j] = ls[j * 128];
  for (int s = s0; s < s1; ++s) lane_insert<P>(bv, bs, sc[(s - s0) * 128], s);
#pragma unroll
  for (int j = 0; j < P; ++j) lv[j * 128] = bv[j], ls[j * 128] = bs[j];
}

// Merges the cluster's parts' lists of one (query, lane), in rank order,
// and writes the best P at out + j * 128 (vals) and their global rows.
template <int P>
__device__ __forceinline__ void lane_merge(cooperative_groups::cluster_group& cluster, const float* lv,
                                           const int* ls, int parts, int row0, float* vals, int* rows) {
  float bv[P];
  int bs[P];
#pragma unroll
  for (int j = 0; j < P; ++j) bv[j] = -INFINITY, bs[j] = 0;
  for (int r = 0; r < parts; ++r) {
    const float* rv = cluster.map_shared_rank(lv, r);
    const int* rs = cluster.map_shared_rank(ls, r);
#pragma unroll
    for (int j = 0; j < P; ++j) lane_insert<P>(bv, bs, rv[j * 128], rs[j * 128]);
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    vals[j * 128] = bv[j];
    rows[j * 128] = row0 + bs[j] * 128;
  }
}

// K10.  Grid (tiles x parts, query tiles of QT), clusters of `parts`
// blocks along x: cluster t is tile t, its block of rank r scores the
// tile's sublanes [r per, min(sub, (r + 1) per)) in passes of 2R sublanes
// (thread t rows R t .. R t + R - 1 of a pass, as K5 scores them) into
// shared memory, and after each pass every (query, lane) of the block
// walks the pass's sublanes into its running best P.  Then the cluster's
// blocks merge the parts' lists of each (query, lane) through distributed
// shared memory, rank order keeping the lower sublane first on ties, and
// write them out.
template <int QT, int R>
__global__ void __launch_bounds__(kInt2Threads, 2) int2_tiletop_kernel(
    const uint8_t* __restrict__ packed, int ld, const float* __restrict__ scales,
    const int* __restrict__ src, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int tile_n, int m_top, int parts,
    float* __restrict__ vals, int* __restrict__ rows) {
  constexpr int kPassSubs = kInt2Threads * R / 128;
  extern __shared__ float4 tiletop_smem4[];
  float* sc = reinterpret_cast<float*>(tiletop_smem4);  // [QT][kPassSubs][128]
  float* lv = sc + QT * kPassSubs * 128;                // [QT][kTileTopMaxP][128]
  int* ls = reinterpret_cast<int*>(lv + QT * kTileTopMaxP * 128);
  __shared__ uint32_t qw[QT][4][kInt2MaxGroups];
  __shared__ int qsum[QT];
  __shared__ float qsc[QT];
  __shared__ int allow[kMaxFilter];

  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / parts;
  const int q0 = blockIdx.y * QT;
  const int qn = min(QT, nq - q0);
  const int p = m_top / 128;
  stage_int2_queries<QT>(q, qscale, allowed, n_filter, d, q0, qn, qw, qsum, qsc, allow);
  for (int i = tid; i < QT * kTileTopMaxP * 128; i += kInt2Threads) lv[i] = -INFINITY, ls[i] = 0;

  const int sub = tile_n / 128, per = (sub + parts - 1) / parts;
  const int s_lo = min(sub, rank * per), s_hi = min(sub, s_lo + per);
  const int tile0 = tile * tile_n;
  for (int s0 = s_lo; s0 < s_hi; s0 += kPassSubs) {  // block-uniform
    const int s1 = min(s_hi, s0 + kPassSubs);
    const int ps = R * tid / 128, lane0 = R * tid % 128;  // this thread's sublane in the pass, first lane
    if (s0 + ps < s1) {
      const int row = tile0 + (s0 + ps) * 128 + lane0;
      int acc[QT][R];
      int2_dots<QT, R>(packed + row, ld, d / 4, qw, acc);
      float srow[R];
      bool ok[R];
      int2_row_meta<R>(scales, src, row, n_sweep, allow, n_filter, srow, ok);
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        float4* o = reinterpret_cast<float4*>(sc + (i * kPassSubs + ps) * 128 + lane0);
#pragma unroll
        for (int u = 0; u < R / 4; ++u)
          o[u] = make_float4(int2_score(acc[i][4 * u], qsum[i], srow[4 * u], qsc[i], ok[4 * u]),
                             int2_score(acc[i][4 * u + 1], qsum[i], srow[4 * u + 1], qsc[i], ok[4 * u + 1]),
                             int2_score(acc[i][4 * u + 2], qsum[i], srow[4 * u + 2], qsc[i], ok[4 * u + 2]),
                             int2_score(acc[i][4 * u + 3], qsum[i], srow[4 * u + 3], qsc[i], ok[4 * u + 3]));
      }
    }
    __syncthreads();
    for (int pair = tid; pair < QT * 128; pair += kInt2Threads) {  // (query, lane)
      const int i = pair / 128, l = pair % 128;
      if (i >= qn) break;
      float* v = lv + i * kTileTopMaxP * 128 + l;
      int* s = ls + i * kTileTopMaxP * 128 + l;
      const float* c = sc + i * kPassSubs * 128 + l;
      switch (p) {
        case 1: lane_walk<1>(v, s, c, s0, s1); break;
        case 2: lane_walk<2>(v, s, c, s0, s1); break;
        case 3: lane_walk<3>(v, s, c, s0, s1); break;
        default: lane_walk<4>(v, s, c, s0, s1); break;
      }
    }
    __syncthreads();
  }

  cluster.sync();  // every part's lists are final
  const int n_tiles = n_sweep / tile_n;
  for (int pair = rank * kInt2Threads + tid; pair < QT * 128; pair += parts * kInt2Threads) {
    const int i = pair / 128, l = pair % 128;
    if (i >= qn) break;
    const size_t out0 = (static_cast<size_t>(q0 + i) * n_tiles + tile) * m_top + l;
    const float* v = lv + i * kTileTopMaxP * 128 + l;
    const int* s = ls + i * kTileTopMaxP * 128 + l;
    switch (p) {
      case 1: lane_merge<1>(cluster, v, s, parts, tile0 + l, vals + out0, rows + out0); break;
      case 2: lane_merge<2>(cluster, v, s, parts, tile0 + l, vals + out0, rows + out0); break;
      case 3: lane_merge<3>(cluster, v, s, parts, tile0 + l, vals + out0, rows + out0); break;
      default: lane_merge<4>(cluster, v, s, parts, tile0 + l, vals + out0, rows + out0); break;
    }
  }
  cluster.sync();  // no block leaves while another reads its lists
}

template <int QT, int R>
cudaError_t launch_int2_tiletop(const uint8_t* packed, int ld, const float* scales, const int* src, const int8_t* q,
                                const float* qscale, const int* allowed, int n_filter, int nq, int d, int n_sweep,
                                int tile_n, int m_top, float* vals, int* rows, cudaStream_t s) {
  constexpr int kPassSubs = kInt2Threads * R / 128;
  constexpr int kSmem = tiletop_smem<QT, R>();
  static int smem_set[64] = {0};  // by device: the attribute, once a process
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(int2_tiletop_kernel<QT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = 1;
  }
  // parts a tile: one pass of 2R sublanes each, at most a portable cluster
  const int sub = tile_n / 128;
  const int parts = min(kTileTopMaxParts, (sub + kPassSubs - 1) / kPassSubs);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_sweep / tile_n) * parts, (nq + QT - 1) / QT);
  cfg.blockDim = dim3(kInt2Threads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int2_tiletop_kernel<QT, R>, packed, ld, scales, src, q, qscale, allowed, n_filter,
                            nq, d, n_sweep, tile_n, m_top, parts, vals, rows);
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

// K10.  packed: (d/4, ld) uint8 with ld (the capacity) a multiple of 16;
// the first n_sweep rows (a multiple of tile_n, itself a multiple of 512
// and at most 12,288) in n_sweep / tile_n tiles; m_top a multiple of 128,
// at most 512; packed, scales and src 16-byte aligned.  Writes vals (nq, T
// * m_top) f32 and rows (nq, T * m_top) int32.  Query tiles, rows a
// thread, as K5.
int perceive_int2_tiletop(const uint8_t* packed, int ld, const float* scales, const int* src,
                          const int8_t* q, const float* qscale, const int* allowed, int n_filter,
                          int nq, int d, int n_sweep, int tile_n, int m_top, float* vals, int* rows,
                          void* stream) {
  if (nq < 1 || nq > 65535 || n_sweep < 1 || n_sweep > ld || ld % 16 || d < 4 || d % 4 || d > kMaxDim ||
      n_filter < 1 || n_filter > kMaxFilter || tile_n < 512 || tile_n % 512 || tile_n > 12288 ||
      n_sweep % tile_n || m_top < 128 || m_top % 128 || m_top > 128 * kTileTopMaxP ||
      (reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(src)) %
          16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t (*launch)(const uint8_t*, int, const float*, const int*, const int8_t*, const float*, const int*, int,
                        int, int, int, int, int, float*, int*, cudaStream_t) =
      nq == 1 ? launch_int2_tiletop<1, 16>
      : nq == 2 ? launch_int2_tiletop<2, 16>
      : nq <= 4 ? launch_int2_tiletop<4, 8>
                : launch_int2_tiletop<8, 4>;
  return static_cast<int>(launch(packed, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, tile_n,
                                 m_top, vals, rows, s));
}

}  // extern "C"
