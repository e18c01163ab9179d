// Exact scan with top-k selection over the device embedding matrix, for
// fewer than 256 queries: K3 (int8 rows), K7 (the int2 tier's int8
// companion, stored transposed) and K9 (the packed-int4 tier, and the int2
// tier's int4 companion, stored transposed).  (The bf16/f32 scan, K1, has
// a kernel of its own for Hopper: scan_flat_bf16.cu.)
//
// Replaces the TPU kernels perceive_tpu/ops/topk.py
// `pallas_topk_int8_unsorted` (`_scan_kernel_int8`, the int8 tier),
// `pallas_topk_int8t_unsorted` (`_scan_kernel_int8t`, the (D, N) int8
// companion that int2 batches and escalations sweep) and
// `pallas_topk_int4_unsorted` (`_scan_kernel_int4`, the (D/2, N) packed
// int4 matrix).
//
// What bounds them on the H100: device-memory bytes.  One sweep of a
// 2M x 384 int8 matrix reads 805 MB, of a
// 25M x 384 packed-int4 matrix 4.8 GB; a query costs 2*D operations per D
// stored bytes or less, far below the card's operation/byte balance, so
// the scan is a streaming read.
//
// Design.  The TPU kernels carry one (Q, k) buffer across a grid that runs
// in order on one core.  Here blocks run in parallel and share nothing, so
// the selection is two passes (topk_common.cuh):
//   pass 1  a block owns kRows consecutive rows and a tile of up to
//           kQueryTile queries (shared memory is sized to the tile, so a
//           single query leaves room for more blocks per SM).  One warp per
//           row streams the row with 16-byte loads (read once per query
//           tile) against the queries staged in shared memory, masked rows
//           get no score, and one warp per query keeps the block's best
//           min(k, kRows) candidates (a 32-step threshold search over the
//           scores in registers, topk_common.cuh).
//             K3: 16 int8 values per load, __dp4a into an exact int32
//                 accumulator, then score = f32(acc) * row scale * query
//                 scale, rounded in that order (no fast math), so the
//                 scores equal the plain version's bit for bit.
//             K7, K9: the transposed layouts, 4 rows a thread (below).
//   pass 2  one block per query radix-selects the top k of all candidates,
//           bitonic-sorts them in shared memory and writes (score, row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kQueryTile = 16;    // queries per pass-1 block

// K3 pass 1: grid (row blocks, query tiles); d a multiple of 16.
__global__ void __launch_bounds__(kThreads) scan_pass1_int8(
    const int8_t* __restrict__ matrix, const float* __restrict__ scales,
    const int* __restrict__ src, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int kc, int qt,
    u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);          // [qt][kRows]
  int8_t* qs = reinterpret_cast<int8_t*>(sc + qt * kRows);  // [qt][d]
  __shared__ int allow[kMaxFilter];
  __shared__ float qsc[kQueryTile];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blk = blockIdx.x;
  const int q0 = blockIdx.y * qt;
  const int qn = min(qt, nq - q0);
  const int row0 = blk * kRows;
  const int rn = min(kRows, n_sweep - row0);
  const int nvec = d / 16;

  const int4* qsrc = reinterpret_cast<const int4*>(q + static_cast<size_t>(q0) * d);
  int4* qdst = reinterpret_cast<int4*>(qs);
  for (int i = tid; i < qn * nvec; i += kThreads) qdst[i] = qsrc[i];
  if (tid < qn) qsc[tid] = qscale[q0 + tid];
  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  __syncthreads();

  for (int r = warp; r < rn; r += kWarps) {
    const int row = row0 + r;
    if (!row_allowed(src[row], allow, n_filter)) {  // warp-uniform
      if (lane < qn) sc[lane * kRows + r] = -INFINITY;
      continue;
    }
    int acc[kQueryTile];
#pragma unroll
    for (int i = 0; i < kQueryTile; ++i) acc[i] = 0;
    const int8_t* mrow = matrix + static_cast<size_t>(row) * d;
    for (int c = lane; c < nvec; c += 32) {
      const int4 x = *reinterpret_cast<const int4*>(mrow + c * 16);
#pragma unroll
      for (int i = 0; i < kQueryTile; ++i) {
        if (i < qn) {
          const int4 w = *reinterpret_cast<const int4*>(qs + i * d + c * 16);
          acc[i] = __dp4a(x.x, w.x, acc[i]);
          acc[i] = __dp4a(x.y, w.y, acc[i]);
          acc[i] = __dp4a(x.z, w.z, acc[i]);
          acc[i] = __dp4a(x.w, w.w, acc[i]);
        }
      }
    }
    const float srow = scales[row];
#pragma unroll
    for (int i = 0; i < kQueryTile; ++i) {
      if (i < qn) {
        const int v = warp_sum_i(acc[i]);
        if (lane == 0) sc[i * kRows + r] = __fmul_rn(__fmul_rn(__int2float_rn(v), srow), qsc[i]);
      }
    }
  }
  __syncthreads();
  write_candidates(sc, kRows, qn, q0, rn, row0, blk, gridDim.x, kc, cand);
}

// K7 and K9 pass 1: the scans over the TRANSPOSED layouts.  K7: the int2
// tier's (d, ld) int8 companion.  K9 (kPacked4): the (d/2, ld) packed-int4
// matrix, whose byte [r, n] holds dim r of row n in the low nibble, biased
// +8, and dim r + d/2 in the high nibble, two's complement.  Grid (pairs of
// kRows-row candidate blocks, query tiles); a thread takes 4 adjacent rows,
// reads one 32-bit word (4 rows x 1 byte) a byte-row, so a warp reads 128
// contiguous bytes a load, and turns the words of 4 byte-rows into one dp4a
// operand a row with a 4 x 4 byte transpose (__byte_perm).  K9 decodes each
// such word in registers into two: the low nibbles less 8 (exact, [-8, 7])
// and the sign-extended high nibbles, dp4a'd against q[r..r+3] and
// q[d/2+r..d/2+r+3].  Scores as K3's, bit for bit: f32(int32 dot) * row
// scale * query scale.
constexpr int kT8QueryTile = 8;
constexpr int kT8Rows = 2 * kRows;  // rows per block: 256 threads x 4

// 4 int8 values from the low nibbles of a packed word, less the bias of 8
__device__ __forceinline__ int nibbles_lo(uint32_t w) {
  return static_cast<int>(__vsub4(w & 0x0f0f0f0fu, 0x08080808u));
}

// 4 int8 values from the high nibbles of a packed word, sign-extended
__device__ __forceinline__ int nibbles_hi(uint32_t w) {
  return static_cast<int>(__vsub4(((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u));
}

template <bool kPacked4>
__global__ void __launch_bounds__(kThreads) scan_pass1_int8t(
    const int8_t* __restrict__ m8t, int ld, const float* __restrict__ scales,
    const int* __restrict__ src, const int8_t* __restrict__ q, const float* __restrict__ qscale,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int kc, int nblk,
    u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                    // [qt][kT8Rows]
  int8_t* qs = reinterpret_cast<int8_t*>(sc + kT8QueryTile * kT8Rows);  // [qt][d]
  __shared__ int allow[kMaxFilter];
  __shared__ float qsc[kT8QueryTile];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kT8QueryTile;
  const int qn = min(kT8QueryTile, nq - q0);
  const int row0 = blockIdx.x * kT8Rows;
  const int rn = min(kT8Rows, n_sweep - row0);

  const int4* qsrc = reinterpret_cast<const int4*>(q + static_cast<size_t>(q0) * d);
  int4* qdst = reinterpret_cast<int4*>(qs);
  for (int i = tid; i < qn * (d / 16); i += kThreads) qdst[i] = qsrc[i];
  if (tid < qn) qsc[tid] = qscale[q0 + tid];
  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  __syncthreads();

  const int r = 4 * tid;  // this thread's first row within the block
  if (r < rn) {
    int acc[kT8QueryTile][4];
#pragma unroll
    for (int i = 0; i < kT8QueryTile; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(m8t + row0 + r);
    const size_t ldw = static_cast<size_t>(ld / 4);
    const int byte_rows = kPacked4 ? d / 2 : d;
    for (int c = 0; c < byte_rows; c += 4) {
      uint32_t rw[4];
      transpose4x4(__ldg(p + c * ldw), __ldg(p + (c + 1) * ldw), __ldg(p + (c + 2) * ldw),
                   __ldg(p + (c + 3) * ldw), rw);
      if (kPacked4) {
        int lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = nibbles_lo(rw[j]);
          hi[j] = nibbles_hi(rw[j]);
        }
#pragma unroll
        for (int i = 0; i < kT8QueryTile; ++i) {
          if (i < qn) {
            const int xl = *reinterpret_cast<const int*>(qs + i * d + c);
            const int xh = *reinterpret_cast<const int*>(qs + i * d + byte_rows + c);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(hi[j], xh, __dp4a(lo[j], xl, acc[i][j]));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kT8QueryTile; ++i) {
          if (i < qn) {
            const int x = *reinterpret_cast<const int*>(qs + i * d + c);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(static_cast<int>(rw[j]), x, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + r + j;
      if (r + j >= rn) continue;
      const bool ok = row_allowed(src[row], allow, n_filter);
      const float srow = scales[row];
#pragma unroll
      for (int i = 0; i < kT8QueryTile; ++i)
        if (i < qn)
          sc[i * kT8Rows + r + j] =
              ok ? __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), srow), qsc[i]) : -INFINITY;
    }
  }
  __syncthreads();
  for (int h = 0; h < 2; ++h) {
    const int blk = 2 * blockIdx.x + h;
    if (blk < nblk)
      for (int i = tid >> 5; i < qn; i += kWarps)
        warp_select_block(sc + i * kT8Rows + h * kRows, min(kRows, n_sweep - blk * kRows),
                          blk * kRows, kc, cand + (static_cast<size_t>(q0 + i) * nblk + blk) * kc);
  }
}

template <bool kPacked4>
cudaError_t launch_int8t(const int8_t* m, int ld, const float* scales, const int* src,
                         const int8_t* q, const float* qscale, const int* allowed, int n_filter,
                         int nq, int d, int n_sweep, int k, float* vals, int* rows,
                         void* workspace, cudaStream_t stream) {
  const int nblk = n_blocks(n_sweep);
  const int kc = cand_per_block(k);
  const size_t smem1 = static_cast<size_t>(kT8QueryTile) * (kT8Rows * sizeof(float) + d);
  cudaError_t err = cudaFuncSetAttribute(scan_pass1_int8t<kPacked4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  u64* cand = static_cast<u64*>(workspace);
  const dim3 grid1((nblk + 1) / 2, (nq + kT8QueryTile - 1) / kT8QueryTile);
  scan_pass1_int8t<kPacked4><<<grid1, kThreads, smem1, stream>>>(
      m, ld, scales, src, q, qscale, allowed, n_filter, nq, d, n_sweep, kc, nblk, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pass2(cand, nq, nblk * kc, k, vals, rows, stream);
}

}  // namespace

extern "C" {

// Workspace bytes the caller allocates for one launch (every scan kernel).
size_t perceive_scan_topk_workspace(int nq, int n_sweep, int k) {
  return static_cast<size_t>(nq) * n_blocks(n_sweep) * cand_per_block(k) * sizeof(u64);
}

int perceive_scan_topk_max_k() { return kMaxK; }
int perceive_scan_topk_max_dim() { return kMaxDim; }

// K3: int8 matrix with (N,) f32 row scales, int8 queries with (Q,) f32
// scales.
int perceive_scan_topk_int8(const int8_t* matrix, const float* scales, const int* src,
                            const int8_t* q, const float* qscale, const int* allowed,
                            int n_filter, int nq, int d, int n_sweep, int k, float* vals,
                            int* rows, void* workspace, void* stream) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || d % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = n_blocks(n_sweep);
  const int kc = cand_per_block(k);
  const int qt = nq < kQueryTile ? nq : kQueryTile;
  const size_t smem1 = static_cast<size_t>(qt) * (kRows * sizeof(float) + d);
  cudaError_t err = cudaFuncSetAttribute(scan_pass1_int8, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* cand = static_cast<u64*>(workspace);
  const dim3 grid1(nblk, (nq + qt - 1) / qt);
  scan_pass1_int8<<<grid1, kThreads, smem1, s>>>(matrix, scales, src, q, qscale, allowed,
                                                 n_filter, nq, d, n_sweep, kc, qt, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_pass2(cand, nq, nblk * kc, k, vals, rows, s));
}

// K7: int8 scan over the transposed (d, ld) companion matrix of the int2
// tier (ld, its capacity, a multiple of 4), with (ld,) f32 row scales.
int perceive_scan_topk_int8t(const int8_t* m8t, int ld, const float* scales, const int* src,
                             const int8_t* q, const float* qscale, const int* allowed,
                             int n_filter, int nq, int d, int n_sweep, int k, float* vals,
                             int* rows, void* workspace, void* stream) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || d % 16 || ld % 4 || n_sweep > ld ||
      reinterpret_cast<uintptr_t>(m8t) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_int8t<false>(m8t, ld, scales, src, q, qscale, allowed, n_filter,
                                              nq, d, n_sweep, k, vals, rows, workspace,
                                              static_cast<cudaStream_t>(stream)));
}

// K9: scan over the transposed (d/2, ld) packed-int4 matrix (ld, its
// capacity, a multiple of 4), with (ld,) f32 row scales; d (the queries'
// width) a multiple of 32.
int perceive_scan_topk_int4(const uint8_t* m4t, int ld, const float* scales, const int* src,
                            const int8_t* q, const float* qscale, const int* allowed,
                            int n_filter, int nq, int d, int n_sweep, int k, float* vals,
                            int* rows, void* workspace, void* stream) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || d % 32 || ld % 4 || n_sweep > ld ||
      reinterpret_cast<uintptr_t>(m4t) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_int8t<true>(reinterpret_cast<const int8_t*>(m4t), ld, scales, src,
                                             q, qscale, allowed, n_filter, nq, d, n_sweep, k, vals,
                                             rows, workspace, static_cast<cudaStream_t>(stream)));
}

const char* perceive_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
