// K3: exact scan with top-k selection over the int8 device embedding
// matrix, for fewer than 256 queries.  (The bf16/f32 scan, K1, and the
// scans over the transposed matrices, K7 and K9 flat, have kernels of their
// own for Hopper: scan_flat_bf16.cu and scan_flat_cols.cu.)
//
// Replaces the TPU kernel perceive_tpu/ops/topk.py
// `pallas_topk_int8_unsorted` (`_scan_kernel_int8`, the int8 tier).
//
// What bounds it on the H100: device-memory bytes.  One sweep of a
// 2M x 384 int8 matrix reads 805 MB; a query costs 2*D operations per D
// stored bytes or less, far below the card's operation/byte balance, so
// the scan is a streaming read.
//
// Design.  The TPU kernel carries one (Q, k) buffer across a grid that
// runs in order on one core.  Here blocks run in parallel and share
// nothing, so the selection is two passes (topk_common.cuh):
//   pass 1  a block owns kRows consecutive rows and a tile of up to
//           kQueryTile queries (shared memory is sized to the tile, so a
//           single query leaves room for more blocks per SM).  One warp per
//           row streams the row with 16-byte loads (read once per query
//           tile) against the queries staged in shared memory, masked rows
//           get no score, and one warp per query keeps the block's best
//           min(k, kRows) candidates (a 32-step threshold search over the
//           scores in registers, topk_common.cuh).  16 int8 values per
//           load, __dp4a into an exact int32 accumulator, then score =
//           f32(acc) * row scale * query scale, rounded in that order (no
//           fast math), so the scores equal the plain version's bit for
//           bit.
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

}  // namespace

extern "C" {

// Workspace bytes the caller allocates for one K3 launch.
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

const char* perceive_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
