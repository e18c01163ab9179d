// Exact scan with top-k selection for batches of queries over the int8
// tiers: K4 (int8 rows) and K8 (the int2 tier's int8 companion, stored
// transposed), one templated kernel with two instantiations.  (The bf16
// and packed-int4 batch scans have kernels of their own for Hopper:
// scan_slab_bf16.cu and scan_slab_int4.cu.)
//
// Replaces the TPU kernels perceive_tpu/ops/topk.py
// `pallas_topk_int8_slabbed` (`_scan_kernel_int8_slabbed`) and
// `pallas_topk_int8t_slabbed` (`_scan_kernel_int8t_slabbed`): the same scans
// as K3 and K7, for sweeps of at least 256 queries, where each row tile is
// read once for many queries.  K8 reads the (D, N) layout, whose bytes are
// contiguous along the rows: it transposes each 4 x 4 byte micro-tile while
// staging it (__byte_perm), so the shared-memory tile and the fragment
// loads are K4's.
//
// What bounds them on the H100: operations.  At Q = 512 a 2M x 384 int8
// sweep is 8.2e11 ops (0.41 ms at 1,979 TOP/s) against 0.82 GB (0.24 ms at
// 3.35 TB/s).  So the scores must come from the tensor cores, and the
// matrix must be read from device memory about once, not once per query
// tile.
//
// Design.  A block owns kRows (512) rows and a tile of kSlabQ (64) queries;
// blocks of one row tile are launched next to each other (the query tile is
// the fast grid index), so the row tile comes from L2 for all but the first.
// The block walks its rows in chunks of 128: for each 128-byte slice of the
// row width, the chunk's rows and the query tile are staged in shared memory
// (pitch 144 bytes, so fragment reads hit 32 distinct banks), and each of
// the 8 warps computes a 32-query x 32-row tile with mma.sync m16n8k32 s8 x
// s8 -> s32 (exact), then f32(acc) * row scale * query scale, rounded in
// that order, so scores equal the plain version's bit for bit.  The
// epilogue masks rows and writes the 64 x 512 score tile to shared memory;
// then one warp per query keeps its best min(k, 512) keys, and K1's pass 2
// finishes (topk_common.cuh).  What is simple and slow here: no cp.async
// or TMA pipeline (two barriers per slice), and one block per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kSlabQ = 64;                  // queries per block
constexpr int kChunk = 128;                 // rows per mma pass
constexpr int kSlice = 128;                 // bytes of a row per staged slice
constexpr int kSlicePitch = kSlice + 16;    // padded shared-memory pitch
constexpr int kScPitch = kRows + 8;         // floats per query of the score tile
constexpr int kSteps = kSlice / 32;         // mma k-steps per slice

constexpr size_t kSlabSmem =
    static_cast<size_t>(kSlabQ) * kScPitch * sizeof(float) +
    static_cast<size_t>(kChunk + kSlabQ) * kSlicePitch;

enum { kInt8 = 2 };  // the dtype code of perceive_scan_topk_slab

template <int kDtype> struct Mma;

template <> struct Mma<kInt8> {
  typedef int Acc;
  __device__ __forceinline__ static void run(int* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static float score(int acc, float srow, float qs) {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), srow), qs);
  }
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// How the matrix is laid out: (N, row_bytes) rows (K4) or the transposed
// (D, ld) int8 companion (K8).
enum { kRowMajor = 0, kTransposed = 1 };

// Grid (query tiles, row blocks); workspace cand[q][block][kc].
template <int kDtype, int kLayout>
__global__ void __launch_bounds__(kThreads, 1) scan_slab(
    const unsigned char* __restrict__ matrix, int ld, const float* __restrict__ scales,
    const int* __restrict__ src, const unsigned char* __restrict__ q,
    const float* __restrict__ qscale, const int* __restrict__ allowed, int n_filter, int nq,
    int row_bytes, int n_sweep, int kc, int nblk, u64* __restrict__ cand) {
  typedef Mma<kDtype> M;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                           // [kSlabQ][kScPitch]
  unsigned char* rs = smem + static_cast<size_t>(kSlabQ) * kScPitch * sizeof(float);  // [kChunk][kSlicePitch]
  unsigned char* qs = rs + kChunk * kSlicePitch;                        // [kSlabQ][kSlicePitch]
  __shared__ int allow[kMaxFilter];
  __shared__ unsigned char rowok[kRows];
  __shared__ float qsc[kSlabQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = blockIdx.x * kSlabQ;
  const int qn = min(kSlabQ, nq - q0);
  const int blk = blockIdx.y;
  const int row0 = blk * kRows;
  const int rn = min(kRows, n_sweep - row0);
  const int wq = (warp & 1) * 32;   // the warp's queries within the tile
  const int wr = (warp >> 1) * 32;  // the warp's rows within a chunk

  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  if (tid < kSlabQ) qsc[tid] = (kDtype == kInt8 && tid < qn) ? qscale[q0 + tid] : 0.f;
  __syncthreads();
  for (int r = tid; r < kRows; r += kThreads)
    rowok[r] = r < rn && row_allowed(src[row0 + r], allow, n_filter);

  const int nslice = row_bytes / kSlice;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c0 = 0; c0 < rn; c0 += kChunk) {
    typename M::Acc acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

    for (int sl = 0; sl < nslice; ++sl) {
      __syncthreads();  // every warp is done with the previous slice
      if (kLayout == kTransposed) {
        // (d, ld) layout: 4 dims x 4 rows a micro-tile, loaded as 4 words
        // (lanes: 8 row groups x 4 dim groups, so a load fills 32-byte
        // sectors) and transposed into 4 rows of 4 k-contiguous bytes
        for (int i = tid; i < (kChunk / 4) * (kSlice / 4); i += kThreads) {
          const int w = i >> 5, l = i & 31;
          const int rg = (w & 3) * 8 + (l & 7), dg = (w >> 2) * 4 + (l >> 3);
          const int r = 4 * rg, kk = 4 * dg;
          uint32_t rw[4] = {0u, 0u, 0u, 0u};
          if (c0 + r < rn) {
            const unsigned char* p = matrix + static_cast<size_t>(sl * kSlice + kk) * ld + row0 + c0 + r;
            transpose4x4(ld32(p), ld32(p + ld), ld32(p + 2 * static_cast<size_t>(ld)),
                         ld32(p + 3 * static_cast<size_t>(ld)), rw);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(rs + (r + j) * kSlicePitch + kk) = rw[j];
        }
      } else {
        for (int i = tid; i < kChunk * (kSlice / 16); i += kThreads) {
          const int r = i >> 3, c = i & 7;
          uint4 v = zero;
          if (c0 + r < rn)
            v = *reinterpret_cast<const uint4*>(
                matrix + static_cast<size_t>(row0 + c0 + r) * row_bytes + sl * kSlice + c * 16);
          *reinterpret_cast<uint4*>(rs + r * kSlicePitch + c * 16) = v;
        }
      }
      for (int i = tid; i < kSlabQ * (kSlice / 16); i += kThreads) {
        const int r = i >> 3, c = i & 7;
        const size_t off = static_cast<size_t>(sl) * kSlice + c * 16;
        uint4 v = zero;
        if (r < qn)
          v = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(q0 + r) * row_bytes + off);
        *reinterpret_cast<uint4*>(qs + r * kSlicePitch + c * 16) = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        // A: queries (row-major, 16 x 32 bytes); B: matrix rows (one row
        // per column, 32 bytes of k each).  For both types the registers
        // hold bytes t*4.. and 16 + t*4.. of the k-step.
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const unsigned char* p = qs + (wq + m * 16 + g) * kSlicePitch + ks * 32 + t * 4;
          a[m][0] = ld32(p);
          a[m][1] = ld32(p + 8 * kSlicePitch);
          a[m][2] = ld32(p + 16);
          a[m][3] = ld32(p + 8 * kSlicePitch + 16);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const unsigned char* p = rs + (wr + n * 8 + g) * kSlicePitch + ks * 32 + t * 4;
          b[n][0] = ld32(p);
          b[n][1] = ld32(p + 16);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) M::run(acc[m][n], a[m], b[n]);
      }
    }

    // epilogue: c[h*2 + e] is (query g + 8h, row t*2 + e) of each 16 x 8 tile
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = wq + m * 16 + g + 8 * h;
            const int r = c0 + wr + n * 8 + t * 2 + e;
            float s = -INFINITY;
            if (rowok[r]) s = M::score(acc[m][n][h * 2 + e], kDtype == kInt8 ? scales[row0 + r] : 0.f, qsc[qi]);
            sc[qi * kScPitch + r] = s;
          }
  }
  __syncthreads();
  write_candidates(sc, kScPitch, qn, q0, rn, row0, blk, nblk, kc, cand);
}

template <int kDtype, int kLayout>
cudaError_t launch_slab(const unsigned char* matrix, int ld, const float* scales, const int* src,
                        const unsigned char* q, const float* qscale, const int* allowed,
                        int n_filter, int nq, int row_bytes, int n_sweep, int k, float* vals,
                        int* rows, void* workspace, cudaStream_t stream) {
  const int nblk = n_blocks(n_sweep);
  const int kc = cand_per_block(k);
  cudaError_t err = cudaFuncSetAttribute(scan_slab<kDtype, kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSlabSmem));
  if (err != cudaSuccess) return err;
  u64* cand = static_cast<u64*>(workspace);
  const dim3 grid((nq + kSlabQ - 1) / kSlabQ, nblk);
  scan_slab<kDtype, kLayout><<<grid, kThreads, kSlabSmem, stream>>>(
      matrix, ld, scales, src, q, qscale, allowed, n_filter, nq, row_bytes, n_sweep, kc, nblk, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pass2(cand, nq, nblk * kc, k, vals, rows, stream);
}

}  // namespace

extern "C" {

// K4 (dtype 2: int8 matrix with (N,) f32 row scales, int8 queries with
// (Q,) f32 scales; no other dtype).  Rows must be a multiple of 128 bytes.
// Workspace: as perceive_scan_topk_workspace.
int perceive_scan_topk_slab(const void* matrix, int dtype, const float* scales, const int* src,
                            const void* q, const float* qscale, const int* allowed,
                            int n_filter, int nq, int d, int n_sweep, int k, float* vals,
                            int* rows, void* workspace, void* stream) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || n_blocks(n_sweep) > 65535 || dtype != kInt8 ||
      d % kSlice || scales == nullptr || qscale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_slab<kInt8, kRowMajor>(
      static_cast<const unsigned char*>(matrix), 0, scales, src, static_cast<const unsigned char*>(q), qscale,
      allowed, n_filter, nq, d, n_sweep, k, vals, rows, workspace, static_cast<cudaStream_t>(stream)));
}

// K8: K4 over the int2 tier's transposed (d, ld) int8 companion (ld, its
// capacity, a multiple of 4).  d a multiple of 128.
int perceive_scan_topk_int8t_slab(const void* m8t, int ld, const float* scales, const int* src,
                                  const void* q, const float* qscale, const int* allowed,
                                  int n_filter, int nq, int d, int n_sweep, int k, float* vals,
                                  int* rows, void* workspace, void* stream) {
  if (!common_args_ok(nq, n_sweep, k, d, n_filter) || n_blocks(n_sweep) > 65535 || d % kSlice ||
      ld % 4 || n_sweep > ld || scales == nullptr || qscale == nullptr ||
      reinterpret_cast<uintptr_t>(m8t) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_slab<kInt8, kTransposed>(
      static_cast<const unsigned char*>(m8t), ld, scales, src, static_cast<const unsigned char*>(q),
      qscale, allowed, n_filter, nq, d, n_sweep, k, vals, rows, workspace,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
