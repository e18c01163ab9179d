// Fused multi-head attention for the encoder's long sequence buckets (K11).
//
// Replaces the TPU kernel perceive_tpu/ops/attention.py `fused_attention`
// (`_attn_kernel`), which the JAX encoder routes buckets of 384 tokens and
// up to.  Function: s = q.k^T / sqrt(DH) + (1 - mask) * -1e9 in f32, m the
// row max, p = exp(s - m), l = sum p in f32, out = (bf16(p) . v) / l.
//
// What bounds it on the H100: at the main path's (64, 512, 12, 32) bf16 the
// exponentials.  B * NH * S^2 = 201M of them take 0.052 ms at the card's
// ~3.9e12 special-function operations a second (132 SMs x 16 a clock),
// more than the 0.030 ms the bytes take; q.k and p.v are 0.9 GFLOP each,
// 0.001 ms on the tensor cores.
//
// Design of the bf16 path (`attention_tc`).  One block of 4 warps per (tile
// of 64 queries, head, batch row); each warp owns 16 query rows, whose
// fragments it loads once from shared memory with ldmatrix.  K and V stream
// through a ring of shared-memory stages (3; 2 at DH = 128) in tiles of 64
// keys, filled by cp.async and waited on with cp.async.wait_group, rows
// padded by 16 bytes so ldmatrix hits 32 distinct banks.  q.k^T and p.v run
// on the tensor cores (mma.sync m16n8k16 bf16 -> f32); the C fragment of
// q.k^T becomes the A fragment of p.v in registers, so p never touches
// shared memory.  The softmax keeps the TPU kernel's rounding with two
// sweeps over the key tiles: the first computes q.k^T and the row max
// only, the second recomputes q.k^T, forms p = exp(s - m) relative to the
// true row max, sums l from the unrounded f32 p and multiplies bf16(p) by
// v (no online rescaling).  Scores are kept times log2 e (folded into the
// scale and the mask bias), so each p is one ex2.approx, as __expf would
// compute it, without the multiply.  Key tiles whose mask is all 0 are skipped when
// the batch row keeps any key: there exp(-1e9 + s - m) is 0.0 in f32, so
// they add nothing to l or to the output (a row that keeps no key runs
// every tile).  Keys past S score -inf and their V rows are zero-filled.
//
// f32 inputs take the first version's SIMT body (`attention_kernel`): one
// block per (64 queries, head, batch row) holding the head's K and V in
// shared memory, each warp scoring one query at a time with f32 FMAs.  No
// main-path call uses it (the encoder computes in bf16 on the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryTile = 64;
constexpr int kMaxSeq = 512;
constexpr int kMaxKeysPerLane = kMaxSeq / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxDimsPerLane = kMaxHeadDim / 32;
constexpr float kNeg = -1e9f;
constexpr size_t kSmemLimit = 232448;  // per-block opt-in maximum on sm_90

template <typename T> struct Elem;

template <> struct Elem<float> {
  __device__ __forceinline__ static float2 pair(const uint32_t* w, int i) {
    return make_float2(__uint_as_float(w[2 * i]), __uint_as_float(w[2 * i + 1]));
  }
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float from(float v) { return v; }
};

// 32-bit words in one K row of shared memory (row plus one pad word)
template <typename T>
__host__ __device__ inline int k_row_words(int dh) {
  return dh * static_cast<int>(sizeof(T)) / 4 + 1;
}

// 32-bit words of the V block, rounded up to 16 bytes
template <typename T>
__host__ __device__ inline int v_block_words(int s, int dh) {
  return (s * dh * static_cast<int>(sizeof(T)) / 4 + 3) / 4 * 4;
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int s, int dh) {
  const int s_pad = (s + 31) / 32 * 32;
  return static_cast<size_t>(s_pad) * k_row_words<T>(dh) * 4  // K
         + static_cast<size_t>(v_block_words<T>(s, dh)) * 4   // V
         + static_cast<size_t>(kQueryTile) * dh * 4           // queries, f32
         + static_cast<size_t>(kWarps) * s_pad * 4            // probabilities
         + static_cast<size_t>(s_pad) * 4;                    // mask bias
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q/k/v/out: (B, S, NH, DH); mask: (B, S) int32, 1 = keep.
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, T* __restrict__ out, int S, int NH, int DH, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s_pad = (S + 31) / 32 * 32;
  const int kw = k_row_words<T>(DH);               // words per padded K row
  const int vw = DH * static_cast<int>(sizeof(T)) / 4;  // words per V row
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem);     // [s_pad][kw]
  uint32_t* vs = ks + static_cast<size_t>(s_pad) * kw;  // [S][vw]
  float* qs = reinterpret_cast<float*>(vs + v_block_words<T>(S, DH));  // [64][DH]
  float* ps = qs + kQueryTile * DH;                     // [kWarps][s_pad]
  float* bias = ps + kWarps * s_pad;                    // [s_pad]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQueryTile;
  const int qn = min(kQueryTile, S - q0);
  const size_t row_stride = static_cast<size_t>(NH) * DH;  // elements between tokens
  const size_t head0 = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * DH;

  const uint32_t* kg = reinterpret_cast<const uint32_t*>(k + head0);
  const uint32_t* vg = reinterpret_cast<const uint32_t*>(v + head0);
  const int stride_w = static_cast<int>(row_stride * sizeof(T) / 4);
  for (int i = tid; i < s_pad * vw; i += kThreads) {
    const int j = i / vw, w = i - j * vw;
    ks[j * kw + w] = j < S ? kg[static_cast<size_t>(j) * stride_w + w] : 0u;
    if (j < S) vs[j * vw + w] = vg[static_cast<size_t>(j) * stride_w + w];
  }
  for (int j = tid; j < s_pad; j += kThreads)
    bias[j] = j < S ? (1.0f - static_cast<float>(mask[static_cast<size_t>(b) * S + j])) * kNeg
                    : 0.f;
  for (int i = tid; i < qn * DH; i += kThreads) {
    const int r = i / DH, c = i - r * DH;
    qs[i] = Elem<T>::load(q + head0 + static_cast<size_t>(q0 + r) * row_stride + c);
  }
  __syncthreads();

  const int n_keys = s_pad / 32;  // keys per lane
  const int n_pairs = DH / 2;
  float* prow = ps + warp * s_pad;
  for (int r = warp; r < qn; r += kWarps) {
    const float2* qq = reinterpret_cast<const float2*>(qs + r * DH);
    float s[kMaxKeysPerLane];
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) s[t] = 0.f;
    for (int p = 0; p < n_pairs; ++p) {
      const float2 a = qq[p];
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        if (t < n_keys) {
          const float2 kk = Elem<T>::pair(ks + (lane + 32 * t) * kw, p);
          s[t] = fmaf(a.x, kk.x, s[t]);
          s[t] = fmaf(a.y, kk.y, s[t]);
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      if (t < n_keys) {
        const int j = lane + 32 * t;
        s[t] = j < S ? s[t] * scale + bias[j] : -INFINITY;
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      if (t < n_keys) {
        const int j = lane + 32 * t;
        if (j < S) {
          const float p = expf(s[t] - m);
          l += p;
          prow[j] = Elem<T>::round(p);
        }
      }
    }
    l = warp_sum(l);
    __syncwarp();

    float acc[kMaxDimsPerLane];
#pragma unroll
    for (int u = 0; u < kMaxDimsPerLane; ++u) acc[u] = 0.f;
    const T* vrow = reinterpret_cast<const T*>(vs);
    for (int j = 0; j < S; ++j) {
      const float pj = prow[j];
#pragma unroll
      for (int u = 0; u < kMaxDimsPerLane; ++u) {
        const int dd = lane + 32 * u;
        if (dd < DH) acc[u] = fmaf(pj, Elem<T>::load(vrow + j * DH + dd), acc[u]);
      }
    }
    T* orow = out + head0 + static_cast<size_t>(q0 + r) * row_stride;
#pragma unroll
    for (int u = 0; u < kMaxDimsPerLane; ++u) {
      const int dd = lane + 32 * u;
      if (dd < DH) orow[dd] = Elem<T>::from(acc[u] / l);
    }
    __syncwarp();  // prow is rewritten by this warp's next query
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* mask, void* out,
                   int B, int S, int NH, int DH, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(S, DH);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQueryTile - 1) / kQueryTile, NH, B);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), S, NH, DH, scale);
  return cudaGetLastError();
}

// ---- the bf16 path: tensor cores --------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps, 16 query rows each
constexpr int kTcQueries = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeyTile = 64;
constexpr int kMaxKeyTiles = kMaxSeq / kKeyTile;

// bytes of one padded shared-memory row of DH bf16 values
__host__ __device__ constexpr int tc_pitch(int dh) { return 2 * dh + 16; }
__host__ __device__ constexpr int tc_stages(int dh) { return dh >= 128 ? 2 : 3; }

__host__ __device__ constexpr size_t tc_smem_bytes(int dh) {
  return static_cast<size_t>(kTcQueries) * tc_pitch(dh)                       // Q
         + static_cast<size_t>(tc_stages(dh)) * 2 * kKeyTile * tc_pitch(dh)   // K, V ring
         + kMaxSeq * sizeof(float)                                            // mask bias
         + (2 * kMaxKeyTiles + 1) * sizeof(int);                              // live tiles
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment coordinates (m16n8k16): lane = 4g + t; a C fragment holds
// (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, same cols) in c[2..3].
template <int DH>
__global__ void __launch_bounds__(kTcThreads) attention_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int S, int NH, float scale) {
  constexpr int P = tc_pitch(DH);
  constexpr int kChunks = DH / 8;  // 16-byte chunks of a row
  constexpr int kSteps = DH / 16;  // k-steps of q.k^T
  constexpr int kDimTiles = DH / 8;  // n-tiles of p.v
  constexpr int kStages = tc_stages(DH);
  constexpr int kStageBytes = 2 * kKeyTile * P;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sq = smem;                                    // [64][P]
  unsigned char* ring = sq + kTcQueries * P;                   // [kStages][K, V][64][P]
  float* bias = reinterpret_cast<float*>(ring + kStages * kStageBytes);  // [kMaxSeq]
  int* live = reinterpret_cast<int*>(bias + kMaxSeq);          // [kMaxKeyTiles]
  int* tiles = live + kMaxKeyTiles;                            // [kMaxKeyTiles]
  int* n_live = tiles + kMaxKeyTiles;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTcQueries;
  const size_t row_stride = static_cast<size_t>(NH) * DH;
  const size_t head0 = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * DH;
  const int n_tiles = (S + kKeyTile - 1) / kKeyTile;
  const float scale2 = scale * kLog2e;  // scores in base 2: exp(s - m) = 2^(s log2 e - m log2 e)

  // the queries: cp.async group 0
  for (int c = tid; c < kTcQueries * kChunks; c += kTcThreads) {
    const int r = c / kChunks, ch = c - r * kChunks;
    const bool ok = q0 + r < S;
    cp_async16(sq + r * P + ch * 16, q + (ok ? head0 + (q0 + r) * row_stride + ch * 8 : 0), ok);
  }
  cp_async_commit();

  if (tid < kMaxKeyTiles) live[tid] = 0;
  __syncthreads();
  for (int j = tid; j < n_tiles * kKeyTile; j += kTcThreads) {
    float bj = -INFINITY;  // the mask bias, times log2 e as the scores are
    if (j < S) {
      const int m = mask[static_cast<size_t>(b) * S + j];
      bj = (1.0f - static_cast<float>(m)) * kNeg * kLog2e;
      if (m != 0) live[j / kKeyTile] = 1;
    }
    bias[j] = bj;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (live[i]) tiles[n++] = i;
    if (n == 0)  // no kept key: every key counts alike, run every tile
      for (; n < n_tiles; ++n) tiles[n] = n;
    *n_live = n;
  }
  __syncthreads();
  const int nl = *n_live;
  const int n_steps = 2 * nl;  // sweep 1: K of each live tile; sweep 2: K and V

  // step i fills ring stage i % kStages; every step commits one group (maybe empty)
  auto load_step = [&](int i) {
    if (i < n_steps) {
      const bool with_v = i >= nl;
      const int key0 = tiles[with_v ? i - nl : i] * kKeyTile;
      unsigned char* dk = ring + (i % kStages) * kStageBytes;
      unsigned char* dv = dk + kKeyTile * P;
      for (int c = tid; c < kKeyTile * kChunks; c += kTcThreads) {
        const int r = c / kChunks, ch = c - r * kChunks;
        const bool ok = key0 + r < S;
        const size_t off = ok ? head0 + (key0 + r) * row_stride + ch * 8 : 0;
        cp_async16(dk + r * P + ch * 16, k + off, ok);
        if (with_v) cp_async16(dv + r * P + ch * 16, v + off, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_step(i);

  uint32_t qf[kSteps][4];
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};
  float o[kDimTiles][4];
#pragma unroll
  for (int d = 0; d < kDimTiles; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kStages - 2>();  // step i (and the queries) landed
    __syncthreads();               // ... for every thread; stage (i - 1) is free
    load_step(i + kStages - 1);
    if (i == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        ldmatrix_x4(qf[ks], sq + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                (ks * 16 + (lane >> 4) * 8) * 2);
    }
    const bool sweep2 = i >= nl;
    const int key0 = tiles[sweep2 ? i - nl : i] * kKeyTile;
    const unsigned char* dk = ring + (i % kStages) * kStageBytes;

    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, dk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P +
                            (ks * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(sc[2 * np], qf[ks], bf[0], bf[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = fmaf(sc[n][e], scale2, bias[key0 + n * 8 + 2 * t + (e & 1)]);

    if (!sweep2) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        m_row[0] = fmaxf(m_row[0], fmaxf(sc[n][0], sc[n][1]));
        m_row[1] = fmaxf(m_row[1], fmaxf(sc[n][2], sc[n][3]));
      }
      if (i == nl - 1) {  // the row max over all keys, across the quad
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
          m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
        }
      }
      continue;
    }
    // p = exp(s - m): l from the f32 p, the product from bf16(p)
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ex2(sc[n][e] - m_row[e >> 1]);
      l_row[0] += p[0] + p[1];
      l_row[1] += p[2] + p[3];
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    const unsigned char* dv = dk + kKeyTile * P;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kDimTiles / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, dv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  (dp * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(o[2 * dp], pa[kk], bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + head0 + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int d = 0; d < kDimTiles; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(o[d][2 * r] / l_row[r], o[d][2 * r + 1] / l_row[r]);
  }
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* mask, void* out, int B,
                      int S, int NH, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(attention_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcQueries - 1) / kTcQueries, NH, B);
  attention_tc<DH><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), S, NH, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* mask, void* out, int B,
                        int S, int NH, int DH, float scale, cudaStream_t s) {
  switch (DH) {
    case 16: return launch_tc<16>(q, k, v, mask, out, B, S, NH, scale, s);
    case 32: return launch_tc<32>(q, k, v, mask, out, B, S, NH, scale, s);
    case 64: return launch_tc<64>(q, k, v, mask, out, B, S, NH, scale, s);
    case 128: return launch_tc<128>(q, k, v, mask, out, B, S, NH, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, or 0 when the shape is not taken.
// dtype: 0 = float32 (any even DH <= 128), 1 = bfloat16 (DH 16, 32, 64 or
// 128; q, k, v 16-byte aligned).
size_t perceive_attention_smem(int dtype, int S, int DH) {
  if (S < 1 || S > kMaxSeq || DH < 2 || DH > kMaxHeadDim || DH % 2) return 0;
  if (dtype == 1) return (DH == 16 || DH == 32 || DH == 64 || DH == 128) ? tc_smem_bytes(DH) : 0;
  if (dtype != 0) return 0;
  const size_t bytes = smem_bytes<float>(S, DH);
  return bytes <= kSmemLimit ? bytes : 0;
}

int perceive_attention(const void* q, const void* k, const void* v, const int* mask, void* out,
                       int dtype, int B, int S, int NH, int DH, float scale, void* stream) {
  if (B < 1 || NH < 1 || perceive_attention_smem(dtype, S, DH) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(q, k, v, mask, out, B, S, NH, DH, scale, s));
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bf16(q, k, v, mask, out, B, S, NH, DH, scale, s));
}

}  // extern "C"
