// Fused multi-head attention for the encoder's long sequence buckets.
//
// Replaces the TPU kernel perceive_tpu/ops/attention.py `fused_attention`
// (`_attn_kernel`), which the JAX encoder routes buckets of 384 tokens and
// up to.
//
// What bounds it on the H100: the (S, S) scores of a head, which must stay
// on chip (512 x 512 f32 is 1 MB per head, far past a block's shared
// memory), and the K/V rows every query of the head reads.
//
// Design.  One block per (tile of 64 queries, head, batch row).  The head's
// K and V (S <= 512 rows) sit in dynamic shared memory, K rows padded by one
// 32-bit word so the lanes of a warp, each on its own key, hit distinct
// banks.  Each warp takes one query at a time: every lane scores the keys
// lane, lane+32, ... in registers (S/32 <= 16 of them), so a query's score
// row never leaves the chip; max and sum run as warp shuffles (a plain
// two-pass softmax in f32, no online rescaling).  The probabilities go to a
// per-warp shared row, rounded to v's dtype as the TPU kernel rounds them,
// and each lane then accumulates its output dims over all keys in f32.  The
// f32 sum is divided by l after the product, as on the TPU.

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

template <> struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float2 pair(const uint32_t* w, int i) {
    const uint32_t u = w[i];
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ __forceinline__ static __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
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

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, or 0 when the shape is not taken.
// dtype: 0 = float32, 1 = bfloat16.
size_t perceive_attention_smem(int dtype, int S, int DH) {
  if (S < 1 || S > kMaxSeq || DH < 2 || DH > kMaxHeadDim || DH % 2) return 0;
  const size_t bytes = dtype == 0 ? smem_bytes<float>(S, DH) : smem_bytes<__nv_bfloat16>(S, DH);
  return bytes <= kSmemLimit ? bytes : 0;
}

int perceive_attention(const void* q, const void* k, const void* v, const int* mask, void* out,
                       int dtype, int B, int S, int NH, int DH, float scale, void* stream) {
  if (B < 1 || NH < 1 || perceive_attention_smem(dtype, S, DH) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(q, k, v, mask, out, B, S, NH, DH, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, mask, out, B, S, NH, DH, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
