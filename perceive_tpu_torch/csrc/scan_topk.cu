// Exact scan with top-k selection over the device embedding matrix.
//
// Replaces the TPU kernel perceive_tpu/ops/topk.py `pallas_topk_unsorted`
// (`_scan_kernel` + `_merge_tile_topk`), the bf16/f32 exact tier.
//
// What bounds it on the H100: device-memory bytes.  One sweep of a
// 1M x 384 bf16 matrix reads 768 MB; a query costs 2*D flops per 2*D bytes,
// far below the card's flop/byte balance, so the scan is a streaming read.
//
// Design.  The TPU kernel carries one (Q, k) buffer across a grid that runs
// in order on one core.  Here blocks run in parallel and share nothing, so
// the selection is two passes:
//   pass 1  a block owns kRows consecutive rows and a tile of up to
//           kQueryTile queries (shared memory is sized to the tile, so a
//           single query leaves room for more blocks per SM).  One warp per
//           row streams the row with 16-byte loads (read once per query
//           tile), the dot products accumulate in f32 against the queries
//           staged in shared memory, masked rows get no score, and a
//           block-wide radix select keeps the block's best min(k, kRows)
//           candidates per query, written to a workspace.
//   pass 2  one block per query radix-selects the top k of all candidates,
//           bitonic-sorts them in shared memory and writes (score, row).
// A candidate is a 64-bit key: the order-preserving bits of the f32 score
// above the complement of the row index.  Keys are unique, so selection is
// exact, and equal scores order by the lower row first.  Key 0 marks "no
// row" (masked, or past the sweep); slots past the number of matching rows
// come out as (-inf, -1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 512;        // rows per pass-1 block
constexpr int kQueryTile = 16;    // queries per pass-1 block
constexpr int kMaxDim = 1024;
constexpr int kMaxK = 8192;
constexpr int kMaxFilter = 16;
constexpr int kAllowAll = -2;     // allowed[0] sentinel: no source filter

struct SelectScratch {
  unsigned int hist[256];
  unsigned int count;
  int digit;
  unsigned int above;
  unsigned int bin;
};

__device__ __forceinline__ uint32_t float_order(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 make_key(float score, int row) {
  score += 0.0f;  // -0 -> +0: equal scores must tie on the row alone
  return (static_cast<u64>(float_order(score)) << 32) |
         static_cast<u64>(0xffffffffu - static_cast<uint32_t>(row));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned int warp_sum_u(unsigned int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Calls fn(key(i)) for this thread's share of i in [0, n), four reads in
// flight per thread (a selection streams its keys several times, and one
// block per query leaves few threads to hide the read latency).  Every
// thread runs the same number of rounds; past n it sees key 0.
template <class KeyFn, class Fn>
__device__ __forceinline__ void for_each_key(const KeyFn& key, int n, Fn fn) {
  constexpr int kUnroll = 4;
  for (int i0 = 0; i0 < n; i0 += kUnroll * blockDim.x) {
    u64 kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      kv[u] = i < n ? key(i) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fn(kv[u]);
  }
}

// Threshold T such that the non-zero keys >= T are exactly the best
// min(k, #non-zero) keys.  key(i) for i in [0, n).  Block-wide; every
// thread of the block must call it.
template <class KeyFn>
__device__ u64 select_threshold(const KeyFn& key, int n, int k, SelectScratch& ss) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) ss.count = 0;
  __syncthreads();
  unsigned int local = 0;
  for_each_key(key, n, [&](u64 kv) { local += kv != 0ull; });
  local = warp_sum_u(local);
  if (lane == 0 && local) atomicAdd(&ss.count, local);
  __syncthreads();
  const unsigned int nonzero = ss.count;
  if (nonzero <= static_cast<unsigned int>(k)) return 1ull;

  u64 prefix = 0, mask = 0;
  unsigned int kk = static_cast<unsigned int>(k);
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) ss.hist[i] = 0;
    __syncthreads();
    for_each_key(key, n, [&](u64 kv) {
      if (kv != 0ull && (kv & mask) == prefix) atomicAdd(&ss.hist[(kv >> shift) & 0xffu], 1u);
    });
    __syncthreads();
    if (tid < 32) {
      // lane l owns bins 255-8l .. 248-8l, highest first
      unsigned int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = ss.hist[255 - (lane * 8 + j)];
        sum += c[j];
      }
      unsigned int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned int excl = incl - sum;
      if (excl < kk && kk <= incl) {
        unsigned int above = excl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= kk) {
            ss.digit = 255 - (lane * 8 + j);
            ss.above = above;
            ss.bin = c[j];
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    const u64 digit = static_cast<u64>(ss.digit);
    kk -= ss.above;
    const unsigned int bin = ss.bin;
    prefix |= digit << shift;
    mask |= 0xffull << shift;
    if (bin == kk) break;  // every key under this prefix is selected
  }
  return prefix;
}

// Copy the non-zero keys >= thr to out (in no particular order); returns
// how many.  Block-wide; one atomic per warp and round.
template <class KeyFn>
__device__ int select_collect(const KeyFn& key, int n, u64 thr, u64* out, SelectScratch& ss) {
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (threadIdx.x == 0) ss.count = 0;
  __syncthreads();
  for_each_key(key, n, [&](u64 kv) {
    const bool take = kv != 0ull && kv >= thr;
    const unsigned int ballot = __ballot_sync(0xffffffffu, take);
    unsigned int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&ss.count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (take) out[base + __popc(ballot & ((1u << lane) - 1u))] = kv;
  });
  __syncthreads();
  return static_cast<int>(ss.count);
}

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ __forceinline__ static float to_float(float v) { return v; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
};

struct ScoreKeys {
  const float* sc;
  int row0;
  __device__ u64 operator()(int i) const {
    const float s = sc[i];
    return s == -INFINITY ? 0ull : make_key(s, row0 + i);
  }
};

struct GlobalKeys {
  const u64* keys;
  __device__ u64 operator()(int i) const { return keys[i]; }
};

// Pass 1: grid (row blocks, query tiles).  Workspace layout
// cand[q][block][kc].
template <typename T>
__global__ void __launch_bounds__(kThreads) scan_pass1(
    const T* __restrict__ matrix, const int* __restrict__ src, const T* __restrict__ q,
    const int* __restrict__ allowed, int n_filter, int nq, int d, int n_sweep, int kc,
    int qt, u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [qt][d]
  float* sc = qs + qt * d;                     // [qt][kRows]
  __shared__ SelectScratch ss;
  __shared__ int allow[kMaxFilter];

  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blk = blockIdx.x;
  const int q0 = blockIdx.y * qt;
  const int qn = min(qt, nq - q0);
  const int row0 = blk * kRows;
  const int rn = min(kRows, n_sweep - row0);

  for (int i = tid; i < qn * d; i += kThreads)
    qs[i] = Vec<T>::to_float(q[static_cast<size_t>(q0) * d + i]);
  if (tid < kMaxFilter) allow[tid] = tid < n_filter ? allowed[tid] : -9;
  __syncthreads();
  const bool allow_all = allow[0] == kAllowAll;
  const int nvec = d / V;

  for (int r = warp; r < rn; r += kWarps) {
    const int row = row0 + r;
    const int s = src[row];
    bool ok = s >= 0;
    if (ok && !allow_all) {
      bool hit = false;
      for (int f = 0; f < n_filter; ++f) hit |= s == allow[f];
      ok = hit;
    }
    if (!ok) {  // warp-uniform: one warp owns the row
      if (lane < qn) sc[lane * kRows + r] = -INFINITY;
      continue;
    }
    float acc[kQueryTile];
#pragma unroll
    for (int i = 0; i < kQueryTile; ++i) acc[i] = 0.f;
    const T* mrow = matrix + static_cast<size_t>(row) * d;
    for (int c = lane; c < nvec; c += 32) {
      float x[V];
      Vec<T>::load(mrow + c * V, x);
#pragma unroll
      for (int i = 0; i < kQueryTile; ++i) {
        if (i < qn) {
          const float4* qq = reinterpret_cast<const float4*>(qs + i * d + c * V);
#pragma unroll
          for (int e = 0; e < V / 4; ++e) {
            const float4 w = qq[e];
            acc[i] = fmaf(x[4 * e], w.x, acc[i]);
            acc[i] = fmaf(x[4 * e + 1], w.y, acc[i]);
            acc[i] = fmaf(x[4 * e + 2], w.z, acc[i]);
            acc[i] = fmaf(x[4 * e + 3], w.w, acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQueryTile; ++i) {
      if (i < qn) {
        const float v = warp_sum(acc[i]);
        if (lane == 0) sc[i * kRows + r] = v;
      }
    }
  }
  __syncthreads();

  for (int i = 0; i < qn; ++i) {
    u64* out = cand + (static_cast<size_t>(q0 + i) * gridDim.x + blk) * kc;
    const ScoreKeys key{sc + i * kRows, row0};
    int got;
    if (kc >= rn) {
      for (int j = tid; j < rn; j += kThreads) out[j] = key(j);
      got = rn;
    } else {
      const u64 thr = select_threshold(key, rn, kc, ss);
      got = select_collect(key, rn, thr, out, ss);
    }
    for (int j = got + tid; j < kc; j += kThreads) out[j] = 0ull;
    __syncthreads();
  }
}

// Pass 2: one block per query; sorted best-first output.
__global__ void __launch_bounds__(kThreads) scan_pass2(
    const u64* __restrict__ cand, int ncand, int k, int sort_n, float* __restrict__ vals,
    int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);  // [sort_n], sort_n = pow2 >= k
  __shared__ SelectScratch ss;
  const int tid = threadIdx.x;
  const GlobalKeys key{cand + static_cast<size_t>(blockIdx.x) * ncand};

  const u64 thr = select_threshold(key, ncand, k, ss);
  const int got = select_collect(key, ncand, thr, buf, ss);
  for (int i = got + tid; i < sort_n; i += kThreads) buf[i] = 0ull;
  __syncthreads();

  // bitonic sort, descending
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < sort_n / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = buf[lo], b = buf[hi];
        if ((a < b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  float* ov = vals + static_cast<size_t>(blockIdx.x) * k;
  int* orow = rows + static_cast<size_t>(blockIdx.x) * k;
  for (int i = tid; i < k; i += kThreads) {
    const u64 kv = buf[i];
    if (kv == 0ull) {
      ov[i] = -INFINITY;
      orow[i] = -1;
    } else {
      ov[i] = order_float(static_cast<uint32_t>(kv >> 32));
      orow[i] = static_cast<int>(0xffffffffu - static_cast<uint32_t>(kv & 0xffffffffull));
    }
  }
}

inline int n_blocks(int n_sweep) { return (n_sweep + kRows - 1) / kRows; }
inline int cand_per_block(int k) { return k < kRows ? k : kRows; }
inline int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

template <typename T>
cudaError_t launch(const void* matrix, const int* src, const void* q, const int* allowed,
                   int n_filter, int nq, int d, int n_sweep, int k, float* vals, int* rows,
                   void* workspace, cudaStream_t stream) {
  const int nblk = n_blocks(n_sweep);
  const int kc = cand_per_block(k);
  const int qt = nq < kQueryTile ? nq : kQueryTile;  // queries per block
  const size_t smem1 = static_cast<size_t>(qt) * (d + kRows) * sizeof(float);
  const int sort_n = pow2_at_least(k);
  const size_t smem2 = static_cast<size_t>(sort_n) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(scan_pass1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scan_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  u64* cand = static_cast<u64*>(workspace);
  const dim3 grid1(nblk, (nq + qt - 1) / qt);
  scan_pass1<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(matrix), src, static_cast<const T*>(q), allowed, n_filter, nq, d,
      n_sweep, kc, qt, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_pass2<<<nq, kThreads, smem2, stream>>>(cand, nblk * kc, k, sort_n, vals, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace bytes the caller allocates for one launch.
size_t perceive_scan_topk_workspace(int nq, int n_sweep, int k) {
  return static_cast<size_t>(nq) * n_blocks(n_sweep) * cand_per_block(k) * sizeof(u64);
}

int perceive_scan_topk_max_k() { return kMaxK; }
int perceive_scan_topk_max_dim() { return kMaxDim; }

// dtype: 0 = float32, 1 = bfloat16 (matrix and queries alike).
int perceive_scan_topk(const void* matrix, int dtype, const int* src, const void* q,
                       const int* allowed, int n_filter, int nq, int d, int n_sweep, int k,
                       float* vals, int* rows, void* workspace, void* stream) {
  if (nq < 1 || n_sweep < 1 || k < 1 || k > kMaxK || d < 1 || d > kMaxDim ||
      n_filter < 1 || n_filter > kMaxFilter)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (d % Vec<float>::N) return static_cast<int>(cudaErrorInvalidValue);
    err = launch<float>(matrix, src, q, allowed, n_filter, nq, d, n_sweep, k, vals, rows,
                        workspace, s);
  } else if (dtype == 1) {
    if (d % Vec<__nv_bfloat16>::N) return static_cast<int>(cudaErrorInvalidValue);
    err = launch<__nv_bfloat16>(matrix, src, q, allowed, n_filter, nq, d, n_sweep, k, vals,
                                rows, workspace, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* perceive_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
