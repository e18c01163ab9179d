// K6: the exact top-kc of each row of (Q, n) masked f32 scores, for the
// int2 tier's coarse pass (after K5, and over K10's buffer on the tiletop
// route; scan_int2.cu).
//
// Replaces the selection the JAX package runs after `pallas_int2_scores`:
// `jax.lax.approx_max_k` (perceive_tpu/ops/topk.py, an XLA custom call of
// the TPU) and the exact `_select_topk_hier`.  The port's select is exact:
// the floor it returns is the kc-th score, so the escalation bound of the
// coarse pass is exact too.
//
// Order: the key of entry i is (order-preserving bits u of score + 0.0,
// then the lower row first), so equal scores go to the lower row first and
// -0.0 ties +0.0; -inf entries (masked rows) order below every finite
// score and among themselves by row.  Output: the kc selected (score, row)
// pairs ORDERED BY ROW (the fine phase gathers the candidates' columns in
// address order), and the floor, the kc-th entry's score.
//
// What bounds it on the H100: bytes, read from the 50 MB L2 right after
// K5 wrote them.  At Q = 1 and n = 3,809,280 the scores are 15.2 MB (4.5 us
// at 3.35 TB/s).  The first kernel read them 5 times in ten launches (an
// init, three rounds of a histogram and a one-block find, a count, a scan,
// an ordered write with two block scans per 256 entries): 0.12 ms.  This
// design, a radix select with candidate filtering in the spirit of AIR
// top-k (Zhang et al., SC'23), reads them twice in three launches:
//   memset  the first level's histograms and tickets (only these need
//           zeros);
//   pass 1  rounds of 16,384 entries, 16 adjacent ones (four 16-byte
//           loads) a thread: every block adds the top 12 bits of its
//           entries' u into a shared histogram and flushes it into the
//           query's; the last block to finish (an atomic ticket after a
//           __threadfence) finds the bin d1 of the kc-th key;
//   pass 2  the same rounds: the entries at or above bin d1 go to a
//           candidate region in row order within the round (a block scan,
//           then one atomic reservation: the round's segment, noted in a
//           table), and those in d1's bin into the next level's histogram;
//           the last block finishes alone over the region (about kc
//           entries plus d1's bin): the 11-bit level, then a 9-bit one over
//           the region, give the exact kc-th value T and the number of
//           T-equal entries to take; the entries above T and equal to T of
//           each round (counted into shared memory) and their prefixes over
//           the rounds in row order; then the region in chunks, one entry a
//           thread in turn so that the loads and the writes coalesce, where
//           ballots give each entry the T-equal and the selected entries
//           before it in the region, and less those before its segment
//           plus its round's prefixes, its rank and its place: the output
//           is in row order with no sort.
// What holds it back: the finish is one block, so each of its steps costs
// an L2 round trip or a barrier, and pass 1's shared-memory atomics
// collide where the scores crowd a few bins (PERF.md section 6).
// Overflow: where the entries at or above d1 do not fit the region (dense
// ties at the kc-th score: a filter that leaves fewer than kc finite
// scores puts every -inf entry in d1's bin), pass 2 keeps only the entries
// above d1 and, for d1's bin, each round's count and its least and
// greatest u.  If the bin holds one value it is T, and the finish reads
// again only the rounds whose T-equal entries it takes (one warp a round);
// else it reads the scores again for the last level, and again to count
// and to write, one warp a round.  The result stays exact either way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kSelThreads = 1024;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kPer = 16;                            // entries a thread a round: four 16-byte quads
constexpr int kRoundShift = 14;                     // a round: kSelThreads * kPer = 16,384 entries
constexpr int kQuadsPerRound = kSelThreads * kPer / 4;
constexpr int kShift1 = 20;                         // pass 1: bits 31..20 of u
constexpr int kBins1 = 1 << (32 - kShift1);
constexpr int kShift2 = 9;                          // the finish: bits 19..9, then 8..0
constexpr int kBins2 = 1 << (kShift1 - kShift2);
constexpr int kBins3 = 1 << kShift2;
constexpr int kCap = 65536;                         // candidate region entries a query (at most n)
constexpr int kZeroWords = kBins1 + 4;              // a query's zeroed words: pass 1's histogram, its ticket
constexpr int kBatch = 8;                           // region entries a thread has in flight in the finish
constexpr int kSmemRounds = 4096;                   // the finish keeps its per-round counts in shared memory
                                                    // up to this many rounds (67M scores), else in the workspace
constexpr int kRoundFields = 6;                     // per round: gt, eq, eq_before, sel_before, eq0, sel0

struct SelState {     // one a query, written by pass 1's last block
  uint32_t d1;        // bits 31..20 of the kc-th key's u
  uint32_t kk;        // entries of d1's bin to take
  uint32_t over;      // the entries at or above d1 overflow the region
  uint32_t stored;    // the entries above d1 are in the region
  uint32_t minu;      // over: the least and the greatest u in d1's bin
  uint32_t maxu;
  uint32_t fill;      // region entries reserved
  uint32_t ticket;    // pass 2's blocks that are done
};

struct Seg {          // one a round, from pass 2
  int off, cnt;       // its entries in the region
  int bin;            // over: its entries in d1's bin
  int pad;
};

// The finish's per-round counts, kRoundFields arrays of `rounds` ints (in
// shared memory, or in the workspace past kSmemRounds): entries above T
// and equal to T; the T-equal and the selected entries of the rounds
// before it; the region's T-equal and selected entries before its
// segment.
struct RoundCounts {
  int* f;
  int rounds;
  __device__ int& gt(int rd) const { return f[rd]; }
  __device__ int& eq(int rd) const { return f[rounds + rd]; }
  __device__ int& eq_before(int rd) const { return f[2 * rounds + rd]; }
  __device__ int& sel_before(int rd) const { return f[3 * rounds + rd]; }
  __device__ int& eq0(int rd) const { return f[4 * rounds + rd]; }
  __device__ int& sel0(int rd) const { return f[5 * rounds + rd]; }
};

struct Found {
  uint32_t digit, above, count;
};

struct ScoreRow {     // one query's scores read in 16-byte quads
  const float* base;  // the row's first element rounded down to 16 bytes
  int n, mis, rounds; // quad j holds elements 4j - mis .. 4j - mis + 3
};

__device__ __forceinline__ ScoreRow score_row(const float* scores, int q, int n) {
  const float* row = scores + static_cast<size_t>(q) * n;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const long long quads = (static_cast<long long>(n) + mis + 3) / 4;
  return {row - mis, n, mis, static_cast<int>((quads + kQuadsPerRound - 1) / kQuadsPerRound)};
}

inline int max_rounds(int n) {
  return static_cast<int>(((static_cast<long long>(n) + 6) / 4 + kQuadsPerRound - 1) / kQuadsPerRound);
}
inline int region_cap(int n) { return n < kCap ? n : kCap; }

// The round of element e.
__device__ __forceinline__ int round_of(const ScoreRow& r, int e) { return (e + r.mis) >> kRoundShift; }

// Quads j .. j + Q - 1: v[4i + u] = element 4(j + i) - mis + u; returns the
// mask of those in [0, n).  The loads are issued before any is used.
template <int Q>
__device__ __forceinline__ unsigned load_quads(const ScoreRow& r, int j, float (&v)[4 * Q]) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int e0 = 4 * (j + i) - r.mis;
    if (e0 >= 0 && e0 + 4 <= r.n) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(r.base) + j + i);
      v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z, v[4 * i + 3] = x.w;
      m |= 0xfu << (4 * i);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[4 * i + u] = 0.f;
        if (e0 + u >= 0 && e0 + u < r.n) {
          v[4 * i + u] = __ldg(r.base + 4 * (j + i) + u);
          m |= 1u << (4 * i + u);
        }
      }
    }
  }
  return m;
}

__device__ __forceinline__ uint32_t key_of(float s) { return float_order(s + 0.0f); }

// h[bin] += 1 for each lane whose bin is not `none`; one atomic for the
// warp where every lane has the same bin (dense ties, -inf rows).
__device__ __forceinline__ void add_bin(uint32_t* h, uint32_t bin, uint32_t none) {
  const uint32_t b0 = __shfl_sync(0xffffffffu, bin, 0);
  if (__all_sync(0xffffffffu, bin == b0)) {
    if ((threadIdx.x & 31) == 0 && b0 != none) atomicAdd(&h[b0], 32u);
  } else if (bin != none) {
    atomicAdd(&h[bin], 1u);
  }
}

__device__ __forceinline__ int warp_excl_scan(int v, int* total) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  *total = __shfl_sync(0xffffffffu, incl, 31);
  return incl - v;
}

// Exclusive prefix of v over the block in thread order; *total gets the
// sum.  Every thread calls it; ws holds kSelWarps + 1 ints.
__device__ int block_excl_scan(int v, int* total, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int wt;
  const int x = warp_excl_scan(v, &wt);
  if (lane == 0) ws[warp] = wt;
  __syncthreads();
  if (warp == 0) {
    int all;
    const int w = ws[lane];
    const int wx = warp_excl_scan(w, &all);
    ws[lane] = wx;
    if (lane == 0) ws[kSelWarps] = all;
  }
  __syncthreads();
  *total = ws[kSelWarps];
  const int r = ws[warp] + x;
  __syncthreads();
  return r;
}

// For flags f (bit b: entry b * kSelThreads + threadIdx.x of a chunk),
// base[b] = the set flags of the chunk's entries before that one, and
// *total the chunk's; one ballot a bit, the warps' counts scanned in
// shared memory (sw: kBatch * kSelWarps + kBatch ints).  Block-wide.
__device__ void chunk_prefix(unsigned f, int (&base)[kBatch], int* total, int* sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  unsigned bal[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) bal[b] = __ballot_sync(0xffffffffu, (f >> b) & 1u);
  if (lane == 0)
#pragma unroll
    for (int b = 0; b < kBatch; ++b) sw[b * kSelWarps + warp] = __popc(bal[b]);
  __syncthreads();
  if (warp < kBatch) {
    int tot;
    const int x = warp_excl_scan(sw[warp * kSelWarps + lane], &tot);
    sw[warp * kSelWarps + lane] = x;
    if (lane == 0) sw[kBatch * kSelWarps + warp] = tot;
  }
  __syncthreads();
  int run = 0;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    base[b] = run + sw[b * kSelWarps + warp] + __popc(bal[b] & lt);
    run += sw[kBatch * kSelWarps + b];
  }
  *total = run;
  __syncthreads();
}

// The bin of the kk-th largest entry over NB bins (count(b) for bin b),
// with the entries above it and its own count.  Block-wide.
template <int NB, class Count>
__device__ Found find_bin(const Count& count, uint32_t kk, int* ws, Found* out) {
  constexpr int kBinsPer = NB >= kSelThreads ? NB / kSelThreads : 1;
  const int first = threadIdx.x * kBinsPer;  // bins counted from the top
  uint32_t c[kBinsPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kBinsPer; ++j) {
    c[j] = first + j < NB ? count(NB - 1 - (first + j)) : 0u;
    sum += c[j];
  }
  int total;
  const uint32_t excl = static_cast<uint32_t>(block_excl_scan(static_cast<int>(sum), &total, ws));
  if (excl < kk && kk <= excl + sum) {  // exactly one thread
    uint32_t above = excl;
#pragma unroll
    for (int j = 0; j < kBinsPer; ++j) {
      if (above + c[j] >= kk) {
        *out = Found{static_cast<uint32_t>(NB - 1 - (first + j)), above, c[j]};
        break;
      }
      above += c[j];
    }
  }
  __syncthreads();
  return *out;
}

// Pass 1 over rounds r0, r0 + step, ...: the top 12 bits of each entry's u
// into h (kBins1 + 1 words; the last one takes nothing).
__device__ void pass1_rounds(const ScoreRow& r, int r0, int step, uint32_t* h) {
  for (int rd = r0; rd < r.rounds; rd += step) {  // block-uniform
    float v[kPer];
    const unsigned m = load_quads<kPer / 4>(r, rd * kQuadsPerRound + 4 * threadIdx.x, v);
#pragma unroll
    for (int u = 0; u < kPer; ++u) add_bin(h, (m >> u) & 1u ? key_of(v[u]) >> kShift1 : kBins1, kBins1);
  }
}

// The state pass 1's find leaves for pass 2.
__device__ __forceinline__ SelState first_state(const Found& f, int kc, int cap) {
  const uint32_t above = f.above, kk = static_cast<uint32_t>(kc) - above;
  const bool over = above + f.count > static_cast<uint32_t>(cap);
  return SelState{f.digit, kk, over, !over || above <= static_cast<uint32_t>(cap), 0xffffffffu, 0u, 0u, 0u};
}

// Pass 2 over rounds r0, r0 + step, ...: the round's entries at or above
// d1 (above it only, where they overflow) to the region in row order, at
// an offset reserved on *fill; its segment (and, overflowing, its count in
// d1's bin) to table[round]; the next-level histogram of d1's bin into h2.
// Overflowing, also the bin's least and greatest u into mn, mx.
__device__ void pass2_rounds(const ScoreRow& r, int r0, int step, const SelState& st, uint2* region,
                             Seg* table, uint32_t* fill, uint32_t* h2, uint32_t& mn, uint32_t& mx, int* ws,
                             int* s_off) {
  const int tid = threadIdx.x;
  for (int rd = r0; rd < r.rounds; rd += step) {  // block-uniform
    float v[kPer];
    const int j = rd * kQuadsPerRound + 4 * tid;
    const unsigned m = load_quads<kPer / 4>(r, j, v);
    unsigned take = 0, bin = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const uint32_t k = key_of(v[u]), dg = k >> kShift1;
      const bool ok = (m >> u) & 1u;
      if (ok && (dg > st.d1 || (!st.over && dg == st.d1))) take |= 1u << u;
      const bool in_bin = ok && dg == st.d1;
      if (in_bin && st.over) {
        bin |= 1u << u;
        mn = min(mn, k);
        mx = max(mx, k);
      }
      if (__any_sync(0xffffffffu, in_bin)) add_bin(h2, in_bin ? (k >> kShift2) & (kBins2 - 1) : kBins2, kBins2);
    }
    if (!st.stored) take = 0;
    int total;
    const int excl = block_excl_scan(__popc(take) | (__popc(bin) << 16), &total, ws);
    if (tid == 0) {
      const int cnt = total & 0xffff;
      const int off = cnt ? static_cast<int>(atomicAdd(fill, static_cast<uint32_t>(cnt))) : 0;
      *s_off = off;
      table[rd].off = off;
      table[rd].cnt = cnt;
      table[rd].bin = total >> 16;
    }
    __syncthreads();
    int pos = *s_off + (excl & 0xffff);
    const int e0 = 4 * j - r.mis;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if ((take >> u) & 1u) region[pos++] = make_uint2(__float_as_uint(v[u]), static_cast<uint32_t>(e0 + u));
  }
}

__device__ __forceinline__ uint32_t block_min(uint32_t v, uint32_t* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t r = red[0];
  for (int w = 1; w < kSelWarps; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ uint32_t block_max(uint32_t v, uint32_t* red) {
  return ~block_min(~v, red);
}

// Shared memory of the finish.
struct FinishSmem {
  uint32_t h2[kBins2 + 1];
  uint32_t h3[kBins3 + 1];
  int ws[kSelWarps + 1];
  int sw[kBatch * kSelWarps + kBatch];
  Found found;
};

// Calls fn(ok, key) for the region's entries [0, fill) with kBatch loads
// in flight a thread; every thread runs the same rounds (warp collectives
// may run inside fn).
template <class Fn>
__device__ __forceinline__ void for_region_keys(const uint2* region, int fill, Fn fn) {
  for (int i0 = 0; i0 < fill; i0 += kBatch * kSelThreads) {
    uint32_t k[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kSelThreads + threadIdx.x;
      k[b] = i < fill ? key_of(__uint_as_float(__ldcg(&region[i]).x)) : 0u;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) fn(i0 + b * kSelThreads + threadIdx.x < fill, k[b]);
  }
}

// One warp: round rd's entries above T and equal to T, read from the scores.
__device__ void warp_count_round(const ScoreRow& r, int rd, uint32_t t, int* gt_out, int* eq_out) {
  const int lane = threadIdx.x & 31;
  int gt = 0, eq = 0;
  for (int c = 0; c < kSelWarps; ++c) {
    float v[kPer];
    const unsigned m = load_quads<kPer / 4>(r, rd * kQuadsPerRound + 4 * (c * 32 + lane), v);
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if ((m >> u) & 1u) {
        const uint32_t k = key_of(v[u]);
        gt += k > t;
        eq += k == t;
      }
  }
  *gt_out = warp_sum_i(gt);
  *eq_out = warp_sum_i(eq);
}

// One warp writes the selected entries of round rd, read from the scores in
// row order, from output place sel; eq T-equal entries came before it.
__device__ void warp_write_round(const ScoreRow& r, int rd, uint32_t t, int need, int eq, int sel, float* ov,
                                 int* orow, float* floor_out) {
  for (int c = 0; c < kSelWarps; ++c) {
    float v[kPer];
    const int j = rd * kQuadsPerRound + 4 * (c * 32 + (threadIdx.x & 31));
    const unsigned m = load_quads<kPer / 4>(r, j, v);
    unsigned gt = 0, eqm = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if ((m >> u) & 1u) {
        const uint32_t k = key_of(v[u]);
        gt |= static_cast<unsigned>(k > t) << u;
        eqm |= static_cast<unsigned>(k == t) << u;
      }
    int eq_tot, sel_tot;
    int rank = eq + warp_excl_scan(__popc(eqm), &eq_tot);
    unsigned take = gt;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if ((eqm >> u) & 1u) {
        if (rank < need) take |= 1u << u;
        if (rank == need - 1) *floor_out = v[u];
        ++rank;
      }
    int pos = sel + warp_excl_scan(__popc(take), &sel_tot);
    const int e0 = 4 * j - r.mis;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if ((take >> u) & 1u) {
        ov[pos] = v[u];
        orow[pos++] = e0 + u;
      }
    eq += eq_tot;
    sel += sel_tot;
  }
}

// The finish, one block for one query: T and the T-equal entries to take
// (need); each round's counts and their prefixes in row order; the
// selected entries written in row order, with the floor.  sm.h2 holds the
// next-level histogram of d1's bin (pass 2's).
__device__ void finish(const ScoreRow& r, const SelState& st, const uint2* region, const Seg* table,
                       const RoundCounts& rc, float* ov, int* orow, float* floor_out, FinishSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fill = static_cast<int>(st.fill);
  uint32_t t, need;
  const bool one_value = st.over && st.minu == st.maxu;
  if (one_value) {  // d1's bin holds T alone
    t = st.minu;
    need = st.kk;
  } else {
    uint32_t kk = st.kk;
    const Found f2 = find_bin<kBins2>([&](int b) { return sm.h2[b]; }, kk, sm.ws, &sm.found);
    const uint32_t p22 = (st.d1 << (kShift1 - kShift2)) | f2.digit;
    kk -= f2.above;
    for (int i = tid; i <= kBins3; i += kSelThreads) sm.h3[i] = 0;
    __syncthreads();
    if (!st.over) {  // the last level over the region's entries in d1's bin
      for_region_keys(region, fill, [&](bool ok, uint32_t k) {
        add_bin(sm.h3, ok && (k >> kShift2) == p22 ? k & (kBins3 - 1) : kBins3, kBins3);
      });
    } else {  // the last level reads the scores again
      for (int rd = 0; rd < r.rounds; ++rd) {
        float v[kPer];
        const unsigned m = load_quads<kPer / 4>(r, rd * kQuadsPerRound + 4 * tid, v);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const uint32_t k = key_of(v[u]);
          add_bin(sm.h3, (m >> u) & 1u && (k >> kShift2) == p22 ? k & (kBins3 - 1) : kBins3, kBins3);
        }
      }
    }
    __syncthreads();
    const Found f3 = find_bin<kBins3>([&](int b) { return sm.h3[b]; }, kk, sm.ws, &sm.found);
    t = (p22 << kShift2) | f3.digit;
    need = kk - f3.above;
  }

  // each round's entries above T and equal to T: counted over the region
  // (d1's bin, overflowing with one value, all T: its count from pass 2),
  // or read again where the region lacks some (d1's bin of several values
  // overflowed, or the entries above d1 did)
  const bool reread_all = st.over && !(st.stored && one_value);
  for (int rd = tid; rd < r.rounds; rd += kSelThreads) {
    rc.gt(rd) = 0;
    rc.eq(rd) = st.over && !reread_all ? __ldcg(&table[rd].bin) : 0;
  }
  __syncthreads();
  if (reread_all) {
    for (int rd = warp; rd < r.rounds; rd += kSelWarps) {
      int gt, eq;
      warp_count_round(r, rd, t, &gt, &eq);
      if (lane == 0) rc.gt(rd) = gt, rc.eq(rd) = eq;
    }
  } else {
    for (int i0 = 0; i0 < fill; i0 += kBatch * kSelThreads) {  // an entry's round from its row
      uint2 e[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kSelThreads + tid;
        e[b] = i < fill ? __ldcg(&region[i]) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {  // one atomic a warp where its entries share a round (they mostly do)
        const bool ok = i0 + b * kSelThreads + tid < fill;
        const uint32_t k = key_of(__uint_as_float(e[b].x));
        const int rd = ok ? round_of(r, static_cast<int>(e[b].y)) : -1;
        const bool gt = ok && k > t, eq = ok && k == t && !st.over;
        const int rd0 = __shfl_sync(0xffffffffu, rd, 0);
        if (__all_sync(0xffffffffu, rd == rd0 || rd < 0)) {
          const int ngt = __popc(__ballot_sync(0xffffffffu, gt)), neq = __popc(__ballot_sync(0xffffffffu, eq));
          if (lane == 0 && rd0 >= 0) {
            if (ngt) atomicAdd(&rc.gt(rd0), ngt);
            if (neq) atomicAdd(&rc.eq(rd0), neq);
          }
        } else {
          if (gt) atomicAdd(&rc.gt(rd), 1);
          if (eq) atomicAdd(&rc.eq(rd), 1);
        }
      }
    }
  }
  __syncthreads();
  int eq_run = 0, sel_run = 0;
  for (int b0 = 0; b0 < r.rounds; b0 += kSelThreads) {  // uniform trip count
    const int rd = b0 + tid;
    const int gt = rd < r.rounds ? rc.gt(rd) : 0, eq = rd < r.rounds ? rc.eq(rd) : 0;
    int eq_tot, sel_tot;
    const int eq_before = eq_run + block_excl_scan(eq, &eq_tot, sm.ws);
    const int take = min(max(static_cast<int>(need) - eq_before, 0), eq);
    const int sel_before = sel_run + block_excl_scan(gt + take, &sel_tot, sm.ws);
    if (rd < r.rounds) {
      rc.eq_before(rd) = eq_before;
      rc.sel_before(rd) = sel_before;
      rc.eq(rd) = take;  // from here on: the T-equal entries it takes
    }
    eq_run += eq_tot;
    sel_run += sel_tot;
  }
  __syncthreads();

  // the rounds read again, one warp a round
  for (int rd = warp; st.over && rd < r.rounds; rd += kSelWarps) {
    const int take = rc.eq(rd);
    if ((reread_all && rc.gt(rd) + take > 0) || take > 0)
      warp_write_round(r, rd, t, static_cast<int>(need), rc.eq_before(rd), rc.sel_before(rd), ov, orow, floor_out);
  }
  if (reread_all) return;

  // the region's entries of the other rounds, in chunks of kBatch x
  // kSelThreads in region order (entry i0 + b kSelThreads + tid, so that
  // the loads and the writes coalesce): the chunk's prefixes give each
  // entry the T-equal and the selected entries before it in the region;
  // less those before its segment (noted where the segment starts), plus
  // its round's prefixes, they give its rank among the T-equal entries and
  // its place in row order
  int eq_c = 0, sel_c = 0;  // the region's entries before the chunk
  for (int i0 = 0; i0 < fill; i0 += kBatch * kSelThreads) {  // uniform trip count
    uint2 e[kBatch];
    int rd[kBatch], prev[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kSelThreads + tid;
      e[b] = i < fill ? __ldcg(&region[i]) : make_uint2(0u, 0u);
      prev[b] = i > 0 && i < fill ? static_cast<int>(__ldcg(&region[i - 1].y)) : -1;
    }
    unsigned is_eq = 0, is_gt = 0, start = 0;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      rd[b] = i0 + b * kSelThreads + tid < fill ? round_of(r, static_cast<int>(e[b].y)) : -1;
      if (rd[b] < 0) continue;
      if (prev[b] < 0 || round_of(r, prev[b]) != rd[b]) start |= 1u << b;  // its segment starts here
      if (st.over && rc.eq(rd[b]) > 0) continue;  // a round read again: written above
      const uint32_t k = key_of(__uint_as_float(e[b].x));
      is_gt |= static_cast<unsigned>(k > t) << b;
      is_eq |= static_cast<unsigned>(k == t) << b;
    }
    int at[kBatch], tot;
    chunk_prefix(is_eq, at, &tot, sm.sw);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if ((start >> b) & 1u) rc.eq0(rd[b]) = eq_c + at[b];
    __syncthreads();
    unsigned take = is_gt;
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if ((is_eq >> b) & 1u) {
        const int rank = rc.eq_before(rd[b]) + eq_c + at[b] - rc.eq0(rd[b]);
        if (rank < static_cast<int>(need)) take |= 1u << b;
        if (rank == static_cast<int>(need) - 1) *floor_out = __uint_as_float(e[b].x);
      }
    eq_c += tot;
    chunk_prefix(take, at, &tot, sm.sw);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if ((start >> b) & 1u) rc.sel0(rd[b]) = sel_c + at[b];
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if ((take >> b) & 1u) {
        const int pos = rc.sel_before(rd[b]) + sel_c + at[b] - rc.sel0(rd[b]);
        ov[pos] = __uint_as_float(e[b].x);
        orow[pos] = static_cast<int>(e[b].y);
      }
    sel_c += tot;
  }
}

struct Workspace {
  uint32_t* zeroed;  // nq x kZeroWords: pass 1's histogram and ticket
  SelState* state;   // nq
  uint32_t* hist2;   // nq x kBins2: d1's bin's next level
  Seg* table;        // nq x rounds
  int* counts;       // nq x counts_stride: the finish's per-round counts, past kSmemRounds rounds
  uint2* region;     // nq x cap
  int rounds, cap;
  size_t counts_stride;
};

inline size_t counts_ints(int n) {
  return max_rounds(n) > kSmemRounds ? static_cast<size_t>(max_rounds(n)) * kRoundFields : 0;
}

Workspace carve(void* ws, int nq, int n) {
  Workspace w;
  w.rounds = max_rounds(n);
  w.cap = region_cap(n);
  w.zeroed = static_cast<uint32_t*>(ws);
  w.state = reinterpret_cast<SelState*>(w.zeroed + static_cast<size_t>(nq) * kZeroWords);
  w.hist2 = reinterpret_cast<uint32_t*>(w.state + nq);
  w.table = reinterpret_cast<Seg*>(w.hist2 + static_cast<size_t>(nq) * kBins2);
  w.counts_stride = (counts_ints(n) + 3) & ~size_t{3};
  w.counts = reinterpret_cast<int*>(w.table + static_cast<size_t>(nq) * w.rounds);
  w.region = reinterpret_cast<uint2*>(w.counts + static_cast<size_t>(nq) * w.counts_stride);
  return w;
}

size_t workspace_bytes(int nq, int n) {
  return static_cast<size_t>(nq) * (kZeroWords * sizeof(uint32_t) + sizeof(SelState) + kBins2 * sizeof(uint32_t) +
                                    static_cast<size_t>(max_rounds(n)) * sizeof(Seg) +
                                    ((counts_ints(n) + 3) & ~size_t{3}) * sizeof(int) +
                                    static_cast<size_t>(region_cap(n)) * sizeof(uint2));
}

// Grid (blocks, queries): pass 1; the last block of a query finds d1.
__global__ void __launch_bounds__(kSelThreads) sel_pass1(const float* __restrict__ scores, int n, int kc,
                                                         Workspace w) {
  __shared__ uint32_t h[kBins1 + 1];
  __shared__ int ws[kSelWarps + 1];
  __shared__ Found found;
  __shared__ int last;
  const int q = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i <= kBins1; i += kSelThreads) h[i] = 0;
  __syncthreads();
  const ScoreRow r = score_row(scores, q, n);
  pass1_rounds(r, blockIdx.x, gridDim.x, h);
  __syncthreads();
  uint32_t* g = w.zeroed + static_cast<size_t>(q) * kZeroWords;
  for (int i = tid; i < kBins1; i += kSelThreads)
    if (h[i]) atomicAdd(&g[i], h[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&g[kBins1], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const Found f = find_bin<kBins1>([&](int b) { return __ldcg(&g[b]); }, static_cast<uint32_t>(kc), ws, &found);
  uint32_t* h2 = w.hist2 + static_cast<size_t>(q) * kBins2;
  for (int i = tid; i < kBins2; i += kSelThreads) h2[i] = 0;
  if (tid == 0) w.state[q] = first_state(f, kc, w.cap);
}

// Grid (blocks, queries): pass 2; the last block of a query finishes.
// Dynamic shared memory: the finish's per-round counts (up to kSmemRounds
// rounds).
__global__ void __launch_bounds__(kSelThreads) sel_pass2(const float* __restrict__ scores, int n, int kc,
                                                         Workspace w, float* __restrict__ vals,
                                                         int* __restrict__ rows, float* __restrict__ floor_out) {
  extern __shared__ int round_smem[];
  __shared__ FinishSmem sm;
  __shared__ int s_off, last;
  __shared__ uint32_t red[kSelWarps];
  const int q = blockIdx.y, tid = threadIdx.x;
  SelState st = w.state[q];
  const ScoreRow r = score_row(scores, q, n);
  uint2* region = w.region + static_cast<size_t>(q) * w.cap;
  Seg* table = w.table + static_cast<size_t>(q) * w.rounds;
  uint32_t* h2 = w.hist2 + static_cast<size_t>(q) * kBins2;
  for (int i = tid; i <= kBins2; i += kSelThreads) sm.h2[i] = 0;
  __syncthreads();
  uint32_t mn = 0xffffffffu, mx = 0u;
  pass2_rounds(r, blockIdx.x, gridDim.x, st, region, table, &w.state[q].fill, sm.h2, mn, mx, sm.ws, &s_off);
  __syncthreads();
  for (int i = tid; i < kBins2; i += kSelThreads)
    if (sm.h2[i]) atomicAdd(&h2[i], sm.h2[i]);
  if (st.over) {  // block-uniform
    mn = block_min(mn, red);
    mx = block_max(mx, red);
    if (tid == 0) {
      atomicMin(&w.state[q].minu, mn);
      atomicMax(&w.state[q].maxu, mx);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&w.state[q].ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  st.minu = __ldcg(&w.state[q].minu);
  st.maxu = __ldcg(&w.state[q].maxu);
  st.fill = __ldcg(&w.state[q].fill);
  for (int i = tid; i < kBins2; i += kSelThreads) sm.h2[i] = __ldcg(&h2[i]);
  __syncthreads();
  const RoundCounts rc{w.rounds <= kSmemRounds ? round_smem : w.counts + static_cast<size_t>(q) * w.counts_stride,
                       r.rounds};
  finish(r, st, region, table, rc, vals + static_cast<size_t>(q) * kc, rows + static_cast<size_t>(q) * kc,
         floor_out + q, sm);
}

}  // namespace

extern "C" {

// Workspace bytes for perceive_select_topk over (nq, n) scores: pass 1's
// histograms and tickets, the per-query state, pass 2's histograms, the
// round table, the finish's per-round counts past 4,096 rounds (67M
// scores), and a candidate region of min(n, 65,536) entries a query.
size_t perceive_select_topk_workspace(int nq, int n) { return workspace_bytes(nq, n); }

// K6.  scores (nq, n) f32 contiguous; 1 <= kc <= n.  Writes vals/rows
// (nq, kc), ordered by row, and floor (nq,) = the kc-th score.  workspace:
// perceive_select_topk_workspace(nq, n) bytes, 16-byte aligned.
int perceive_select_topk(const float* scores, int nq, int n, int kc, float* vals, int* rows,
                         float* floor_out, void* workspace, void* stream) {
  if (nq < 1 || nq > 65535 || n < 1 || kc < 1 || kc > n || reinterpret_cast<uintptr_t>(workspace) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w = carve(workspace, nq, n);
  static int sms[64] = {0};  // by device, read once a process
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // about two blocks an SM over the queries, each striding over rounds
  const dim3 grid(min(w.rounds, max(1, 2 * sms[dev] / nq)), nq);
  err = cudaMemsetAsync(w.zeroed, 0, static_cast<size_t>(nq) * kZeroWords * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = w.rounds <= kSmemRounds ? w.rounds * kRoundFields * static_cast<int>(sizeof(int)) : 0;
  static int smem_set[64] = {0};  // by device: the attribute, once a process
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(sel_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemRounds * kRoundFields * static_cast<int>(sizeof(int)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = 1;
  }
  sel_pass1<<<grid, kSelThreads, 0, s>>>(scores, n, kc, w);
  sel_pass2<<<grid, kSelThreads, smem, s>>>(scores, n, kc, w, vals, rows, floor_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
