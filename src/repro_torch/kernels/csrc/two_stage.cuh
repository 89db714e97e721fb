// The two kernels of the fused two-stage scan, shared by fused_two_stage.cu
// and fused_three_stage.cu: int8 hit counts -> survivor threshold -> top-C
// candidates -> masked ADC on the candidates only. hit_count.cu runs the
// count kernel's body (count_body) without the dist writes, and its top-k
// kernel reads the histograms through sum_hists and theta_bin.
//
// Contract: the reference's off-TPU serving path, fused_two_stage_host
// (src/repro/kernels/fused_two_stage.py, l.259-335), over the points whose
// probe is kept (scan_common.cuh:probe_kept):
//   counts[q, w] = sum_s table[q, probe, s, code[s]]   (invalid -> -2^30)
//   theta_q      = the C-th largest count of query q over W = np*P
//   cand[q]      = every w with count > theta_q, then the first C - n_gt
//                  ties (count == theta_q) in index order; cand is
//                  index-ascending
//   cand_dist    = sum_s lut[q, probe, s, code[s]] at cand (bad if invalid)
//   dist         = cand_dist scattered at cand, bad everywhere else
// The hit table holds {-1, 0, +1} (what selective_lut writes); the count
// kernel reads an entry by its sign.
//
// Codes are not gathered per probe beforehand: the kernels take the index's
// (n_clusters, P, S) codes and (n_clusters, P) valid mask with the probed
// cluster ids (Q, np) and index them themselves, which saves writing and
// re-reading a (Q, np, P, S) copy (385 MB at Q=128, np=16, P=3912, S=48).
//
// The probe mask comes in one of two ways (template parameter kSphere):
//  * kSphere = false (fused_two_stage): probe_ok is an optional (Q, np)
//    input, null when every probe is kept;
//  * kSphere = true (fused_three_stage): the count kernel runs the RT
//    sphere test itself, once per (q, probe) as the block's prologue, at
//    the probed cluster's slot of the centroid grid, forces probe 0, and
//    writes probe_ok as an output that the select kernel then reads. The
//    (Q, n_cells*cap) hit table never exists.
//
// Design: two kernels, each one block per (q, probe), so that a batch of Q
// queries runs Q*np blocks in both (128-2048 at the engine's batches).
// Both are latency-bound unless a thread has several loads in flight, so
// each issues its loads in batches before it uses one (valid flags, table
// words, a point's code words, counts, histogram rows), and both are
// compiled for the S of the repo's two configurations (48, 100), where a
// code row's loads unroll, as well as for any S (1.15-1.7x slower a call at
// those S on the H100, PERF.md).
//  (a) count_kernel: thread 0 decides whether the probe is kept. A kept
//      probe's S*E int8 table is staged as two 256-bit planes a subspace
//      (+1 entries, -1 entries; 64 bytes a subspace, 3 KB at S=48 against
//      12 KB of bytes), so a warp's 32 lookups into one subspace touch 16
//      words in 16 distinct banks and never conflict. Each thread holds the
//      valid flags of 16 points (8 at the other launch shape) of a
//      4096-point chunk as a mask and counts
//      its valid points one a step, so a warp's lanes stay busy where the
//      valid slots are packed at the front of the cluster, as a built index
//      has them (scattered at random, a warp takes about twice the steps).
//      A point's count is the + bits minus the - bits at its S codes
//      (plane_count), an exact integer sum, stored at its own index. The
//      block's histogram of 2S+2 bins (one per count in [-S, S], bin 0 for
//      invalid) is stored plainly at (q, probe): no global atomics, so the
//      histogram buffer needs no zeroing. A pruned probe reads no table and
//      no codes: its P points are invalid, and its dist is all bad, which
//      this kernel writes too (it knows the verdict first).
//  (b) select_kernel: each block sums the query's np histograms to theta_q
//      and the tie quota, and the histograms of the probes before its own to
//      its starting offsets (candidates above theta, ties at theta), so the
//      ties stay in index order across probes. It then walks its own P
//      counts (copied to shared memory asynchronously, cp.async) in windows
//      of four counts a thread, ranks them with warp shuffles and one block
//      scan a window, writes bad to dist where it takes nothing and lists
//      what it takes in shared memory; then the whole block sums the listed
//      candidates' LUT entries at once (from its own (q, probe) LUT rows, in
//      subspace order, the additions of scan_common.cuh's gather_sum, as
//      pq_scan.cu does; a candidate whose count is the invalid sentinel
//      scores bad without a load) and writes them to cand, cand_dist and
//      dist: each dist entry is written once. A block that takes nothing
//      writes bad. A pruned probe takes candidates only when theta is the
//      invalid count, and then probe 0's block writes them (pruned_ties), so
//      every other pruned probe's block leaves at once.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"
#include "sphere.cuh"

namespace two_stage {

using scan::kNeg;
// The count kernel's default launch shape (hit_count.cu's count kernel runs
// it). The fused scans take theirs at run time from a small lattice
// (with_launch_shape): the count kernel's threads and the points a thread
// holds the flags of, whose product is always kChunk, and the select
// kernel's threads. Every shape gives the same bits: a point's count is an
// exact integer sum, each candidate's ADC sum is one thread's, in subspace
// order, and the ranks come from scans whose results do not depend on the
// block's width.
constexpr int kCountThreads = 256;
constexpr int kPerThread = 16;    // points of a chunk a count thread holds the flags of
constexpr int kChunk = kCountThreads * kPerThread;   // points a count block walks at once
constexpr int kSpan = 4096;       // counts a select block stages in shared memory at once
constexpr int kTakeList = 2048;   // candidates a select block lists before summing them
constexpr int kPlaneBytes = 64;   // one subspace's planes: 256 entries x 2 bits

// Phase 0 of the three-stage scan: the ray-plane queries and the grid's
// slot planes. Unused (all null) in the two-stage scan.
struct SphereTest {
  const float* q0;          // (Q,) ray-plane query coordinates, strided
  const float* q1;
  int64_t q0_stride;        // element strides of q0 and q1
  int64_t q1_stride;
  const float* radius;      // (Q,) ray-plane radii
  const float* c0;          // (n_cells*cap,) slot centroid coordinates
  const float* c1;
  const float* reach;       // (n_cells*cap,) slot reach, -inf at pads
  const int32_t* slot_idx;  // (Q*np,) grid slot of each probed cluster
};

// Bits 7, 15, 23 and 31 of v as a 4-bit number (bit 7 lowest).
__device__ __forceinline__ uint32_t top_bits(uint32_t v) {
  return (((v >> 7) * 0x00204081u) >> 21) & 15u;
}

// The + and - bits of 16 int8 entries held in four words, entry i at bit i.
__device__ __forceinline__ void sign_bits(const uint4& v, uint32_t& plus, uint32_t& minus) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  plus = minus = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t neg = x[i] & 0x80808080u;
    const uint32_t nz = (((x[i] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x[i]) & 0x80808080u;
    plus |= top_bits(nz & ~neg) << (4 * i);
    minus |= top_bits(neg) << (4 * i);
  }
}

// Stage one probe's (S, E) int8 table as bit planes: subspace s owns the 16
// words planes[16 s .. 16 s + 15]; word k covers entries 16k .. 16k + 15,
// its low half holding their + bits and its high half their - bits, the
// halves swapped when k is odd. A rotation of word c >> 4 by c (mod 32)
// then brings entry c's + bit to bit 0 and its - bit to bit 16 (plane_word).
// Entries from min(E, 256) on are never looked up by a uint8 code below E:
// they stage as 0. The caller synchronises the block afterwards.
template <int kThreads = kCountThreads>
__device__ __forceinline__ void stage_planes(uint32_t* planes, const int8_t* __restrict__ tab,
                                             int S, int E) {
  constexpr int kBatch = 4;   // 16-byte loads a thread issues before using one
  const bool vec = (E & 15) == 0 && (reinterpret_cast<uintptr_t>(tab) & 15) == 0;
  for (int i0 = 0; i0 < S * 16; i0 += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads + threadIdx.x;
      v[b] = make_uint4(0, 0, 0, 0);
      if (vec && i < S * 16 && 16 * (i & 15) < E)
        v[b] = __ldg(reinterpret_cast<const uint4*>(tab + (int64_t)(i >> 4) * E + 16 * (i & 15)));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads + threadIdx.x;
      if (i >= S * 16) break;
      const int k = i & 15;
      uint32_t plus = 0, minus = 0;
      if (vec) {
        sign_bits(v[b], plus, minus);
      } else {
        const int8_t* src = tab + (int64_t)(i >> 4) * E + 16 * k;
        for (int j = 0; j < 16 && 16 * k + j < E; ++j) {
          const int8_t e = src[j];
          plus |= (uint32_t)(e > 0) << j;
          minus |= (uint32_t)(e < 0) << j;
        }
      }
      planes[i] = (k & 1) ? (minus | plus << 16) : (plus | minus << 16);
    }
  }
}

// acc + (+ bit) + (- bit) << 16 of the four subspaces whose codes are the
// bytes of w, their planes starting at byte `off` of `planes` (a multiple
// of 256). Byte j of t is 64 j + 4 (c_j >> 4), the offset of c_j's word in
// the 256 bytes of the four subspaces, so one byte permute gives the
// address; the rotation reads only the low 5 bits of its amount.
__device__ __forceinline__ uint32_t plane_word(uint32_t acc, const unsigned char* planes,
                                               uint32_t off, uint32_t w) {
  const uint32_t t = ((w >> 2) & 0x3c3c3c3cu) | 0xc0804000u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x =
        *reinterpret_cast<const uint32_t*>(planes + __byte_perm(t, off, 0x7650u | j));
    acc += __funnelshift_r(x, x, w >> (8 * j)) & 0x10001u;
  }
  return acc;
}

// The kernels are compiled for the S of the repo's two configurations (48
// and 100; kS) and for any S (kS = 0). With kS known, a point's code row is
// read into registers by loads that are all issued before any is used, and
// its S table entries likewise (a load under a condition may compile to a
// branch, and then each waits for the one before it). A fast path chosen
// by a property of S instead (a multiple of 4 up to 64 or 128, registers
// sized by the bound) was as fast at S = 48 and 1.34x slower a call at
// S = 100, where its select kernel spilled (PERF.md).

// Whether one point's code row can be read as whole 4-byte words: S = kS
// (a multiple of 4) and the row 4-byte aligned.
template <int kS>
__device__ __forceinline__ bool row_in_words(const uint8_t* c) {
  return kS > 0 && (reinterpret_cast<uintptr_t>(c) & 3) == 0;
}

// Read a row that row_in_words into registers: 16-byte loads when S is a
// multiple of 16 and the row 16-byte aligned (S = 48: three), else 4-byte
// loads (S = 100: 25).
template <int kS>
__device__ __forceinline__ void load_row(uint32_t (&r)[kS / 4], const uint8_t* __restrict__ c) {
  if (kS % 16 == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
#pragma unroll
    for (int w = 0; w < kS / 16; ++w) {
      const uint4 v = __ldg(c4 + w);
      r[4 * w] = v.x;
      r[4 * w + 1] = v.y;
      r[4 * w + 2] = v.z;
      r[4 * w + 3] = v.w;
    }
  } else {
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(c);
#pragma unroll
    for (int w = 0; w < kS / 4; ++w) r[w] = __ldg(cw + w);
  }
}

// One point's hit count, sum_s sign(table[s][c[s]]), from the bit planes:
// the + bits gather in the low half of acc and the - bits in the high half
// (S <= 3632 fits the shared memory, so neither half overflows). An exact
// integer sum, so its order is free.
template <int kS>
__device__ __forceinline__ int plane_count(const unsigned char* planes,
                                           const uint8_t* __restrict__ c, int S) {
  uint32_t acc = 0;
  if constexpr (kS > 0) {
    if (row_in_words<kS>(c)) {
      uint32_t r[kS / 4];
      load_row<kS>(r, c);
#pragma unroll
      for (int w = 0; w < kS / 4; ++w)
        acc = plane_word(acc, planes, 4u * kPlaneBytes * w, r[w]);
      return (int)(acc & 0xffffu) - (int)(acc >> 16);
    }
  }
  for (int s = 0; s < S; ++s) {
    const uint32_t code = __ldg(c + s);
    const uint32_t x =
        *reinterpret_cast<const uint32_t*>(planes + kPlaneBytes * s + ((code >> 2) & 0x3cu));
    acc += __funnelshift_r(x, x, code) & 0x10001u;
  }
  return (int)(acc & 0xffffu) - (int)(acc >> 16);
}

// One valid point's ADC sum, sum_s lut[s][c[s]] in subspace order: the f32
// additions of scan::gather_sum in its order (so the same bits). With kS,
// the S entries are loaded before they are added.
template <int kS>
__device__ __forceinline__ float adc_sum(const float* __restrict__ lut,
                                         const uint8_t* __restrict__ c, int S, int E) {
  if constexpr (kS > 0) {
    if (row_in_words<kS>(c)) {
      uint32_t r[kS / 4];
      load_row<kS>(r, c);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kS / 4; ++w) acc = scan::add_word(acc, lut + 4 * w * E, r[w], E);
      return acc;
    }
  }
  return scan::gather_sum<float>(lut, c, S, E);
}

// Dynamic shared memory of count_kernel: the planes and the histogram.
inline size_t count_smem(int S) {
  return (size_t)S * kPlaneBytes + (size_t)(2 * S + 2) * sizeof(int);
}

// The count kernel's body, which hit_count.cu's kernel shares: kDist writes
// a pruned probe's dist (the fused scans'; hit_count has none); kThreads
// threads a block, each holding the valid flags of kPer points of a chunk.
template <bool kSphere, int kS, bool kDist, int kThreads = kCountThreads,
          int kPer = kPerThread>
__device__ __forceinline__ void count_body(const int8_t* __restrict__ table,
                                           const uint8_t* __restrict__ codes,
                                           const uint8_t* __restrict__ valid,
                                           const int64_t* __restrict__ cids,
                                           SphereTest sph, uint8_t* probe_ok,
                                           int32_t* __restrict__ counts,
                                           int32_t* __restrict__ hist,
                                           float* __restrict__ dist, int n_probe, int P,
                                           int S, int E, float bad) {
  static_assert(kThreads * kPer == kChunk && kPer <= 32 && kThreads % 32 == 0,
                "a chunk is kChunk points, its flags one 32-bit mask a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_keep;
  if constexpr (kS > 0) S = kS;
  const int nbins = 2 * S + 2;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  int* h = reinterpret_cast<int*>(smem + (size_t)S * kPlaneBytes);
  const int64_t qp = blockIdx.x;
  const int q = (int)(qp / n_probe);
  const int64_t cid = cids[qp];
  const unsigned lane = threadIdx.x & 31u;

  if (threadIdx.x == 0) {
    bool keep;
    if constexpr (kSphere) {
      const int32_t slot = sph.slot_idx[qp];
      keep = qp % n_probe == 0 ||   // probe 0 is always scanned
             rt::sphere_hit(sph.q0[q * sph.q0_stride], sph.q1[q * sph.q1_stride],
                            sph.radius[q], sph.c0[slot], sph.c1[slot], sph.reach[slot]);
      probe_ok[qp] = keep;
    } else {
      keep = scan::probe_kept(probe_ok, qp);
    }
    s_keep = keep;
  }
  for (int i = threadIdx.x; i < nbins; i += kThreads) h[i] = 0;
  __syncthreads();
  int32_t* out = counts + qp * P;
  if (!s_keep) {   // pruned: every point invalid, no table or code read
    for (int p = threadIdx.x; p < P; p += kThreads) {
      out[p] = kNeg;
      if constexpr (kDist) dist[qp * P + p] = bad;
    }
    for (int i = threadIdx.x; i < nbins; i += kThreads)
      hist[qp * nbins + i] = i == 0 ? P : 0;
    return;
  }
  const uint8_t* crow = codes + cid * (int64_t)P * S;
  const uint8_t* vrow = valid + cid * (int64_t)P;
  // a chunk's valid flags as a mask, point k * kThreads + threadIdx.x
  // of the chunk at bit k; every load issued and in range. The first
  // chunk's are in flight while the table is staged.
  auto load_flags = [&](int c0, int n) {
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * kThreads + threadIdx.x;
      m |= (uint32_t)(vrow[c0 + min(i, n - 1)] != 0 && i < n) << k;
    }
    return m;
  };
  uint32_t m = load_flags(0, min(kChunk, P));
  stage_planes<kThreads>(planes, table + qp * (int64_t)S * E, S, E);
  __syncthreads();   // the planes and h are ready

  for (int c0 = 0; c0 < P; c0 += kChunk) {
    const int n = min(kChunk, P - c0);
    if (c0 > 0) m = load_flags(c0, n);
    int n_invalid = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * kThreads + threadIdx.x;
      if (i < n && !((m >> k) & 1u)) {
        out[c0 + i] = kNeg;
        ++n_invalid;
      }
    }
    n_invalid = __reduce_add_sync(0xffffffffu, n_invalid);
    if (lane == 0 && n_invalid) atomicAdd(&h[0], n_invalid);
    // each lane counts its next valid point a step, so a warp takes as many
    // steps as its lane with the most: 4 where a quarter of the slots are
    // valid and packed at the front of the cluster, as a built index has
    // them, about 8 where they are scattered at random. The full-mask
    // __match_any_sync needs every lane: the trip count is warp-uniform.
    while (__any_sync(0xffffffffu, m != 0)) {
      int bin = -1;
      if (m) {
        const int i = (__ffs(m) - 1) * kThreads + threadIdx.x;
        m &= m - 1;
        const int cnt = plane_count<kS>(smem, crow + (int64_t)(c0 + i) * S, S);
        out[c0 + i] = cnt;
        bin = cnt + S + 1;   // in [1, 2S+1]: entries are read by sign
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == (unsigned)(__ffs(peers) - 1)) atomicAdd(&h[bin], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kThreads) hist[qp * nbins + i] = h[i];
}

// At most 64 registers a thread at every width: 1024 threads an SM.
template <bool kSphere, int kS, int kThreads, int kPer>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
count_kernel(const int8_t* __restrict__ table,    // (Q*np, S, E)
             const uint8_t* __restrict__ codes,   // (n_cl, P, S)
             const uint8_t* __restrict__ valid,   // (n_cl, P)
             const int64_t* __restrict__ cids,    // (Q*np)
             SphereTest sph,
             uint8_t* probe_ok,                   // (Q*np) in, or out
             int32_t* __restrict__ counts,        // (Q*np, P)
             int32_t* __restrict__ hist,          // (Q*np, 2S+2)
             float* __restrict__ dist,            // (Q*np, P): pruned probes only
             int n_probe, int P, int S, int E, float bad) {
  count_body<kSphere, kS, true, kThreads, kPer>(table, codes, valid, cids, sph, probe_ok,
                                                counts, hist, dist, n_probe, P, S, E, bad);
}

// Per bin b, from the query's np stored histograms hq (np, nbins): tot[b]
// over every probe, pre[b] over the probes before `probe`, mine[b] of
// `probe` itself; with kInvalid also invalid_of[i], probe i's bin 0. Each
// thread of the block (nthreads) sums its bins, its loads issued in
// batches. The caller synchronises the block afterwards.
template <bool kInvalid>
__device__ __forceinline__ void sum_hists(const int32_t* __restrict__ hq, int n_probe, int probe,
                                          int nbins, int nthreads, int* tot, int* pre,
                                          int* mine, int* invalid_of) {
  constexpr int kBatch = 16;  // histogram rows a thread loads at once
  for (int b = threadIdx.x; b < nbins; b += nthreads) {
    int t = 0, before = 0;
    for (int i0 = 0; i0 < n_probe; i0 += kBatch) {
      int x[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)   // every load issued, in range
        x[k] = hq[min(i0 + k, n_probe - 1) * nbins + b];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (i0 + k >= n_probe) break;
        t += x[k];
        before += i0 + k < probe ? x[k] : 0;
        if (i0 + k == probe) mine[b] = x[k];
        if constexpr (kInvalid)
          if (b == 0) invalid_of[i0 + k] = x[k];
      }
    }
    tot[b] = t;
    pre[b] = before;
  }
}

// theta's bin for C, found by one whole warp over the query's histogram tot:
// the highest bin whose count and the counts above it reach C (bin 0, the
// invalid one, when the valid points fall short). Lane l holds the l-th run
// [lo, hi) of k bins from the top, `above_run` counts the points in the
// bins above its run; tb and `above` (the points above tb) are the warp's.
struct ThetaRun {
  int tb, above, lo, hi, above_run;
};
__device__ __forceinline__ ThetaRun theta_bin(const int* tot, int nbins, int C) {
  const unsigned lane = threadIdx.x & 31u;
  ThetaRun r;
  const int k = (nbins + 31) / 32;
  r.hi = nbins - (int)lane * k;
  r.lo = max(r.hi - k, 0);
  int sum = 0;
  for (int b = r.lo; b < r.hi; ++b) sum += tot[b];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= (unsigned)o) incl += y;
  }
  r.above_run = incl - sum;
  // the np*P points reach C by bin 0, so some lane's sum does
  const int f = __ffs(__ballot_sync(0xffffffffu, incl >= C)) - 1;
  int tb = 0, above = 0;
  if ((int)lane == f) {
    tb = r.hi - 1;
    above = r.above_run;
    while (above + tot[tb] < C) above += tot[tb--];
  }
  r.tb = __shfl_sync(0xffffffffu, tb, f);
  r.above = __shfl_sync(0xffffffffu, above, f);
  return r;
}

// Dynamic shared memory of select_kernel: a span of counts, the list of
// candidates, three histograms and each probe's invalid points and verdict.
inline size_t select_smem(int S, int n_probe) {
  return sizeof(int) * (kSpan + kTakeList + 3 * (size_t)(2 * S + 2) + 2 * (size_t)n_probe);
}

// An asynchronous 4-byte copy from global to shared memory (cp.async, no
// register holds the value); copy_wait waits for this thread's copies.
__device__ __forceinline__ void copy_async(int* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying counts[p0, p0 + min(kSpan, P - p0)) of one probe into s_cnt.
template <int kThreads>
__device__ __forceinline__ void copy_span(int* s_cnt, const int32_t* crow, int p0, int P) {
  const int n = min(kSpan, P - p0);
  for (int i = threadIdx.x; i < n; i += kThreads) copy_async(s_cnt + i, crow + p0 + i);
}

// The ties the pruned probes of query q take when theta is the invalid
// count: every valid point is then a candidate, and a pruned probe, all P
// of its points invalid, takes the first of them the quota leaves it, at
// offsets from the valid and invalid points of the probes before it.
// Kept out of line: it runs once a query at most and would cost the main
// path registers.
__device__ __noinline__ void pruned_ties(int32_t* cq, float* dq, const int* invalid_of,
                                         const int* pruned, int n_probe, int P, int C,
                                         float bad) {
  int valid = 0;
  for (int i = 0; i < n_probe; ++i) valid += P - invalid_of[i];
  const int quota = C - valid;
  int valid_before = 0, ties_before = 0;
  for (int i = 0; i < n_probe; ++i) {
    if (pruned[i]) {
      const int take = min(max(quota - ties_before, 0), P);
      const int base = valid_before + min(ties_before, quota);
      for (int p = threadIdx.x; p < take; p += blockDim.x) {
        cq[base + p] = i * P + p;
        dq[base + p] = bad;
      }
    }
    valid_before += P - invalid_of[i];
    ties_before += invalid_of[i];
  }
}

template <int kS, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
select_kernel(const int32_t* __restrict__ counts,  // (Q*np, P)
              const int32_t* __restrict__ hist,    // (Q*np, 2S+2)
              const float* __restrict__ lut,       // (Q*np, S, E)
              const uint8_t* __restrict__ codes,
              const int64_t* __restrict__ cids,
              const uint8_t* __restrict__ probe_ok,  // (Q*np) or null
              float* __restrict__ dist,            // (Q*np, P)
              int32_t* __restrict__ cand,          // (Q, C)
              float* __restrict__ cand_dist,       // (Q, C)
              int n_probe, int P, int S, int E, int C, float bad) {
  constexpr int kPer = 4;     // consecutive counts a thread ranks a window
  constexpr int kWindow = kPer * kThreads;
  static_assert(kWindow <= kTakeList && kThreads % 32 == 0 && kThreads <= 1024,
                "a window's candidates fit the list; one warp scans the warps' totals");
  extern __shared__ __align__(16) int sh[];
  __shared__ unsigned s_warp[2][32];
  __shared__ int s_theta, s_take, s_ties, s_base;
  if constexpr (kS > 0) S = kS;
  const int nbins = 2 * S + 2;
  int* s_cnt = sh;                   // a span of this probe's counts
  int* list = sh + kSpan;            // the candidates listed, by point index
  int* tot = list + kTakeList;       // per bin: the query's points,
  int* pre = tot + nbins;            // those of the probes before this one,
  int* mine = pre + nbins;           // this probe's
  int* invalid_of = mine + nbins;    // per probe: its points in bin 0,
  int* pruned = invalid_of + n_probe;  // and whether it is pruned
  const int64_t qp = blockIdx.x;
  const int q = (int)(qp / n_probe), probe = (int)(qp % n_probe);
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  float* drow = dist + qp * P;
  const int32_t* crow = counts + qp * P;
  // a pruned probe's block has nothing to do but the ties it may take, and
  // probe 0's block takes those for it (below): it leaves at once (the
  // count kernel wrote its dist). A kept probe's counts start landing in
  // shared memory while the histograms are read.
  const bool kept = scan::probe_kept(probe_ok, qp);
  if (!kept && probe != 0) return;
  if (kept) copy_span<kThreads>(s_cnt, crow, 0, P);
  if (probe == 0 && probe_ok != nullptr)
    for (int i = threadIdx.x; i < n_probe; i += kThreads)
      pruned[i] = !probe_ok[(int64_t)q * n_probe + i];

  sum_hists<true>(hist + (int64_t)q * n_probe * nbins, n_probe, probe, nbins, kThreads,
                  tot, pre, mine, invalid_of);
  __syncthreads();
  if (warp == 0) {
    const ThetaRun r = theta_bin(tot, nbins, C);
    const int tb = r.tb, above = r.above, lo = r.lo, hi = r.hi;
    // points above theta in the probes before this one, and in this one
    int gt_pre = 0, gt_mine = 0;
    for (int b = max(lo, tb + 1); b < hi; ++b) {
      gt_pre += pre[b];
      gt_mine += mine[b];
    }
    for (int o = 16; o > 0; o >>= 1) {
      gt_pre += __shfl_xor_sync(0xffffffffu, gt_pre, o);
      gt_mine += __shfl_xor_sync(0xffffffffu, gt_mine, o);
    }
    if (lane == 0) {
      const int quota = C - above;   // ties at theta the query takes
      const int ties = min(max(quota - pre[tb], 0), mine[tb]);
      s_theta = tb == 0 ? kNeg : tb - S - 1;
      s_ties = ties;
      s_take = gt_mine + ties;
      s_base = gt_pre + min(pre[tb], quota);
    }
  }
  __syncthreads();
  const int theta = s_theta, n_ties = s_ties, n_take = s_take;
  int32_t* cq = cand + (int64_t)q * C + s_base;
  float* dq = cand_dist + (int64_t)q * C + s_base;
  const int flat0 = probe * P;
  if (probe == 0 && theta == kNeg && probe_ok != nullptr)
    pruned_ties(cand + (int64_t)q * C, cand_dist + (int64_t)q * C, invalid_of, pruned,
                n_probe, P, C, bad);
  if (!kept) return;
  if (n_take == 0) {
    for (int p = threadIdx.x; p < P; p += kThreads) drow[p] = bad;
    copy_wait();   // no copy may land after the block is gone
    return;
  }

  const int64_t cid = cids[qp];
  const float* lq = lut + qp * (int64_t)S * E;
  int n_gt = 0, n_tie = 0;   // above theta and at theta, so far
  int listed = 0, summed = 0, walked = 0, buf = 0;
  // sum the listed candidates, each by one thread, all at once; every
  // thread calls it (it synchronises the block)
  auto flush = [&]() {
    __syncthreads();
    for (int j = threadIdx.x; j < listed - summed; j += kThreads) {
      // an invalid point (its count the sentinel, flagged in the list's
      // top bit) scores bad without a load
      const int p = list[j] & 0x7fffffff;
      const float v = list[j] < 0 ? bad : adc_sum<kS>(lq, codes + (cid * P + p) * S, S, E);
      cq[summed + j] = flat0 + p;
      dq[summed + j] = v;
      drow[p] = v;
    }
    summed = listed;
    __syncthreads();
  };
  for (int p0 = 0; p0 < P && listed < n_take; p0 += kSpan) {
    const int n = min(kSpan, P - p0);
    if (p0 > 0) copy_span<kThreads>(s_cnt, crow, p0, P);
    copy_wait();
    __syncthreads();
    for (int w0 = 0; w0 < n && listed < n_take; w0 += kWindow) {   // block-uniform
      if (listed - summed > kTakeList - kWindow) flush();
      // kPer consecutive counts a thread: (above, tie) pairs packed in
      // 16-bit halves, ranked within the thread, the warp (shuffles) and
      // the block (one scan of the warps' totals)
      const int i = w0 + kPer * (int)threadIdx.x;
      unsigned flag[kPer], mine_pre[kPer], t = 0;
      bool invalid[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = i + k < n ? s_cnt[i + k] : INT_MIN;
        invalid[k] = c == kNeg;
        flag[k] = (unsigned)(c > theta) | (unsigned)(c == theta) << 16;
        mine_pre[k] = t;
        t += flag[k];
      }
      unsigned incl = t;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= (unsigned)o) incl += y;
      }
      if (lane == 31) s_warp[buf][warp] = incl;
      __syncthreads();
      const unsigned own = lane < kThreads / 32 ? s_warp[buf][lane] : 0u;
      unsigned wincl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, wincl, o);
        if (lane >= (unsigned)o) wincl += y;
      }
      const unsigned before = __shfl_sync(0xffffffffu, wincl - own, warp) + incl - t;
      const unsigned all = __shfl_sync(0xffffffffu, wincl, 31);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (i + k >= n) break;
        const unsigned r = before + mine_pre[k];
        const int gt_rank = n_gt + (int)(r & 0xffffu);
        const int tie_rank = n_tie + (int)(r >> 16);
        if ((flag[k] & 1u) || ((flag[k] >> 16) && tie_rank < n_ties))
          list[gt_rank + min(tie_rank, n_ties) - summed] =   // its place in cand
              (p0 + i + k) | (invalid[k] ? INT_MIN : 0);
        else
          drow[p0 + i + k] = bad;
      }
      n_gt += (int)(all & 0xffffu);
      n_tie += (int)(all >> 16);
      listed = n_gt + min(n_tie, n_ties);
      walked = p0 + w0 + kWindow;
      buf ^= 1;
    }
    __syncthreads();   // the span is read before the next one lands
  }
  copy_wait();
  // every candidate is listed: the points not walked take nothing
  for (int p = walked + threadIdx.x; p < P; p += kThreads) drow[p] = bad;
  flush();
}

template <bool kSphere, int kS, int kCount, int kPer, int kSelect>
inline int launch_s(const void* lut, const void* table, const void* codes,
                    const void* valid, const void* cids, const SphereTest& sph,
                    void* probe_ok, void* counts, void* dist, void* cand,
                    void* cand_dist, void* hist, int Q, int n_probe, int P, int S,
                    int E, int C, float bad, cudaStream_t st) {
  const unsigned blocks = (unsigned)(Q * n_probe);
  const size_t csmem = count_smem(S);
  int err = scan::allow_smem(count_kernel<kSphere, kS, kCount, kPer>, csmem);
  if (err) return err;
  count_kernel<kSphere, kS, kCount, kPer><<<blocks, kCount, csmem, st>>>(
      (const int8_t*)table, (const uint8_t*)codes, (const uint8_t*)valid,
      (const int64_t*)cids, sph, (uint8_t*)probe_ok, (int32_t*)counts,
      (int32_t*)hist, (float*)dist, n_probe, P, S, E, bad);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t ssmem = select_smem(S, n_probe);
  err = scan::allow_smem(select_kernel<kS, kSelect>, ssmem);
  if (err) return err;
  select_kernel<kS, kSelect><<<blocks, kSelect, ssmem, st>>>(
      (const int32_t*)counts, (const int32_t*)hist, (const float*)lut,
      (const uint8_t*)codes, (const int64_t*)cids,
      (const uint8_t*)probe_ok, (float*)dist, (int32_t*)cand, (float*)cand_dist,
      n_probe, P, S, E, C, bad);
  return (int)cudaGetLastError();
}

// The one place that decides which S get kernels of their own: f(kS) with
// kS = std::integral_constant<int, S> for the S of the repo's two
// configurations (48, 100), and <int, 0> (any S) otherwise. Every launcher
// of the count kernel (launch below, hit_count.cu) dispatches through it.
template <class F>
inline int with_compiled_s(int S, F&& f) {
  if (S == 48) return f(std::integral_constant<int, 48>{});
  if (S == 100) return f(std::integral_constant<int, 100>{});
  return f(std::integral_constant<int, 0>{});
}

// The fused scans' launch lattice: f(count threads, points a count thread,
// select threads) as integral constants, for the count shapes (256, 16) (the
// default) and (512, 8) and the select widths 256 (the default), 128 and
// 512; any other value returns cudaErrorInvalidValue and launches nothing.
// kernels/autotune.py picks among them by measurement.
template <int kValue>
using Int = std::integral_constant<int, kValue>;

template <class F>
inline int with_launch_shape(int count_threads, int per_thread, int select_threads, F&& f) {
  auto select = [&](auto ct, auto cp) {
    if (select_threads == 256) return f(ct, cp, Int<256>{});
    if (select_threads == 128) return f(ct, cp, Int<128>{});
    if (select_threads == 512) return f(ct, cp, Int<512>{});
    return (int)cudaErrorInvalidValue;
  };
  if (count_threads == 256 && per_thread == 16) return select(Int<256>{}, Int<16>{});
  if (count_threads == 512 && per_thread == 8) return select(Int<512>{}, Int<8>{});
  return (int)cudaErrorInvalidValue;
}

// Both kernels on one stream, compiled for the S given when it is one the
// engines use, at a launch shape of the lattice above. hist is
// (Q*np, 2S+2) int32 scratch that the count kernel writes whole (no
// zeroing); the other outputs are written. Returns the CUDA error code.
template <bool kSphere>
inline int launch(const void* lut, const void* table, const void* codes,
                  const void* valid, const void* cids, const SphereTest& sph,
                  void* probe_ok, void* counts, void* dist, void* cand,
                  void* cand_dist, void* hist, int Q, int n_probe, int P, int S,
                  int E, int C, float bad, int count_threads, int per_thread,
                  int select_threads, void* stream) {
  return with_compiled_s(S, [&](auto ks) {
    return with_launch_shape(count_threads, per_thread, select_threads,
                             [&](auto ct, auto cp, auto st) {
      return launch_s<kSphere, decltype(ks)::value, decltype(ct)::value,
                      decltype(cp)::value, decltype(st)::value>(
          lut, table, codes, valid, cids, sph, probe_ok, counts, dist, cand, cand_dist,
          hist, Q, n_probe, P, S, E, C, bad, (cudaStream_t)stream);
    });
  });
}

}  // namespace two_stage
