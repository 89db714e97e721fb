// Masked ADC scan for Hopper (sm_90a): the tier-H distance (l2) or
// similarity (ip) of every probed point from its probe's masked LUT, and,
// as a second entry, the k best of them over each query's np*P points,
// which is all that tier H keeps.
//
// Replaces: src/repro/kernels/pq_scan.py:pq_scan (_scan_kernel), as
// src/repro/kernels/ops.py:masked_adc_scan vmaps it over (Q, np), and the
// probe_base add and lax.top_k that src/repro/core/juno.py runs over its
// output (l.296-299, l.354).
// Contract (src/repro/kernels/ref.py:pq_scan_ref), per query q, probe and
// slot p of the probed cluster cid = cids[q, probe]:
//   out[q, probe, p] = valid[cid, p] ? sum_s lut[q, probe, s, codes[cid, p, s]]
//                                    : bad      (+inf for l2, -inf for ip)
// and bad for every slot of a probe the RT prefilter pruned
// (probe_ok[q, probe] false; probe_ok null keeps every probe), with s
// ascending, one f32 rounding per add (scan_common.cuh:gather_sum's order,
// as before this redesign: the same bits). The plain version sums in
// another order, so the two agree within ~S ulps of the sum of the terms'
// magnitudes.
// The top-k entry (pq_scan_topk_launch): per query, the k best of
// out[q] + base[q, probe] (one f32 add, ip's stage-A offset; none when base
// is null) over the flat axis w = probe*P + p, in lax.top_k's order: l2
// distance ascending, ip similarity descending, equal scores by w
// ascending; the values as they are, the positions as int64. Invalid and
// pruned slots carry their +-inf and fill in w order when fewer than k
// points are valid.
//
// Codes are read through the probed cluster ids, as in hit_count.cu: the
// (Q, np, P, S) gathered copy the reference scans (385 MB at Q=128,
// np=16, P=3912, S=48) is never made.
//
// What bounds it: bytes. The f32 LUT is read once per probe (S*E*4 bytes:
// 48 KB at S=48, 100 KB at S=100), each probed cluster's valid row and its
// valid points' codes once; the scores-only entry writes the f32 scores
// (32 MB at Q=128, np=16, P=3912), the top-k entry (Q, k) values and
// positions and (Q, np, min(k, P)) candidates in between (1.6 MB at k=100).
// Next come the LUT gathers in shared memory: a warp's 32 lanes read 32
// random code bytes of one subspace, so about 3.5 of the 32 banks' words
// collide a load. No layout of the table spreads them (the bank is the
// code's low 5 bits whatever the row stride), so they are accepted.
//
// Design: one block per (q, probe) runs the scan body (scan_probe), shared
// by both entries: the LUT staged in shared memory by asynchronous copies
// (cp.async, every copy in flight at once; above 48 KB the launch opts in
// to more, which at S=100 leaves room for two blocks an SM), each thread
// holding the valid flags of kPer points of a chunk (point j*512 + thread)
// as a mask and summing its own valid points one a step, so that no lane
// idles on an invalid slot where valid slots are scattered, and a cluster
// whose valid slots are packed at its front (as a built index has them)
// spreads them over every lane. The scores-only kernel (pq_scan_kernel)
// stores each sum, and bad at each invalid slot.
// The top-k route is two kernels and no sort:
//  (a) pq_topk_kernel keeps each point's score in a register (kPer a
//      thread: P <= 4096 takes 8, P <= 8192 16), turns it into its key
//      (the order-preserving image of the score, negated at l2, -0 folded
//      onto +0 so that equal scores tie) and finds the probe's min(k, P)
//      best by a radix select over 64-bit composites (the key, then ~w, so
//      a lower w ranks first): among its valid points when it has min(k,
//      P) of them, else every valid point and the lowest-w invalid slots;
//      8-bit digits from the first byte on which two items differ, a
//      256-bin shared histogram a pass, stopping at the first digit whose
//      bin holds exactly the places left (radix_select). It writes those
//      candidates' scores and positions (unordered) to a (Q*np, min(k, P))
//      scratch. Within a probe the flat order is p order, so every member
//      of the query's top k is in its own probe's top min(k, P): fewer
//      than k points of the query beat it, so fewer than k of its probe
//      do. A pruned probe's candidates are its first min(k, P) slots,
//      written without a scan.
//  (b) pq_merge_kernel, one block per query, selects the k best of the
//      np*min(k, P) candidates the same way (read from L2 a pass), lists
//      them in shared memory and writes each at its rank, the number of
//      listed composites above its own (k*k comparisons, at most 1M at
//      k = kKMax). Composites are distinct, so the ranks are a
//      permutation of 0..k-1 and every output place is written once.
// No memset and no copy: the candidates are scratch that (a) writes whole.
#include <cuda_runtime.h>
#include <stdint.h>

#include "two_stage.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kScanPer = 8;     // points of a chunk a thread holds the flags of
constexpr int kMergeThreads = 512;
constexpr int kKMax = 1024;     // the most results the top-k entry takes (K_MAX)
constexpr int kBins = 256;      // one radix digit

// Copy n_bytes from global src to shared dst with the whole block as
// 16-byte asynchronous copies, all issued before any is waited for, when
// the size and the source allow it (scan::stage otherwise). The caller
// synchronises the block afterwards.
__device__ __forceinline__ void stage_async(void* dst, const void* src, int n_bytes) {
  if ((n_bytes & 15) || (reinterpret_cast<uintptr_t>(src) & 15)) {
    scan::stage(dst, src, n_bytes);
    return;
  }
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x; i < n_bytes / 16; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                 "l"(s + 16 * (size_t)i));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The scan body of one kept probe: its LUT (S, E) staged in shared memory,
// then each of its P points: on_valid(j, p, sum) for a valid point,
// on_invalid(j, p) for an invalid one, p = c0 + j*kThreads + threadIdx.x
// in chunks of kThreads*kPer points. The sum is two_stage::adc_sum's
// (scan_common.cuh:gather_sum's order), in both entries.
template <int kS, int kPer, class OnValid, class OnInvalid>
__device__ __forceinline__ void scan_probe(const float* __restrict__ lut,
                                           const uint8_t* __restrict__ crow,
                                           const uint8_t* __restrict__ vrow, int P, int S,
                                           int E, OnValid on_valid, OnInvalid on_invalid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* tab = reinterpret_cast<const float*>(smem);
  constexpr int kChunk = kThreads * kPer;
  // a chunk's valid flags as a mask, point j*kThreads + threadIdx.x of the
  // chunk at bit j; every load issued and in range. The first chunk's are
  // in flight while the table is staged.
  auto load_flags = [&](int c0, int n) {
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      m |= (uint32_t)(vrow[c0 + min(i, n - 1)] != 0 && i < n) << j;
    }
    return m;
  };
  uint32_t m = load_flags(0, min(kChunk, P));
  stage_async(smem, lut, S * E * (int)sizeof(float));
  __syncthreads();
  for (int c0 = 0; c0 < P; c0 += kChunk) {
    const int n = min(kChunk, P - c0);
    if (c0 > 0) m = load_flags(c0, n);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (i < n && !((m >> j) & 1u)) on_invalid(j, c0 + i);
    }
    // each lane sums its next valid point a step, or at S = 100 its next
    // two (both in one block of code, so that the second point's loads are
    // issued while the first point's adds run: 14% less time a scores call
    // at S = 100, but 11% more at S = 48, on the H100): a warp takes as
    // many steps as its lane with the most
    constexpr bool kPair = kS > 64;
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int p = c0 + j * kThreads + threadIdx.x;
      if (kPair && m) {
        const int j2 = __ffs(m) - 1;
        m &= m - 1;
        const int p2 = c0 + j2 * kThreads + threadIdx.x;
        const float v = two_stage::adc_sum<kS>(tab, crow + (int64_t)p * S, S, E);
        const float v2 = two_stage::adc_sum<kS>(tab, crow + (int64_t)p2 * S, S, E);
        on_valid(j, p, v);
        on_valid(j2, p2, v2);
      } else {
        on_valid(j, p, two_stage::adc_sum<kS>(tab, crow + (int64_t)p * S, S, E));
      }
    }
  }
}

template <int kS>
__global__ void __launch_bounds__(kThreads, 2)
pq_scan_kernel(const float* __restrict__ lut,       // (Q*np, S, E)
               const uint8_t* __restrict__ codes,   // (n_cl, P, S)
               const uint8_t* __restrict__ valid,   // (n_cl, P)
               const int64_t* __restrict__ cids,    // (Q*np)
               const uint8_t* __restrict__ probe_ok,  // (Q*np) or null
               float* __restrict__ out,             // (Q*np, P)
               int P, int S, int E, float bad) {
  if constexpr (kS > 0) S = kS;
  const int64_t qp = blockIdx.x;
  float* orow = out + qp * P;
  if (!scan::probe_kept(probe_ok, qp)) {   // block-uniform: the whole block leaves
    for (int p = threadIdx.x; p < P; p += kThreads) orow[p] = bad;
    return;
  }
  const int64_t cid = cids[qp];
  scan_probe<kS, kScanPer>(
      lut + qp * S * E, codes + cid * (int64_t)P * S, valid + cid * (int64_t)P, P, S, E,
      [&](int, int p, float v) { orow[p] = v; }, [&](int, int p) { orow[p] = bad; });
}

// The order-preserving image of a score (negated when lower is better, -0
// folded onto +0 so that equal scores tie): a larger key is a better point.
__device__ __forceinline__ uint32_t key_of(float v, bool lower_better) {
  uint32_t b = __float_as_uint(lower_better ? -v : v);
  if ((b << 1) == 0) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The score of a key. A kernel's score is never -0 (its sum starts at +0,
// and x + y is -0 only when both are), so the fold loses nothing.
__device__ __forceinline__ float score_of(uint32_t key, bool lower_better) {
  const float y = __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
  return lower_better && y != 0.f ? -y : y;
}

// The composite a point ranks by: its key above ~w, so that a larger
// composite is a better point and equal scores rank by w ascending.
__device__ __forceinline__ uint64_t composite(uint32_t key, uint32_t w) {
  return (uint64_t)key << 32 | (uint32_t)~w;
}

// The position a composite holds.
__device__ __forceinline__ uint32_t position_of(uint64_t c) { return ~(uint32_t)c; }

// What a radix select leaves: the items with (c & mask) >= prefix are the
// `need` largest.
struct Cut {
  uint64_t prefix, mask;
};

// Shared state of a radix select: a digit's histogram, in two buffers so
// that a pass zeroes the next pass's while one warp reads its own; the
// digit a pass found with the items above it; each warp's AND, OR and
// count of its items.
struct SelectSmem {
  int hist[2][kBins];
  int digit, above;
  uint64_t w_and[32], w_or[32];
  int w_n[32];
};

// The most static shared memory a scan-body kernel takes beside its LUT
// (pq_topk_kernel: a SelectSmem and s_count; TOPK_STATIC_SMEM in
// kernels/pq_scan.py, whose shape guard leaves this much room).
constexpr int kTopkStaticSmem = 3072;
static_assert(sizeof(SelectSmem) + sizeof(int) <= kTopkStaticSmem,
              "the shape guard in kernels/pq_scan.py leaves too little room");

// The block-wide AND and OR of the items and their number.
struct Span {
  uint64_t all, any;
  int n;
};

// for_each(fn) calls fn(c, on, idx) once for every item slot (idx: the
// caller's index of the slot), in a trip count that is the same on every
// lane of a warp (the full-mask warp reductions and votes need every
// lane), on false for a slot that holds no item. item_span returns the
// block-wide Span of the items and zeroes both histograms; one block
// barrier. Two calls need a barrier between them (the per-warp rows are
// reused).
template <class ForEach>
__device__ __forceinline__ Span item_span(SelectSmem& sh, ForEach for_each) {
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  uint64_t all = ~0ull, any = 0;
  int n = 0;
  for_each([&](uint64_t c, bool on, int) {
    if (on) {
      all &= c;
      any |= c;
      ++n;
    }
  });
  const uint64_t w_all =
      (uint64_t)__reduce_and_sync(0xffffffffu, (unsigned)(all >> 32)) << 32 |
      __reduce_and_sync(0xffffffffu, (unsigned)all);
  const uint64_t w_any =
      (uint64_t)__reduce_or_sync(0xffffffffu, (unsigned)(any >> 32)) << 32 |
      __reduce_or_sync(0xffffffffu, (unsigned)any);
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) {
    sh.w_and[warp] = w_all;
    sh.w_or[warp] = w_any;
    sh.w_n[warp] = n;
  }
  for (int i = threadIdx.x; i < 2 * kBins; i += blockDim.x) (&sh.hist[0][0])[i] = 0;
  __syncthreads();
  Span r{~0ull, 0, 0};
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    r.all &= sh.w_and[w];
    r.any |= sh.w_or[w];
    r.n += sh.w_n[w];
  }
  return r;
}

// The `need` largest of the block's items (composites, all distinct; need
// at least 1 and at most span.n), given their Span from item_span (which
// zeroed the histograms). The digits above the first bit on which two
// items differ are common to all, so the passes start at the byte that
// holds it (for l2 distances of one exponent: the sign and exponent bits
// are skipped). Digit by digit from there, each pass counts the items that
// match the digits found so far (shared atomics, one an item: 4% faster a
// call than aggregating a warp's equal digits with __match_any_sync), a
// warp finds the digit of the need-th largest, and the select stops at the
// first digit whose bin holds exactly the places left (the last digit's
// does: composites are distinct). Two block barriers a pass.
template <class ForEach>
__device__ __forceinline__ Cut radix_select(int need, const Span& span, SelectSmem& sh,
                                            ForEach for_each) {
  const uint64_t diff = span.all ^ span.any;
  if (diff == 0) return {span.all, ~0ull};   // a single item
  const unsigned lane = threadIdx.x & 31u;
  int shift = (63 - __clzll((long long)diff)) & ~7;
  uint64_t mask = shift >= 56 ? 0ull : ~0ull << (shift + 8);
  uint64_t prefix = span.all & mask;
  for (int b = 0;; b ^= 1) {
    int* hist = sh.hist[b];
    for_each([&](uint64_t c, bool on, int) {
      if (on && (c & mask) == prefix) atomicAdd(&hist[(c >> shift) & 255u], 1);
    });
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l sums bins [hi - 8, hi) from the top; the first lane whose
      // running sum reaches need holds the digit
      const int hi = kBins - 8 * (int)lane;
      int h[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = hist[hi - 1 - i];   // from the top
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += h[i];
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= (unsigned)o) incl += y;
      }
      const int f = __ffs(__ballot_sync(0xffffffffu, incl >= need)) - 1;
      if ((int)lane == f) {
        int i = 0, above = incl - sum;
#pragma unroll
        for (int t = 0; t < 7; ++t)
          if (i == t && above + h[t] < need) {
            above += h[t];
            i = t + 1;
          }
        sh.digit = hi - 1 - i;
        sh.above = above;
      }
    } else {   // the next pass's histogram, last read before this pass
      int* next = sh.hist[b ^ 1];
      for (int i = threadIdx.x - 32; i < kBins; i += blockDim.x - 32) next[i] = 0;
    }
    __syncthreads();
    const int d = sh.digit;
    need -= sh.above;
    prefix |= (uint64_t)d << shift;
    mask |= (uint64_t)0xffu << shift;
    if (hist[d] == need) break;
    shift -= 8;
  }
  return {prefix, mask};
}

// A place in a list of `count` for each of a lane's kPer slots that take
// one (take bit j for slot j), in one shared atomic a warp: the warp's
// takers slot by slot and in lane order, after those of the warps before
// it in time. at[j] is slot j's place where its bit is set.
template <int kPer>
__device__ __forceinline__ void take_places(uint32_t take, int* count, int (&at)[kPer]) {
  const unsigned lane = threadIdx.x & 31u, lt = (1u << lane) - 1u;
  unsigned takers[kPer];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    takers[j] = __ballot_sync(0xffffffffu, (take >> j) & 1u);
    total += __popc(takers[j]);
  }
  int base = 0;
  if (lane == 0 && total) base = atomicAdd(count, total);
  base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    at[j] = base + __popc(takers[j] & lt);
    base += __popc(takers[j]);
  }
}

template <int kS, int kPer>
__global__ void __launch_bounds__(kThreads, 2)
pq_topk_kernel(const float* __restrict__ lut,       // (Q*np, S, E)
               const uint8_t* __restrict__ codes,   // (n_cl, P, S)
               const uint8_t* __restrict__ valid,   // (n_cl, P)
               const int64_t* __restrict__ cids,    // (Q*np)
               const uint8_t* __restrict__ probe_ok,  // (Q*np) or null
               const float* __restrict__ base,      // (Q*np) or null
               float* __restrict__ cand_val,        // (Q*np, kk)
               int32_t* __restrict__ cand_pos,      // (Q*np, kk)
               int n_probe, int P, int S, int E, int kk, float bad, int lower_better) {
  __shared__ SelectSmem sh;
  __shared__ int s_count;
  if constexpr (kS > 0) S = kS;
  const int64_t qp = blockIdx.x;
  const uint32_t w0 = (uint32_t)(qp % n_probe) * (uint32_t)P;
  float* cv = cand_val + qp * kk;
  int32_t* cw = cand_pos + qp * kk;
  if (!scan::probe_kept(probe_ok, qp)) {   // every slot invalid: the first kk
    for (int i = threadIdx.x; i < kk; i += kThreads) {
      cv[i] = bad;
      cw[i] = (int32_t)(w0 + i);
    }
    return;
  }
  if (threadIdx.x == 0) s_count = 0;
  const int64_t cid = cids[qp];
  float sc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) sc[j] = bad;
  uint32_t vmask = 0;   // bit j: slot j of this thread is valid
  const bool has_base = base != nullptr;
  const float add = has_base ? base[qp] : 0.f;
  scan_probe<kS, kPer>(
      lut + qp * S * E, codes + cid * (int64_t)P * S, valid + cid * (int64_t)P, P, S, E,
      [&](int j, int, float v) {
        if (has_base) v += add;
        vmask |= 1u << j;
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (i == j) sc[i] = v;
      },
      [](int, int) {});
  const bool lb = lower_better != 0;
  // the keys, computed once: the select reads them in every pass
  uint32_t key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) key[j] = key_of(sc[j], lb);
  // the valid slots (want_valid) or the invalid ones as select items
  auto items = [&](bool want_valid) {
    return [&, want_valid](auto&& fn) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int p = j * kThreads + threadIdx.x;
        fn(composite(key[j], w0 + (uint32_t)p),
           p < P && (((vmask >> j) & 1u) != 0) == want_valid, j);
      }
    };
  };
  // kk valid points when the probe has that many; else every valid point
  // and the first kk - n_valid invalid slots (the sentinel's ties, by w)
  Cut cut{0, 0};
  bool all_valid = true;
  if (kk < P) {
    const Span sv = item_span(sh, items(true));
    if (sv.n >= kk) {
      cut = radix_select(kk, sv, sh, items(true));
    } else {
      all_valid = false;
      __syncthreads();   // every thread has read the valid items' span
      const Span si = item_span(sh, items(false));
      cut = radix_select(kk - sv.n, si, sh, items(false));
    }
  }
  uint32_t take = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = j * kThreads + threadIdx.x;
    const bool is_valid = (vmask >> j) & 1u;
    const bool in_cut = (composite(key[j], w0 + (uint32_t)p) & cut.mask) >= cut.prefix;
    take |= (uint32_t)(p < P && (kk == P || (all_valid ? is_valid && in_cut
                                                       : is_valid || in_cut))) << j;
  }
  int at[kPer];
  take_places<kPer>(take, &s_count, at);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((take >> j) & 1u) {
      cv[at[j]] = score_of(key[j], lb);
      cw[at[j]] = (int32_t)(w0 + (uint32_t)(j * kThreads + threadIdx.x));
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
pq_merge_kernel(const float* __restrict__ cand_val,     // (Q, n)
                const int32_t* __restrict__ cand_pos,   // (Q, n)
                float* __restrict__ vals,               // (Q, k)
                int64_t* __restrict__ pos,              // (Q, k)
                int n, int k, int lower_better) {
  __shared__ SelectSmem sh;
  __shared__ uint64_t s_comp[kKMax];
  __shared__ float s_val[kKMax];
  __shared__ int s_count;
  const int64_t q = blockIdx.x;
  const float* cv = cand_val + q * n;
  const int32_t* cw = cand_pos + q * n;
  const bool lb = lower_better != 0;
  if (threadIdx.x == 0) s_count = 0;
  auto for_each = [&](auto&& fn) {
    for (int i0 = 0; i0 < n; i0 += kMergeThreads) {   // warp-uniform
      const int i = i0 + threadIdx.x;
      const bool on = i < n;
      fn(on ? composite(key_of(__ldg(cv + i), lb), (uint32_t)__ldg(cw + i)) : 0ull, on, i);
    }
  };
  Cut cut{0, 0};
  if (k < n) cut = radix_select(k, item_span(sh, for_each), sh, for_each);
  __syncthreads();   // s_count is set
  for_each([&](uint64_t c, bool on, int i) {
    const bool take = on && (c & cut.mask) >= cut.prefix;
    int at[1];
    take_places<1>(take, &s_count, at);
    if (take) {
      s_comp[at[0]] = c;
      s_val[at[0]] = __ldg(cv + i);
    }
  });
  __syncthreads();
  // each listed candidate at its rank: the listed composites above its own
  float* vq = vals + q * k;
  int64_t* pq = pos + q * k;
  for (int i = threadIdx.x; i < k; i += kMergeThreads) {
    const uint64_t c = s_comp[i];
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += s_comp[j] > c;
    vq[rank] = s_val[i];
    pq[rank] = (int64_t)position_of(c);
  }
}

// Let a kernel take `bytes` of dynamic shared memory beside its static
// shared memory: the opt-in is made at every size (scan::allow_smem makes
// it from 48 KB of dynamic memory on, but the default limit covers static
// and dynamic together). Returns the CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// lut: (Q, np, S, E) f32; codes: (n_cl, P, S) uint8; valid: (n_cl, P)
// bool; cids: (Q, np) int64 cluster ids; probe_ok: (Q, np) bool or null;
// out: (Q, np, P) f32, written. One kernel.
extern "C" int pq_scan_launch(const void* lut, const void* codes,
                              const void* valid, const void* cids,
                              const void* probe_ok, void* out,
                              int Q, int n_probe, int P, int S, int E,
                              float bad, void* stream) {
  return two_stage::with_compiled_s(S, [&](auto ks) {
    constexpr int kS = decltype(ks)::value;
    const size_t smem = (size_t)S * E * sizeof(float);
    const int err = allow_smem(pq_scan_kernel<kS>, smem);
    if (err) return err;
    pq_scan_kernel<kS><<<(unsigned)(Q * n_probe), kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)lut, (const uint8_t*)codes, (const uint8_t*)valid,
        (const int64_t*)cids, (const uint8_t*)probe_ok, (float*)out, P, S, E, bad);
    return (int)cudaGetLastError();
  });
}

// The same inputs, base (Q, np) f32 or null, 1 <= k <= min(np*P, kKMax),
// P <= 8192 and np*P < 2^31; cand_val (Q, np, min(k, P)) f32 and cand_pos
// (Q, np, min(k, P)) int32 are scratch that the first kernel writes whole;
// vals (Q, k) f32 and pos (Q, k) int64 are written. Two kernels.
extern "C" int pq_scan_topk_launch(const void* lut, const void* codes,
                                   const void* valid, const void* cids,
                                   const void* probe_ok, const void* base,
                                   void* cand_val, void* cand_pos, void* vals,
                                   void* pos, int Q, int n_probe, int P, int S,
                                   int E, int k, float bad, int lower_better,
                                   void* stream) {
  if (k < 1 || k > kKMax || k > n_probe * P || P > 16 * kThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kk = k < P ? k : P;
  const int err = two_stage::with_compiled_s(S, [&](auto ks) {
    constexpr int kS = decltype(ks)::value;
    auto launch = [&](auto kernel) {
      const size_t smem = (size_t)S * E * sizeof(float);
      const int e = allow_smem(kernel, smem);
      if (e) return e;
      kernel<<<(unsigned)(Q * n_probe), kThreads, smem, st>>>(
          (const float*)lut, (const uint8_t*)codes, (const uint8_t*)valid,
          (const int64_t*)cids, (const uint8_t*)probe_ok, (const float*)base,
          (float*)cand_val, (int32_t*)cand_pos, n_probe, P, S, E, kk, bad, lower_better);
      return (int)cudaGetLastError();
    };
    return P <= 8 * kThreads ? launch(pq_topk_kernel<kS, 8>) : launch(pq_topk_kernel<kS, 16>);
  });
  if (err) return err;
  pq_merge_kernel<<<(unsigned)Q, kMergeThreads, 0, st>>>(
      (const float*)cand_val, (const int32_t*)cand_pos, (float*)vals, (int64_t*)pos,
      n_probe * kk, k, lower_better);
  return (int)cudaGetLastError();
}
