// Hit-count scan for Hopper (sm_90a): the int8 reward/penalty (tier M) or
// plain (tier L) hit total of every probed point, and the first stage of
// the composed two-stage search (tier H2, fused=False); and, as a second
// epilogue, the k best of those counts, which is all that tiers M, L and
// composed H2 keep.
//
// Replaces: src/repro/kernels/hit_count.py:hit_count (_hit_kernel), as
// src/repro/kernels/ops.py:hit_count_scan vmaps it over (Q, np), and the
// lax.top_k that src/repro/core/juno.py runs over its output (l.354, l.508).
// Contract (src/repro/kernels/ref.py:hit_count_ref), per query q, probe
// and slot p of the probed cluster cid = cids[q, probe]:
//   out[q, probe, p] = valid[cid, p] ? sum_s table[q, probe, s, codes[cid, p, s]]
//                                    : -2^30                          (int32)
// and -2^30 for every slot of a probe the RT prefilter pruned
// (probe_ok[q, probe] false; probe_ok null keeps every probe). The table
// holds {-1, 0, +1} (tier M's, as selective_lut writes it) or {0, 1} (tier
// L's clip): the count kernel reads an entry by its sign, so this is
// narrower than the reference's any-int8 contract.
// The top-k epilogue (hit_count_topk_launch): per query, the k largest
// counts over the flat np*P axis w = probe*P + p and their positions, in
// lax.top_k's order (count desc, w asc), values as f32.
//
// Codes are not gathered per probe beforehand: the kernels take the
// index's (n_clusters, P, S) codes and (n_clusters, P) valid mask with the
// probed cluster ids (Q, np) and index them themselves, so no (Q, np, P, S)
// copy is written and read again.
//
// What bounds it: bytes. Each probed cluster's valid row and its valid
// points' codes are read (S bytes a point), the int8 tables (S*E bytes a
// probe) and the int32 counts written once; the top-k reads the counts and
// histograms back and writes (Q, k) values and positions.
// Design: the count kernel is the two-stage core's (two_stage.cuh:
// count_body, one block per (q, probe)): the table staged as two bit planes
// a subspace (conflict-free lookups), each lane counting its own valid
// points. It also stores each block's histogram of 2S+2 bins (one per count
// in [-S, S], bin 0 for invalid) whole, so nothing is zeroed: the top-k
// reads it, the counts-only entry stores it into a scratch buffer (one form
// of the kernel for both entries).
// The top-k kernel (hit_topk_kernel) needs no sort: counts are integers in
// a few bins, so a point's place in the output is the points of its query
// in higher bins, plus those of its bin in earlier probes (both from the
// histograms), plus those of its bin earlier in its own probe. One block
// per (q, probe) finds theta (the k-th largest count's bin) and its bins'
// offsets from the np histograms; a block that takes nothing leaves. Each
// warp then owns a contiguous segment of the probe's points, counts the
// segment's points in each bin >= theta (pass 1), takes its offsets from a
// prefix over the warps, and walks the segment again in index order,
// ranking the points of a bin among the warp's lanes with __match_any_sync
// (pass 2). A lane loads 16 counts at once, so a segment of up to 512
// points (P <= 4096) is one batch and stays in registers for pass 2, and a
// vote skips the steps of 32 points that hold none from theta up (most of
// them at the engines' k). Every output place below k is written by
// exactly one point, so no list bounds the points a block takes (k may be
// np*P), and a bin that holds every point (a table of zeros, a pruned
// probe's invalid points) needs nothing else.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "two_stage.cuh"

namespace {

using scan::kNeg;
constexpr int kTopkThreads = 256;
constexpr int kWarps = kTopkThreads / 32;
constexpr int kBatch = 16;  // counts a lane loads before it uses one

template <int kS>
__global__ void __launch_bounds__(two_stage::kCountThreads, 4)
hit_count_kernel(const int8_t* __restrict__ table,    // (Q*np, S, E)
                 const uint8_t* __restrict__ codes,   // (n_cl, P, S)
                 const uint8_t* __restrict__ valid,   // (n_cl, P)
                 const int64_t* __restrict__ cids,    // (Q*np)
                 const uint8_t* probe_ok,             // (Q*np) or null
                 int32_t* __restrict__ counts,        // (Q*np, P)
                 int32_t* __restrict__ hist,          // (Q*np, 2S+2)
                 int n_probe, int P, int S, int E) {
  const two_stage::SphereTest none{};
  two_stage::count_body<false, kS, false>(table, codes, valid, cids, none,
                                          const_cast<uint8_t*>(probe_ok), counts, hist,
                                          nullptr, n_probe, P, S, E, 0.f);
}

// A count's bin: 0 for the invalid sentinel, count + S + 1 otherwise.
__device__ __forceinline__ int bin_of(int c, int S) { return c == kNeg ? 0 : c + S + 1; }

// Dynamic shared memory of hit_topk_kernel: four per-bin rows (the query's
// points, those of the probes before, this probe's, the offsets) and one
// per warp.
inline size_t topk_smem(int S) { return sizeof(int) * (size_t)(2 * S + 2) * (4 + kWarps); }

// At most 64 registers a thread, so that four blocks share an SM: the
// kernel waits on latency, and more blocks in flight pay (uncapped, it
// took 80 registers, three blocks an SM, and was slower at Q = 128).
__global__ void __launch_bounds__(kTopkThreads, 4)
hit_topk_kernel(const int32_t* __restrict__ counts,  // (Q*np, P)
                const int32_t* __restrict__ hist,    // (Q*np, 2S+2)
                float* __restrict__ vals,            // (Q, k)
                int64_t* __restrict__ pos,           // (Q, k)
                int n_probe, int P, int S, int k) {
  extern __shared__ __align__(16) int sh[];
  __shared__ int s_tb, s_take;
  const int nbins = 2 * S + 2;
  int* tot = sh;               // per bin: the query's points,
  int* pre = tot + nbins;      // those of the probes before this one,
  int* mine = pre + nbins;     // this probe's,
  int* base = mine + nbins;    // and the output place of its first point here
  int* wbase = base + nbins;   // per warp and bin: its segment's points, then places
  const int64_t qp = blockIdx.x;
  const int q = (int)(qp / n_probe), probe = (int)(qp % n_probe);
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;

  two_stage::sum_hists<false>(hist + (int64_t)q * n_probe * nbins, n_probe, probe, nbins,
                              kTopkThreads, tot, pre, mine, nullptr);
  for (int i = threadIdx.x; i < kWarps * nbins; i += kTopkThreads) wbase[i] = 0;
  __syncthreads();
  if (warp == 0) {
    const two_stage::ThetaRun r = two_stage::theta_bin(tot, nbins, k);
    // a bin's first place: the query's points in the bins above it, then
    // its own in the probes before this one
    int above = r.above_run;
    for (int b = r.hi - 1; b >= max(r.lo, r.tb); --b) {
      base[b] = above + pre[b];
      above += tot[b];
    }
    int gt = 0;   // this probe's points above theta
    for (int b = max(r.lo, r.tb + 1); b < r.hi; ++b) gt += mine[b];
    gt = __reduce_add_sync(0xffffffffu, gt);
    if (lane == 0) {
      s_tb = r.tb;
      s_take = gt > 0 || (mine[r.tb] > 0 && r.above + pre[r.tb] < k);
    }
  }
  __syncthreads();
  if (!s_take) return;   // block-uniform
  const int tb = s_tb;
  // warp w's segment: [p0, p1), whole steps of 32 points but the last
  const int seg = ((P + kWarps - 1) / kWarps + 31) & ~31;
  const int p0 = min((int)warp * seg, P), p1 = min(p0 + seg, P);
  const int32_t* crow = counts + qp * P;
  int* wb = wbase + warp * nbins;   // this warp's row
  // the bin of the count of point j0 + u*32 + lane for u < kBatch, -1 past
  // the segment or below theta; every load issued and in range
  auto load_bins = [&](int j0, int (&c)[kBatch], int (&bin)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) c[u] = crow[min(j0 + u * 32 + (int)lane, p1 - 1)];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int b = bin_of(c[u], S);
      bin[u] = j0 + u * 32 + (int)lane < p1 && b >= tb ? b : -1;
    }
  };
  // most steps of 32 points hold none from theta up: a vote skips them
  // (warp-uniform, so the full-mask shuffles below see every lane)
  bool any_gt = false, any_tie = false;
  auto count_batch = [&](const int (&bin)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      any_gt |= bin[u] > tb;
      any_tie |= bin[u] == tb;
      if (!__any_sync(0xffffffffu, bin[u] >= 0)) continue;
      const unsigned peers = __match_any_sync(0xffffffffu, bin[u]);
      if (bin[u] >= 0 && lane == (unsigned)(__ffs(peers) - 1))
        atomicAdd(&wb[bin[u]], __popc(peers));
    }
  };
  // a point's place is its bin's next place plus the lanes before it with
  // the same bin
  const unsigned lt = (1u << lane) - 1u;
  float* vq = vals + (int64_t)q * k;
  int64_t* pq = pos + (int64_t)q * k;
  const int64_t flat0 = (int64_t)probe * P;
  auto place_batch = [&](int j0, const int (&c)[kBatch], const int (&bin)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!__any_sync(0xffffffffu, bin[u] >= 0)) continue;
      const unsigned peers = __match_any_sync(0xffffffffu, bin[u]);
      if (bin[u] >= 0) {
        const int at = wb[bin[u]] + __popc(peers & lt);
        if (at < k) {
          vq[at] = (float)c[u];
          pq[at] = flat0 + j0 + u * 32 + (int)lane;
        }
      }
      __syncwarp();   // every lane has read its bin's place
      if (bin[u] >= 0 && lane == (unsigned)(__ffs(peers) - 1)) wb[bin[u]] += __popc(peers);
      __syncwarp();
    }
  };

  // pass 1: the segment's points in each bin from theta up. A segment of
  // one batch (P <= 8 * kBatch * 32) stays in registers for pass 2.
  int c[kBatch], bin[kBatch];
  for (int j0 = p0; j0 < p1; j0 += kBatch * 32) {   // warp-uniform
    load_bins(j0, c, bin);
    count_batch(bin);
  }
  __syncthreads();
  // each warp's first place in each bin: the bin's base, then the points of
  // the bin in the segments of the warps before
  for (int b = tb + (int)threadIdx.x; b < nbins; b += kTopkThreads) {
    int run = base[b];
    for (int w = 0; w < kWarps; ++w) {
      const int t = wbase[w * nbins + b];
      wbase[w * nbins + b] = run;
      run += t;
    }
  }
  __syncthreads();
  // a warp with no point above theta and none of its ties inside the
  // quota takes nothing
  if (!__any_sync(0xffffffffu, any_gt) &&
      !(__any_sync(0xffffffffu, any_tie) && wb[tb] < k))
    return;
  // pass 2: the segment in index order
  if (p1 - p0 <= kBatch * 32) {
    if (p1 > p0) place_batch(p0, c, bin);
  } else {
    for (int j0 = p0; j0 < p1; j0 += kBatch * 32) {
      load_bins(j0, c, bin);
      place_batch(j0, c, bin);
    }
  }
}

// The count kernel, compiled for the S of the repo's two configurations as
// the two-stage core is (two_stage::with_compiled_s).
int launch_count(const void* table, const void* codes, const void* valid, const void* cids,
                 const void* probe_ok, void* counts, void* hist, int Q, int n_probe, int P,
                 int S, int E, cudaStream_t st) {
  return two_stage::with_compiled_s(S, [&](auto ks) {
    constexpr int kS = decltype(ks)::value;
    const size_t smem = two_stage::count_smem(S);
    const int err = scan::allow_smem(hit_count_kernel<kS>, smem);
    if (err) return err;
    hit_count_kernel<kS><<<(unsigned)(Q * n_probe), two_stage::kCountThreads, smem, st>>>(
        (const int8_t*)table, (const uint8_t*)codes, (const uint8_t*)valid,
        (const int64_t*)cids, (const uint8_t*)probe_ok, (int32_t*)counts, (int32_t*)hist,
        n_probe, P, S, E);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// table: (Q, np, S, E) int8 in {-1, 0, +1}; codes: (n_cl, P, S) uint8;
// valid: (n_cl, P) bool; cids: (Q, np) int64 cluster ids; probe_ok: (Q, np)
// bool or null; out: (Q, np, P) int32, written; hist (Q, np, 2S+2) int32,
// scratch that the count kernel writes whole. One kernel.
extern "C" int hit_count_launch(const void* table, const void* codes,
                                const void* valid, const void* cids,
                                const void* probe_ok, void* out, void* hist,
                                int Q, int n_probe, int P, int S, int E,
                                void* stream) {
  return launch_count(table, codes, valid, cids, probe_ok, out, hist, Q, n_probe, P, S, E,
                      (cudaStream_t)stream);
}

// The same inputs and 1 <= k <= np*P; counts (Q, np, P) and hist
// (Q, np, 2S+2) int32 are scratch that the count kernel writes whole;
// vals (Q, k) f32 and pos (Q, k) int64 are written. Two kernels.
extern "C" int hit_count_topk_launch(const void* table, const void* codes,
                                     const void* valid, const void* cids,
                                     const void* probe_ok, void* counts, void* hist,
                                     void* vals, void* pos, int Q, int n_probe, int P,
                                     int S, int E, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_count(table, codes, valid, cids, probe_ok, counts, hist, Q, n_probe, P, S,
                         E, st);
  if (err) return err;
  const size_t smem = topk_smem(S);
  err = scan::allow_smem(hit_topk_kernel, smem);
  if (err) return err;
  hit_topk_kernel<<<(unsigned)(Q * n_probe), kTopkThreads, smem, st>>>(
      (const int32_t*)counts, (const int32_t*)hist, (float*)vals, (int64_t*)pos, n_probe, P,
      S, k);
  return (int)cudaGetLastError();
}
