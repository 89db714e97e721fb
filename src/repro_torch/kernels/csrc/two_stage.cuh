// The two kernels of the fused two-stage scan, shared by fused_two_stage.cu
// and fused_three_stage.cu: int8 hit counts -> survivor threshold -> top-C
// candidates -> masked ADC on the candidates only.
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
// Design:
//  (a) count_kernel, one block per (q, probe): thread 0 decides whether the
//      probe is kept; a kept probe's S*E int8 table is staged in shared
//      memory (12 KB at S=48, 25.6 KB at S=100), each thread takes points
//      and reads their codes in 16- or 4-byte words (the sum is
//      scan_common.cuh's, shared with hit_count.cu), and a per-query
//      histogram of 2S+2 bins (one per count in [-S, S], one for invalid)
//      is built with warp-aggregated shared atomics and flushed to global.
//      A pruned probe reads no table and no codes: its P points go to the
//      invalid bin.
//  (b) select_kernel, one block per query: theta, n_gt and the tie quota
//      come from the histogram; two block-wide prefix sums per 1024-wide
//      window over W (tie rank, then take position) compact the
//      candidates in index order; then each thread sums one candidate's
//      S LUT entries in subspace order (scan_common.cuh, as pq_scan.cu
//      does) and scatters it into dist.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "sphere.cuh"

namespace two_stage {

using scan::kNeg;
constexpr int kCountThreads = 256;
constexpr int kSelectThreads = 1024;

// Phase 0 of the three-stage scan: the ray-plane queries and the grid's
// slot planes. Unused (all null) in the two-stage scan.
struct SphereTest {
  const float* q0;          // (Q,) ray-plane query coordinates
  const float* q1;
  const float* radius;      // (Q,) ray-plane radii
  const float* c0;          // (n_cells*cap,) slot centroid coordinates
  const float* c1;
  const float* reach;       // (n_cells*cap,) slot reach, -inf at pads
  const int32_t* slot_idx;  // (Q*np,) grid slot of each probed cluster
};

template <bool kSphere>
__global__ void count_kernel(const int8_t* __restrict__ table,    // (Q*np, S, E)
                             const uint8_t* __restrict__ codes,   // (n_cl, P, S)
                             const uint8_t* __restrict__ valid,   // (n_cl, P)
                             const int64_t* __restrict__ cids,    // (Q*np)
                             SphereTest sph,
                             uint8_t* probe_ok,                   // (Q*np) in, or out
                             int32_t* __restrict__ counts,        // (Q*np, P)
                             int32_t* __restrict__ hist,          // (Q, 2S+2)
                             int n_probe, int P, int S, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_keep;
  const int tab_bytes = S * E;
  const int8_t* tab = reinterpret_cast<const int8_t*>(smem);
  int* h = reinterpret_cast<int*>(smem + ((tab_bytes + 15) & ~15));
  const int nbins = 2 * S + 2;
  const int64_t qp = blockIdx.x;
  const int q = (int)(qp / n_probe);
  const int64_t cid = cids[qp];

  if (threadIdx.x == 0) {
    bool keep;
    if constexpr (kSphere) {
      const int32_t slot = sph.slot_idx[qp];
      keep = qp % n_probe == 0 ||   // probe 0 is always scanned
             rt::sphere_hit(sph.q0[q], sph.q1[q], sph.radius[q], sph.c0[slot],
                            sph.c1[slot], sph.reach[slot]);
      probe_ok[qp] = keep;
    } else {
      keep = scan::probe_kept(probe_ok, qp);
    }
    s_keep = keep;
  }
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const bool keep = s_keep;
  if (keep) scan::stage(smem, table + qp * tab_bytes, tab_bytes);
  __syncthreads();

  const uint8_t* crow = codes + cid * (int64_t)P * S;
  const uint8_t* vrow = valid + cid * (int64_t)P;
  int32_t* out = counts + qp * P;
  const unsigned lane = threadIdx.x & 31u;
  // every lane runs every trip (the loop bound is block-uniform), so the
  // full-mask __match_any_sync below sees the whole warp
  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < P;
    int cnt = kNeg, bin = live ? 0 : -1;
    if (live && keep && vrow[p]) {
      cnt = scan::gather_sum<int>(tab, crow + (int64_t)p * S, S, E);
      // hit tables hold {-1, 0, +1}, so cnt lies in [-S, S]; the clamp only
      // keeps an out-of-contract table from writing outside the histogram
      bin = min(max(cnt + S + 1, 1), 2 * S + 1);
    }
    if (live) out[p] = cnt;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (live && lane == (unsigned)(__ffs(peers) - 1)) atomicAdd(&h[bin], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x)
    if (h[i]) atomicAdd(&hist[(int64_t)q * nbins + i], h[i]);
}

// Exclusive block-wide prefix sum of x; *total receives the block's sum.
// Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int x, int* total, int* sums) {
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const unsigned nwarps = (blockDim.x + 31u) >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= (unsigned)o) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? sums[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= (unsigned)o) wi += y;
    }
    sums[lane] = wi - w;
    if (lane == 31) sums[32] = wi;
  }
  __syncthreads();
  const int res = sums[warp] + incl - x;
  *total = sums[32];
  __syncthreads();
  return res;
}

__global__ void select_kernel(const int32_t* __restrict__ counts,  // (Q, W)
                              const int32_t* __restrict__ hist,    // (Q, 2S+2)
                              const float* __restrict__ lut,       // (Q*np, S, E)
                              const uint8_t* __restrict__ codes,
                              const uint8_t* __restrict__ valid,
                              const int64_t* __restrict__ cids,
                              const uint8_t* __restrict__ probe_ok,  // (Q*np) or null
                              float* __restrict__ dist,            // (Q, W)
                              int32_t* __restrict__ cand,          // (Q, C)
                              float* __restrict__ cand_dist,       // (Q, C)
                              int n_probe, int P, int S, int E, int C,
                              float bad) {
  __shared__ int sums[33];
  __shared__ int s_theta, s_quota;
  const int q = blockIdx.x;
  const int64_t W = (int64_t)n_probe * P;
  const int nbins = 2 * S + 2;
  if (threadIdx.x == 0) {
    const int32_t* hq = hist + (int64_t)q * nbins;
    int cum = 0, b = nbins - 1;
    for (; b > 0; --b) {
      if (cum + hq[b] >= C) break;
      cum += hq[b];
    }
    s_theta = b == 0 ? kNeg : b - S - 1;
    s_quota = C - cum;
  }
  float* drow = dist + q * W;
  for (int64_t i = threadIdx.x; i < W; i += blockDim.x) drow[i] = bad;
  __syncthreads();
  const int theta = s_theta, quota = s_quota;

  const int32_t* crow = counts + q * W;
  int32_t* cq = cand + (int64_t)q * C;
  int tie_base = 0, take_base = 0;
  for (int64_t base = 0; base < W && take_base < C; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int c = i < W ? crow[i] : INT_MIN;
    const int is_tie = c == theta;
    int n_tie, n_take;
    const int tie_rank = tie_base + block_exclusive_scan(is_tie, &n_tie, sums);
    const int take = (c > theta) || (is_tie && tie_rank < quota);
    const int pos = take_base + block_exclusive_scan(take, &n_take, sums);
    if (take) cq[pos] = (int32_t)i;
    tie_base += n_tie;
    take_base += n_take;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const int i = cq[j];
    const int probe = i / P, p = i % P;
    const int64_t qp = (int64_t)q * n_probe + probe;
    const int64_t cid = cids[qp];
    const float v = valid[cid * P + p] && scan::probe_kept(probe_ok, qp)
        ? scan::gather_sum<float>(lut + qp * S * E, codes + (cid * P + p) * S, S, E)
        : bad;
    cand_dist[(int64_t)q * C + j] = v;
    drow[i] = v;
  }
}

// Both kernels on one stream. hist (Q, 2S+2) int32 must be zeroed; the
// other outputs are written. Returns the CUDA error code.
template <bool kSphere>
inline int launch(const void* lut, const void* table, const void* codes,
                  const void* valid, const void* cids, const SphereTest& sph,
                  void* probe_ok, void* counts, void* dist, void* cand,
                  void* cand_dist, void* hist, int Q, int n_probe, int P, int S,
                  int E, int C, float bad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)((S * E + 15) & ~15) + sizeof(int) * (2 * S + 2);
  const int smem_err = scan::allow_smem(count_kernel<kSphere>, smem);
  if (smem_err) return smem_err;
  count_kernel<kSphere><<<(unsigned)(Q * n_probe), kCountThreads, smem, st>>>(
      (const int8_t*)table, (const uint8_t*)codes, (const uint8_t*)valid,
      (const int64_t*)cids, sph, (uint8_t*)probe_ok, (int32_t*)counts,
      (int32_t*)hist, n_probe, P, S, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_kernel<<<(unsigned)Q, kSelectThreads, 0, st>>>(
      (const int32_t*)counts, (const int32_t*)hist, (const float*)lut,
      (const uint8_t*)codes, (const uint8_t*)valid, (const int64_t*)cids,
      (const uint8_t*)probe_ok, (float*)dist, (int32_t*)cand, (float*)cand_dist,
      n_probe, P, S, E, C, bad);
  return (int)cudaGetLastError();
}

}  // namespace two_stage
