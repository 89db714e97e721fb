// Hit-count scan for Hopper (sm_90a): the int8 reward/penalty (tier M) or
// plain (tier L) hit total of every probed point, and the first stage of
// the composed two-stage search (tier H2, fused=False).
//
// Replaces: src/repro/kernels/hit_count.py:hit_count (_hit_kernel), as
// src/repro/kernels/ops.py:hit_count_scan vmaps it over (Q, np).
// Contract (src/repro/kernels/ref.py:hit_count_ref), per query q, probe
// and slot p of the probed cluster cid = cids[q, probe]:
//   out[q, probe, p] = valid[cid, p] ? sum_s table[q, probe, s, codes[cid, p, s]]
//                                    : -2^30                          (int32)
// and -2^30 for every slot of a probe the RT prefilter pruned
// (probe_ok[q, probe] false; probe_ok null keeps every probe).
//
// Codes are not gathered per probe beforehand: the kernel takes the
// index's (n_clusters, P, S) codes and (n_clusters, P) valid mask with the
// probed cluster ids (Q, np) and indexes them itself, so no (Q, np, P, S)
// copy is written and read again.
//
// What bounds it: bytes. Each probed cluster's valid row and its valid
// points' codes are read (S bytes a point), the int8 tables (S*E bytes a
// probe) and the int32 output written once; the arithmetic is one shared
// load and one integer add per (point, subspace).
// Design: one block per (q, probe). The probe's S*E int8 table is staged
// in shared memory (12 KB at S=48, 25.6 KB at S=100); each thread takes
// points at a block stride and reads a valid point's code row as 16-byte
// words (S=48) or 4-byte words (S=100), so consecutive threads read
// consecutive rows; the int32 sum needs no ordering care.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void hit_count_kernel(const int8_t* __restrict__ table,    // (Q*np, S, E)
                                 const uint8_t* __restrict__ codes,   // (n_cl, P, S)
                                 const uint8_t* __restrict__ valid,   // (n_cl, P)
                                 const int64_t* __restrict__ cids,    // (Q*np)
                                 const uint8_t* __restrict__ probe_ok,  // (Q*np) or null
                                 int32_t* __restrict__ out,           // (Q*np, P)
                                 int P, int S, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int8_t* tab = reinterpret_cast<const int8_t*>(smem);
  const int64_t qp = blockIdx.x;
  int32_t* orow = out + qp * P;
  if (!scan::probe_kept(probe_ok, qp)) {   // block-uniform: the whole block leaves
    for (int p = threadIdx.x; p < P; p += blockDim.x) orow[p] = scan::kNeg;
    return;
  }
  scan::stage(smem, table + qp * S * E, S * E);
  __syncthreads();

  const int64_t cid = cids[qp];
  const uint8_t* crow = codes + cid * (int64_t)P * S;
  const uint8_t* vrow = valid + cid * (int64_t)P;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    orow[p] = vrow[p] ? scan::gather_sum<int>(tab, crow + (int64_t)p * S, S, E) : scan::kNeg;
}

}  // namespace

// table: (Q, np, S, E) int8; codes: (n_cl, P, S) uint8; valid: (n_cl, P)
// bool; cids: (Q, np) int64 cluster ids; probe_ok: (Q, np) bool or null;
// out: (Q, np, P) int32, written.
extern "C" int hit_count_launch(const void* table, const void* codes,
                                const void* valid, const void* cids,
                                const void* probe_ok, void* out,
                                int Q, int n_probe, int P, int S, int E,
                                void* stream) {
  const size_t smem = (size_t)S * E;
  const int err = scan::allow_smem(hit_count_kernel, smem);
  if (err) return err;
  hit_count_kernel<<<(unsigned)(Q * n_probe), kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)table, (const uint8_t*)codes, (const uint8_t*)valid,
      (const int64_t*)cids, (const uint8_t*)probe_ok, (int32_t*)out, P, S, E);
  return (int)cudaGetLastError();
}
