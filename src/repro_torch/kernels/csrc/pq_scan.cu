// Masked ADC scan for Hopper (sm_90a): the tier-H distance (l2) or
// similarity (ip) of every probed point from its probe's masked LUT.
//
// Replaces: src/repro/kernels/pq_scan.py:pq_scan (_scan_kernel), as
// src/repro/kernels/ops.py:masked_adc_scan vmaps it over (Q, np).
// Contract (src/repro/kernels/ref.py:pq_scan_ref), per query q, probe and
// slot p of the probed cluster cid = cids[q, probe]:
//   out[q, probe, p] = valid[cid, p] ? sum_s lut[q, probe, s, codes[cid, p, s]]
//                                    : bad      (+inf for l2, -inf for ip)
// and bad for every slot of a probe the RT prefilter pruned
// (probe_ok[q, probe] false; probe_ok null keeps every probe).
// with s ascending, one f32 rounding per add. The plain version sums in
// another order, so the two agree within ~S ulps of the sum of the terms'
// magnitudes.
//
// Codes are read through the probed cluster ids, as in hit_count.cu: the
// (Q, np, P, S) gathered copy the reference scans (385 MB at Q=128,
// np=16, P=3912, S=48) is never made.
//
// What bounds it: bytes. The f32 LUT is read once per probe (S*E*4 bytes:
// 48 KB at S=48, 100 KB at S=100), each probed cluster's valid row and
// its valid points' codes are read, and the f32 output written once; at
// the tier-H shape the LUT is the largest of the three, which is why the
// fused two-stage kernel reads the LUT at its candidates only.
// Design: one block per (q, probe). The LUT is staged in shared memory;
// above the default 48 KB the launch opts in to more (up to 227 KB a
// block on the H100), which at S=100 leaves room for two blocks an SM, so
// each block has 512 threads to keep enough gathers in flight. The random
// code bytes make the shared-memory gathers conflict on banks; that is
// accepted here. Each thread takes points at a block stride and reads a
// valid point's code row in 16- or 4-byte words.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void pq_scan_kernel(const float* __restrict__ lut,       // (Q*np, S, E)
                               const uint8_t* __restrict__ codes,   // (n_cl, P, S)
                               const uint8_t* __restrict__ valid,   // (n_cl, P)
                               const int64_t* __restrict__ cids,    // (Q*np)
                               const uint8_t* __restrict__ probe_ok,  // (Q*np) or null
                               float* __restrict__ out,             // (Q*np, P)
                               int P, int S, int E, float bad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* tab = reinterpret_cast<const float*>(smem);
  const int64_t qp = blockIdx.x;
  float* orow = out + qp * P;
  if (!scan::probe_kept(probe_ok, qp)) {   // block-uniform: the whole block leaves
    for (int p = threadIdx.x; p < P; p += blockDim.x) orow[p] = bad;
    return;
  }
  scan::stage(smem, lut + qp * S * E, S * E * (int)sizeof(float));
  __syncthreads();

  const int64_t cid = cids[qp];
  const uint8_t* crow = codes + cid * (int64_t)P * S;
  const uint8_t* vrow = valid + cid * (int64_t)P;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    orow[p] = vrow[p] ? scan::gather_sum<float>(tab, crow + (int64_t)p * S, S, E) : bad;
}

}  // namespace

// lut: (Q, np, S, E) f32; codes: (n_cl, P, S) uint8; valid: (n_cl, P)
// bool; cids: (Q, np) int64 cluster ids; probe_ok: (Q, np) bool or null;
// out: (Q, np, P) f32, written.
extern "C" int pq_scan_launch(const void* lut, const void* codes,
                              const void* valid, const void* cids,
                              const void* probe_ok, void* out,
                              int Q, int n_probe, int P, int S, int E,
                              float bad, void* stream) {
  const size_t smem = (size_t)S * E * sizeof(float);
  const int err = scan::allow_smem(pq_scan_kernel, smem);
  if (err) return err;
  pq_scan_kernel<<<(unsigned)(Q * n_probe), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lut, (const uint8_t*)codes, (const uint8_t*)valid,
      (const int64_t*)cids, (const uint8_t*)probe_ok, (float*)out, P, S, E, bad);
  return (int)cudaGetLastError();
}
