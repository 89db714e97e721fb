// Selective LUT construction for Hopper (sm_90a): the masked LUT and the
// int8 hit table of stage B, in one pass over the codebook.
//
// Replaces: src/repro/kernels/selective_lut.py:selective_lut (_kernel_l2,
// _kernel_ip), plus the ip post-pass of src/repro/kernels/ops.py:110-117
// (core/lut.py:ip_pruned_fill), which is fused in here.
//
// Contract (src/repro/kernels/ref.py:selective_lut_ref), per row b of the
// batch B = Q*nprobe, subspace s and entry e:
//   dot  = q0*e0 + q1*e1
//   l2:  dist = (q0*q0 + q1*q1 - 2*dot) + esq     ip: dist = esq - 2*dot
//   outer = dist <= tau^2, inner = dist <= tau^2/4
//   hit = +1 inner, 0 ring, -1 miss
//   lut (l2) = outer ? dist : tau^2
//   lut (ip) = outer ? dot : min of the row's kept dot (0 when none kept)
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn), in
// the reference's order: a contracted multiply-add would move dist by an
// ulp and flip the tau^2 compares, and the hit table would then no longer
// equal the plain version's.
//
// What bounds it: the writes, 5 bytes per (b, s, e) — 126 MB at
// B=2048, S=48, E=256, about 38 us at 3.35 TB/s. The inputs are tiny
// (q0/q1/tau are B*S floats, the codebook S*E*3 floats and stays in L2).
// Design: one block per (b, s) row, one thread per entry, so each row's
// E floats and E bytes are written by consecutive threads in one
// coalesced store each. The ip row-min is a warp-shuffle reduction plus
// one shared-memory pass across the block's warps, which is what lets
// this kernel do in one pass what the TPU kernel left to a second one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float block_min(float v, float* scratch) {
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const unsigned nwarps = (blockDim.x + 31u) >> 5;
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : INFINITY;
    for (int o = 16; o > 0; o >>= 1) w = fminf(w, __shfl_xor_sync(0xffffffffu, w, o));
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

template <bool IP>
__global__ void selective_lut_kernel(const float* __restrict__ q0,
                                     const float* __restrict__ q1,
                                     const float* __restrict__ e0,
                                     const float* __restrict__ e1,
                                     const float* __restrict__ esq,
                                     const float* __restrict__ tau,
                                     float* __restrict__ lut,
                                     int8_t* __restrict__ hit, int S, int E) {
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;  // b * S + s
  const int s = (int)(row % S);
  const int e = threadIdx.x;
  const float a0 = q0[row], a1 = q1[row], t = tau[row];
  const float tau_sq = __fmul_rn(t, t);
  const float inner_sq = __fmul_rn(0.25f, tau_sq);
  bool outer = false, inner = false;
  float dot = 0.f, val = 0.f;
  if (e < E) {
    const int k = s * E + e;
    dot = __fadd_rn(__fmul_rn(a0, e0[k]), __fmul_rn(a1, e1[k]));
    float dist;
    if (IP) {
      dist = __fsub_rn(esq[k], __fmul_rn(2.f, dot));
    } else {
      const float r_sq = __fadd_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1));
      dist = __fadd_rn(__fsub_rn(r_sq, __fmul_rn(2.f, dot)), esq[k]);
    }
    outer = dist <= tau_sq;
    inner = dist <= inner_sq;
    val = IP ? dot : (outer ? dist : tau_sq);
  }
  if (IP) {  // block-uniform branch: every thread reaches the barriers
    float m = block_min((e < E && outer) ? dot : INFINITY, scratch);
    if (!isfinite(m)) m = 0.f;
    if (!outer) val = m;
  }
  if (e < E) {
    lut[row * E + e] = val;
    hit[row * E + e] = (int8_t)((inner ? 1 : 0) - (outer ? 0 : 1));
  }
}

}  // namespace

// q0, q1, tau: (B, S) f32; e0, e1, esq: (S, E) f32;
// lut: (B, S, E) f32 and hit: (B, S, E) int8, written.
extern "C" int selective_lut_launch(const void* q0, const void* q1,
                                    const void* e0, const void* e1,
                                    const void* esq, const void* tau,
                                    void* lut, void* hit, long long B, int S,
                                    int E, int ip, void* stream) {
  const int threads = ((E + 31) / 32) * 32;
  const unsigned rows = (unsigned)(B * S);
  cudaStream_t st = (cudaStream_t)stream;
  if (ip) {
    selective_lut_kernel<true><<<rows, threads, 0, st>>>(
        (const float*)q0, (const float*)q1, (const float*)e0, (const float*)e1,
        (const float*)esq, (const float*)tau, (float*)lut, (int8_t*)hit, S, E);
  } else {
    selective_lut_kernel<false><<<rows, threads, 0, st>>>(
        (const float*)q0, (const float*)q1, (const float*)e0, (const float*)e1,
        (const float*)esq, (const float*)tau, (float*)lut, (int8_t*)hit, S, E);
  }
  return (int)cudaGetLastError();
}
