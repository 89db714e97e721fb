// RT sphere-intersection filter for Hopper (sm_90a): for every query and
// every slot of the centroid grid, whether the query disc touches the
// cluster disc in the ray plane.
//
// Replaces: src/repro/rt/intersect.py:sphere_hits (_sphere_kernel).
// Contract (src/repro/kernels/ref.py:rt_sphere_hits_ref), per query q and
// flat slot j = cell * cap + s:
//   out[q, j] = (thr >= 0) & (|qp - cp_j|^2 <= thr^2),  thr = R_q + reach_j
// as int8, cell-major (Q, n_cells*cap); pad slots carry reach = -inf and
// never hit. The rounding is sphere.cuh's, so the output equals the dense
// oracle bit for bit.
//
// The TPU kernel skips a cell's slot tests when no query disc touches the
// cell's box. That skip is left out here: the full table must be written
// either way, so it saves no bytes, and the test is a handful of flops a
// slot. Without it the result cannot depend on how the box edges round
// against the cell assignment.
//
// What bounds it: at the main path's shape (Q = 128 queries, 256 cells,
// cap 32-64) the output is 1-2 MB and the inputs a few KB, under a
// microsecond of memory time, so the launch itself dominates.
// Design: one thread per four consecutive slots of one query (one 32-bit
// store of four int8 verdicts), when n_cells*cap is a multiple of 4 (the
// build pads cap to 8); otherwise one thread per slot.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sphere.cuh"

namespace {

constexpr int kThreads = 256;

template <int kPack>
__global__ void sphere_hits_kernel(const float* __restrict__ q0,      // (Q,)
                                   const float* __restrict__ q1,      // (Q,)
                                   const float* __restrict__ radius,  // (Q,)
                                   const float* __restrict__ c0,      // (n_slots,)
                                   const float* __restrict__ c1,
                                   const float* __restrict__ reach,
                                   int8_t* __restrict__ out,          // (Q, n_slots)
                                   int Q, int n_slots) {
  const int per_q = n_slots / kPack;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)Q * per_q) return;
  const int q = (int)(i / per_q);
  const int j0 = (int)(i % per_q) * kPack;
  const float a = q0[q], b = q1[q], r = radius[q];
  if constexpr (kPack == 4) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word |= (uint32_t)rt::sphere_hit(a, b, r, c0[j0 + k], c1[j0 + k], reach[j0 + k])
              << (8 * k);
    reinterpret_cast<uint32_t*>(out)[i] = word;
  } else {
    out[i] = (int8_t)rt::sphere_hit(a, b, r, c0[j0], c1[j0], reach[j0]);
  }
}

}  // namespace

// q0, q1, radius: (Q,) f32; c0, c1, reach: (n_cells*cap,) f32; out: (Q,
// n_cells*cap) int8, written.
extern "C" int sphere_hits_launch(const void* q0, const void* q1,
                                  const void* radius, const void* c0,
                                  const void* c1, const void* reach, void* out,
                                  int Q, int n_slots, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool packed = (n_slots & 3) == 0;
  const int64_t n = (int64_t)Q * (packed ? n_slots / 4 : n_slots);
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (packed)
    sphere_hits_kernel<4><<<blocks, kThreads, 0, st>>>(
        (const float*)q0, (const float*)q1, (const float*)radius, (const float*)c0,
        (const float*)c1, (const float*)reach, (int8_t*)out, Q, n_slots);
  else
    sphere_hits_kernel<1><<<blocks, kThreads, 0, st>>>(
        (const float*)q0, (const float*)q1, (const float*)radius, (const float*)c0,
        (const float*)c1, (const float*)reach, (int8_t*)out, Q, n_slots);
  return (int)cudaGetLastError();
}
