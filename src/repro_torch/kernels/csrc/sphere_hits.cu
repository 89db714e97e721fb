// RT sphere-intersection filter for Hopper (sm_90a): whether a query disc
// touches a cluster disc in the ray plane. Two entries, one test
// (sphere.cuh's rt::sphere_hit):
//
// * sphere_probe_launch, the main path's (the rt search's probe mask):
//   for every query q and probe p, the verdict at the probed cluster's slot
//   slot_of[cids[q, p]] only, with the query radius computed in the same
//   launch from the probe-0 row of tau, written beside the verdicts with
//   the probed slots (the three-stage scan reads both);
// * sphere_hits_launch, the reference's dense contract: every query
//   against every slot of the grid.
//
// Replaces: src/repro/rt/intersect.py:sphere_hits (_sphere_kernel) and,
// on the search path, the composition around it in
// src/repro/core/juno.py:_rt_probe_mask (query_radius, the dense table,
// the gathers at slot_of and cids, probe 0 forced True).
//
// Dense contract (src/repro/kernels/ref.py:rt_sphere_hits_ref), per query q
// and flat slot j = cell * cap + s:
//   out[q, j] = (thr >= 0) & (|qp - cp_j|^2 <= thr^2),  thr = R_q + reach_j
// as int8, cell-major (Q, n_cells*cap); pad slots carry reach = -inf and
// never hit. The rounding is sphere.cuh's, so the output equals the dense
// oracle bit for bit, and the probe entry's verdicts equal the dense table
// gathered at slot_of[cids].
//
// The probe entry's radius (kernels/ref.py:rt_query_radius_ref):
//   R_q = scale * radius_scale * sqrt(f32(sum_s tau[q, s]^2)) + radius_bias
// with the squares and their sum in f64 in s order, rounded once to f32,
// and every later step rounded in f32 on its own (the __*_rn intrinsics keep
// nvcc from contracting anything). A sum in f32 would depend on the
// reduction order; in f64 of exact f32 squares, rounded once, it matches
// the plain version bit for bit.
//
// The TPU kernel skips a cell's slot tests when no query disc touches the
// cell's box. That skip is left out of the dense entry: the full table must
// be written either way, so it saves no bytes, and the test is a handful of
// flops a slot. The probe entry needs no boxes: it tests only np slots a
// query.
//
// What bounds them. Dense: at the main path's shape (Q = 128 queries, 256
// cells, cap 88-176) the output is 3-6 MB, a microsecond or two of memory
// time. Probe: a few tens of KB (Q*np cids, slots and plane reads, Q*S of
// tau), tens of nanoseconds, so its time is the launch's.
// Design. Dense: one thread per four consecutive slots of one query (one
// 32-bit store of four int8 verdicts), when n_cells*cap is a multiple of 4
// (the build pads cap to 8); otherwise one thread per slot. Probe: one warp
// per query, lane i testing probes i, i + 32, ... Its time is a chain of
// dependent steps (the cid, then its slot, then the planes; the tau row,
// then S float64 adds), so each lane loads its first probe's operands
// before the sum, and the tau row comes in one coalesced round (at most
// 128 values; more in further rounds) and is summed in s order from the
// lanes' registers by shuffles, so every lane has the radius.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sphere.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kProbeWarps = 4;   // queries a block of the probe entry
constexpr int kTauRegs = 4;      // tau values a lane holds: S <= 128 in one round

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

template <typename Cid>
__global__ void __launch_bounds__(32 * kProbeWarps)
sphere_probe_kernel(const float* __restrict__ q0, const float* __restrict__ q1,
                    long long q0_stride, long long q1_stride,
                    const float* __restrict__ tau, long long tau_q_stride,
                    long long tau_s_stride, float scale,
                    const float* __restrict__ radius_scale,
                    const float* __restrict__ radius_bias,
                    const float* __restrict__ c0, const float* __restrict__ c1,
                    const float* __restrict__ reach,
                    const int32_t* __restrict__ slot_of,
                    const Cid* __restrict__ cids, long long cid_stride,
                    bool* __restrict__ probe_ok, float* __restrict__ radius_out,
                    int32_t* __restrict__ slot_out, int Q, int n_probe, int S) {
  const int q = blockIdx.x * kProbeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // whole warps: every lane below takes part in the shuffles
  const float a = q0[q * q0_stride], b = q1[q * q1_stride];
  // the lane's first probe: its slot and planes load while the radius sums
  const Cid* row = cids + q * cid_stride;
  int32_t j = 0;
  float pc0 = 0.f, pc1 = 0.f, prc = 0.f;
  if (lane < n_probe) {
    j = slot_of[row[lane]];
    pc0 = c0[j], pc1 = c1[j], prc = reach[j];
  }
  // the radius: the tau row loaded coalesced (kTauRegs * 32 values in one
  // round), then summed in s order from the lanes' registers by shuffles
  const float* t = tau + q * tau_q_stride;
  float mine[kTauRegs];
#pragma unroll
  for (int c = 0; c < kTauRegs; ++c) {
    const int s = c * 32 + lane;
    mine[c] = s < S ? t[s * tau_s_stride] : 0.f;
  }
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < kTauRegs; ++c)
    for (int k = 0; k < min(32, S - c * 32); ++k) {
      const double v = (double)__shfl_sync(0xffffffffu, mine[c], k);
      acc = __dadd_rn(acc, __dmul_rn(v, v));
    }
  for (int base = kTauRegs * 32; base < S; base += 32) {
    const float m = base + lane < S ? t[(base + lane) * tau_s_stride] : 0.f;
    for (int k = 0; k < min(32, S - base); ++k) {
      const double v = (double)__shfl_sync(0xffffffffu, m, k);
      acc = __dadd_rn(acc, __dmul_rn(v, v));
    }
  }
  const float r = __fadd_rn(
      __fmul_rn(__fmul_rn(scale, *radius_scale), __fsqrt_rn(__double2float_rn(acc))),
      *radius_bias);
  if (lane == 0) radius_out[q] = r;
  const int64_t out = (int64_t)q * n_probe;
  for (int p = lane; p < n_probe; p += 32) {
    if (p != lane) {
      j = slot_of[row[p]];
      pc0 = c0[j], pc1 = c1[j], prc = reach[j];
    }
    probe_ok[out + p] = p == 0 || rt::sphere_hit(a, b, r, pc0, pc1, prc);
    slot_out[out + p] = j;
  }
}

// The launch floor: no work, the probe entry's grid and block.
__global__ void __launch_bounds__(32 * kProbeWarps) sphere_floor_kernel() {}

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

// q0, q1: (Q,) f32 ray-plane queries read at element strides q0_stride and
// q1_stride (the columns of the search's (Q, 2) projection, read in place);
// tau: the (Q, S) f32 probe-0 row of the search's thresholds, read at
// element strides tau_q_stride and tau_s_stride; radius_scale, radius_bias:
// () f32 on the card (the grid's); c0, c1, reach: (n_cells*cap,) f32 slot
// planes; slot_of: (C,) int32; cids: (Q, np) int64 (cids_64 != 0) or int32,
// rows cid_stride elements apart, every id in [0, C); probe_ok: (Q, np)
// bool, radius: (Q,) f32 and slot: (Q, np) int32 (slot_of[cids]), written
// (probe 0 True).
extern "C" int sphere_probe_launch(const void* q0, const void* q1,
                                   long long q0_stride, long long q1_stride,
                                   const void* tau, long long tau_q_stride,
                                   long long tau_s_stride, float scale,
                                   const void* radius_scale,
                                   const void* radius_bias, const void* c0,
                                   const void* c1, const void* reach,
                                   const void* slot_of, const void* cids,
                                   long long cid_stride, int cids_64,
                                   void* probe_ok, void* radius, void* slot,
                                   int Q, int n_probe, int S, void* stream) {
  if (Q == 0 || n_probe == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((Q + kProbeWarps - 1) / kProbeWarps);
#define SPHERE_PROBE_ARGS(T)                                                  \
  (const float*)q0, (const float*)q1, q0_stride, q1_stride, (const float*)tau, \
      tau_q_stride, tau_s_stride, scale, (const float*)radius_scale,          \
      (const float*)radius_bias, (const float*)c0, (const float*)c1,          \
      (const float*)reach, (const int32_t*)slot_of, (const T*)cids,           \
      cid_stride, (bool*)probe_ok, (float*)radius, (int32_t*)slot, Q, n_probe, S
  if (cids_64)
    sphere_probe_kernel<int64_t><<<blocks, 32 * kProbeWarps, 0, st>>>(
        SPHERE_PROBE_ARGS(int64_t));
  else
    sphere_probe_kernel<int32_t><<<blocks, 32 * kProbeWarps, 0, st>>>(
        SPHERE_PROBE_ARGS(int32_t));
#undef SPHERE_PROBE_ARGS
  return (int)cudaGetLastError();
}

// An empty kernel on the probe entry's grid for Q queries: the launch
// floor its time is read against.
extern "C" int sphere_floor_launch(int Q, void* stream) {
  if (Q == 0) return 0;
  const unsigned blocks = (unsigned)((Q + kProbeWarps - 1) / kProbeWarps);
  sphere_floor_kernel<<<blocks, 32 * kProbeWarps, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
