// Selective LUT construction for Hopper (sm_90a): the masked LUT and the
// int8 hit table of stage B, in one pass over the codebook.
//
// Replaces: src/repro/kernels/selective_lut.py:selective_lut (_kernel_l2,
// _kernel_ip), plus the ip post-pass of src/repro/kernels/ops.py:110-117
// (core/lut.py:ip_pruned_fill), which is fused in here.
//
// Contract (src/repro/kernels/ref.py:selective_lut_ref), per row b of the
// batch B = Q*NP, subspace s and entry e:
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
// What bounds it: the writes, 5 bytes per (b, s, e), plus the inputs (q0,
// q1, tau: 3 floats a row; the codebook: 3 floats a (s, e)). At B = 2048,
// S = 48, E = 256 that is 126 MB, about 38 us at 3.35 TB/s; one fill_ of
// the same bytes (chip_smoke.py's write floor) takes 42.8 us by CUDA
// events, about 4 of them the events' own, on an H100 80GB HBM3 at 700 W.
// The kernel before this design (one block a (b, s) row, one thread an
// entry) took 2.6-3.3x the bound on that card: every block read its
// codebook row from L2 (3 KB to write 1.25 KB), wrote one float and one
// byte a thread, ran the ip row-min as a block reduction with two
// barriers, and the wrapper copied four strided inputs first (five
// launches a stage B).
// Design:
// - A warp owns one subspace s and walks a run of rows b. It loads its
//   codebook row e0/e1/esq once, into registers: V = E/32 entries a lane,
//   rounded up to a power of two (a template parameter; 24 registers at
//   E = 256), with 16-byte loads where the codebook lies as planes or as
//   (S, E, 2) pairs. The codebook is then read about once a warp, not once
//   a (b, s) row.
// - Runs: each subspace's rows are cut into as many runs as one wave of
//   resident warps holds (the launcher asks the occupancy API), and no
//   more: a second wave of a few blocks would run alone after the first.
//   A launch smaller than a wave of 8-warp blocks takes smaller blocks, so
//   that it spreads over every SM.
// - One warp writes one row. A lane's entries are groups of W = min(V, 4)
//   consecutive entries, group k at k*32*W + lane*W, so each store
//   instruction of the warp covers one contiguous span: the LUT as float4
//   (float2, float) stores, the hit table as 4-byte (2-, 1-byte) words.
//   When E is not 32*V the last lanes are masked and every store is
//   scalar (the same kernel, the FULL template parameter).
// - Row scalars: lane l loads q0, q1 and tau of row r0 + l through their
//   (Q, NP, S) strides (a probe stride of 0 reads the expanded ip view in
//   place), squares tau, and the warp broadcasts them one row at a time by
//   shuffles. e0 and e1 are read through their (S, E) strides, so views of
//   entries (S, E, 2) need no copy: a stage B is this one launch.
// - The ip row-min is a min over the lane's V kept dots and five
//   xor-shuffles: no shared memory, no barrier.
// What it does not win: a launch of one row a warp (B*S below a wave,
// e.g. B = 16, S = 48) keeps the codebook for one row only, and a warp's
// 8 entries a lane run in series where the old kernel ran one a thread;
// there it is about as fast as the old kernel, launch-bound either way.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr unsigned kAll = 0xffffffffu;

// Strides of the inputs, in elements: q0, q1, tau over (Q, NP, S); e0, e1,
// esq over (S, E).
struct Strides {
  long long q0[3], q1[3], tau[3], e0[2], e1[2], esq[2];
};

// How the codebook lies, for its vector loads (bits of `layout`): e0 and
// e1 as planes of stride 1, or as the two halves of (S, E, 2) pairs (e1 =
// e0 + 1, stride 2); esq as a plane of stride 1. Each with rows 16-byte
// aligned. Otherwise the codebook is read one float at a time.
constexpr int kPlanes = 1, kPairs = 2, kEsqPlane = 4;

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  }
}

// W entries of interleaved (e0, e1) pairs from p (16-byte aligned)
template <int W>
__device__ __forceinline__ void load_pairs(const float* p, float* v0,
                                           float* v1) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    v0[2 * i] = a.x, v1[2 * i] = a.y, v0[2 * i + 1] = a.z, v1[2 * i + 1] = a.w;
  }
}

template <int W>
__device__ __forceinline__ void store_group(float* lut, int8_t* hit,
                                            const float* v, const int* h) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(lut) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint32_t*>(hit) =
        (uint32_t)(uint8_t)h[0] | (uint32_t)(uint8_t)h[1] << 8 |
        (uint32_t)(uint8_t)h[2] << 16 | (uint32_t)(uint8_t)h[3] << 24;
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(lut) = make_float2(v[0], v[1]);
    *reinterpret_cast<uint16_t*>(hit) =
        (uint16_t)((uint32_t)(uint8_t)h[0] | (uint32_t)(uint8_t)h[1] << 8);
  } else {
    *lut = v[0];
    *hit = (int8_t)h[0];
  }
}

// V = W*G entries a lane; FULL: E == 32*V (no lane masked, vector stores).
template <int W, int G, bool IP, bool FULL>
__global__ void __launch_bounds__(32 * kWarps)
selective_lut_kernel(const float* __restrict__ q0, const float* __restrict__ q1,
                     const float* __restrict__ e0, const float* __restrict__ e1,
                     const float* __restrict__ esq,
                     const float* __restrict__ tau, float* __restrict__ lut,
                     int8_t* __restrict__ hit, const Strides st, int layout,
                     int NP, int B, int S, int E, int rows_per_warp,
                     int n_warps) {
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;  // warp-uniform; the kernel has no barrier
  const int lane = threadIdx.x & 31;
  const int s = warp % S;
  const int b0 = warp / S * rows_per_warp;
  const int b1 = min(b0 + rows_per_warp, B);

  // the warp's codebook row; masked entries hold 0 and are never kept
  float c0[G][W], c1[G][W], cs[G][W];
  bool in[G][W];
  const float* row0 = e0 + s * st.e0[0];
  const float* row1 = e1 + s * st.e1[0];
  const float* rows = esq + s * st.esq[0];
  constexpr bool vec = FULL && W > 1;  // whole groups, vector loads possible
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int e = k * 32 * W + lane * W;
#pragma unroll
    for (int j = 0; j < W; ++j) in[k][j] = FULL || e + j < E;
    if constexpr (vec) {
      if (layout & kPlanes) {
        load_vec<W>(row0 + e, c0[k]);
        load_vec<W>(row1 + e, c1[k]);
      } else if (layout & kPairs) {
        load_pairs<W>(row0 + 2 * e, c0[k], c1[k]);
      }
      if (layout & kEsqPlane) load_vec<W>(rows + e, cs[k]);
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (!vec || !(layout & (kPlanes | kPairs))) {
        c0[k][j] = in[k][j] ? row0[(e + j) * st.e0[1]] : 0.f;
        c1[k][j] = in[k][j] ? row1[(e + j) * st.e1[1]] : 0.f;
      }
      if (!vec || !(layout & kEsqPlane))
        cs[k][j] = in[k][j] ? rows[(e + j) * st.esq[1]] : 0.f;
    }
  }

  for (int r0 = b0; r0 < b1; r0 += 32) {
    // lane l stages the scalars of row r0 + l
    float a0 = 0.f, a1 = 0.f, tsq = 0.f, rsq = 0.f;
    if (r0 + lane < b1) {
      const int b = r0 + lane, qi = b / NP, pi = b - qi * NP;
      a0 = q0[qi * st.q0[0] + pi * st.q0[1] + s * st.q0[2]];
      a1 = q1[qi * st.q1[0] + pi * st.q1[1] + s * st.q1[2]];
      const float t = tau[qi * st.tau[0] + pi * st.tau[1] + s * st.tau[2]];
      tsq = __fmul_rn(t, t);
      if (!IP) rsq = __fadd_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1));
    }
    const int n = min(32, b1 - r0);
    for (int i = 0; i < n; ++i) {
      const float x0 = __shfl_sync(kAll, a0, i);
      const float x1 = __shfl_sync(kAll, a1, i);
      const float tau_sq = __shfl_sync(kAll, tsq, i);
      const float inner_sq = __fmul_rn(0.25f, tau_sq);
      const float r_sq = IP ? 0.f : __shfl_sync(kAll, rsq, i);
      float val[G][W];
      int h[G][W];
      bool outer[G][W];
      float m = INFINITY;
#pragma unroll
      for (int k = 0; k < G; ++k)
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float dot = __fadd_rn(__fmul_rn(x0, c0[k][j]),
                                      __fmul_rn(x1, c1[k][j]));
          const float dist =
              IP ? __fsub_rn(cs[k][j], __fmul_rn(2.f, dot))
                 : __fadd_rn(__fsub_rn(r_sq, __fmul_rn(2.f, dot)), cs[k][j]);
          outer[k][j] = dist <= tau_sq;
          h[k][j] = (dist <= inner_sq ? 1 : 0) - (outer[k][j] ? 0 : 1);
          val[k][j] = IP ? dot : (outer[k][j] ? dist : tau_sq);
          if (IP && outer[k][j] && in[k][j]) m = fminf(m, dot);
        }
      if (IP) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kAll, m, o));
        if (!isfinite(m)) m = 0.f;
#pragma unroll
        for (int k = 0; k < G; ++k)
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (!outer[k][j]) val[k][j] = m;
      }
      const long long row = (long long)(r0 + i) * S + s;
      float* lrow = lut + row * E;
      int8_t* hrow = hit + row * E;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int e = k * 32 * W + lane * W;
        if (FULL) {
          store_group<W>(lrow + e, hrow + e, val[k], h[k]);
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (in[k][j]) {
              lrow[e + j] = val[k][j];
              hrow[e + j] = (int8_t)h[k][j];
            }
        }
      }
    }
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*,
                         const float*, const float*, const float*, float*,
                         int8_t*, const Strides, int, int, int, int, int, int,
                         int);

template <int W, int G>
KernelFn pick(bool ip, bool full) {
  if (ip) return full ? selective_lut_kernel<W, G, true, true>
                      : selective_lut_kernel<W, G, true, false>;
  return full ? selective_lut_kernel<W, G, false, true>
              : selective_lut_kernel<W, G, false, false>;
}

// The kernel for E entries a row (V = E/32 rounded up to a power of two
// entries a lane) and its slot in resident_warps' cache.
KernelFn kernel_for(int E, bool ip, int* slot) {
  int v = 0;
  while ((32 << v) < E) ++v;
  const bool full = E == (32 << v);
  *slot = (v * 2 + ip) * 2 + full;
  switch (v) {
    case 0: return pick<1, 1>(ip, full);
    case 1: return pick<2, 1>(ip, full);
    case 2: return pick<4, 1>(ip, full);
    case 3: return pick<4, 2>(ip, full);
    case 4: return pick<4, 4>(ip, full);
    default: return pick<4, 8>(ip, full);
  }
}

// The card's SMs and how many blocks of kWarps warps of one kernel an SM
// holds at once. Cached per kernel and device: a race between two callers
// writes the same value twice.
void residency(KernelFn fn, int slot, int* sms, int* blocks_per_sm) {
  static int n_sm[64], n_blocks[64][24];
  int dev = 0;
  cudaGetDevice(&dev);
  dev &= 63;
  if (!n_sm[dev])
    cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount, dev);
  if (!n_blocks[dev][slot]) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, 32 * kWarps, 0);
    n_blocks[dev][slot] = n > 0 ? n : 1;
  }
  *sms = n_sm[dev] > 0 ? n_sm[dev] : 1;
  *blocks_per_sm = n_blocks[dev][slot];
}

}  // namespace

// q0, q1, tau: (Q, NP, S) f32 and e0, e1, esq: (S, E) f32, read through
// `strides` (15 element strides in Strides' order); lut: (Q*NP, S, E) f32
// and hit: (Q*NP, S, E) int8, contiguous, written. 0 < E <= 1024 and
// Q*NP*S < 2^31.
extern "C" int selective_lut_launch(const void* q0, const void* q1,
                                    const void* e0, const void* e1,
                                    const void* esq, const void* tau,
                                    void* lut, void* hit,
                                    const long long* strides, int Q, int NP,
                                    int S, int E, int ip, void* stream) {
  if (E < 1 || E > 1024) return (int)cudaErrorInvalidValue;
  const int B = Q * NP;
  if (B == 0 || S == 0) return 0;
  Strides st;
  long long* dst = &st.q0[0];
  for (int i = 0; i < 15; ++i) dst[i] = strides[i];
  const auto a16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  int layout = 0;
  if (st.e0[1] == 1 && st.e1[1] == 1 && st.e0[0] % 4 == 0 &&
      st.e1[0] % 4 == 0 && a16(e0) && a16(e1))
    layout |= kPlanes;
  else if (st.e0[1] == 2 && st.e1[1] == 2 && st.e0[0] == st.e1[0] &&
           st.e0[0] % 4 == 0 && a16(e0) &&
           (const char*)e1 == (const char*)e0 + 4)
    layout |= kPairs;
  if (st.esq[1] == 1 && st.esq[0] % 4 == 0 && a16(esq)) layout |= kEsqPlane;
  int slot;
  const KernelFn fn = kernel_for(E, ip != 0, &slot);
  // rows a warp: each subspace's rows cut into `runs` runs, as many as one
  // wave of resident warps holds (not one more: a second wave of a few
  // blocks would run alone after the first)
  int sms, blocks_per_sm;
  residency(fn, slot, &sms, &blocks_per_sm);
  const long long wave = (long long)sms * blocks_per_sm * kWarps;
  long long runs = wave / S;
  if (runs < 1) runs = 1;
  if (runs > B) runs = B;
  const int rows_per_warp = (int)((B + runs - 1) / runs);
  const int n_warps = S * ((B + rows_per_warp - 1) / rows_per_warp);
  // warps a block: kWarps, fewer when that spreads a small launch over
  // more SMs (each SM then takes as few warps as it can)
  const int per_sm = (n_warps + sms * kWarps - 1) / (sms * kWarps);
  int warps = (n_warps + sms * per_sm - 1) / (sms * per_sm);
  if (warps > kWarps) warps = kWarps;
  const unsigned blocks = (unsigned)((n_warps + warps - 1) / warps);
  fn<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const float*)q0, (const float*)q1, (const float*)e0, (const float*)e1,
      (const float*)esq, (const float*)tau, (float*)lut, (int8_t*)hit, st,
      layout, NP, B, S, E, rows_per_warp, n_warps);
  return (int)cudaGetLastError();
}
