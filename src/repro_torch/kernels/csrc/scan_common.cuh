// Device code shared by the per-point table scans (hit_count.cu,
// pq_scan.cu, two_stage.cuh): staging one probe's table in shared memory,
// summing one point's S table entries through its code bytes, and the RT
// prefilter's per-probe mask.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kNeg = -(1 << 30);       // invalid-point count sentinel

// Whether probe qp (= q * np + probe) is scanned: every probe when
// probe_ok is null, else probe_ok[qp] (the RT prefilter's (Q, np) bool
// verdict). A pruned probe's points score as invalid slots, as the
// reference's `valid & probe_ok[..., None]` makes them.
__device__ __forceinline__ bool probe_kept(const uint8_t* __restrict__ probe_ok, int64_t qp) {
  return probe_ok == nullptr || probe_ok[qp] != 0;
}

// Copy n_bytes from global src to shared dst with the whole block, in
// 16-byte words when the size and the source allow it. The caller
// synchronises the block afterwards.
__device__ __forceinline__ void stage(void* dst, const void* src, int n_bytes) {
  if ((n_bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s4 = static_cast<const int4*>(src);
    int4* d4 = static_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n_bytes / 16; i += blockDim.x) d4[i] = __ldg(s4 + i);
  } else {
    const unsigned char* s = static_cast<const unsigned char*>(src);
    unsigned char* d = static_cast<unsigned char*>(dst);
    for (int i = threadIdx.x; i < n_bytes; i += blockDim.x) d[i] = s[i];
  }
}

// acc + tab[j*E + byte j of w] for j = 0..3, added in that order.
template <typename Acc, typename T>
__device__ __forceinline__ Acc add_word(Acc acc, const T* tab, uint32_t w, int E) {
  acc += static_cast<Acc>(tab[w & 255u]);
  acc += static_cast<Acc>(tab[E + ((w >> 8) & 255u)]);
  acc += static_cast<Acc>(tab[2 * E + ((w >> 16) & 255u)]);
  acc += static_cast<Acc>(tab[3 * E + (w >> 24)]);
  return acc;
}

// sum_s tab[s*E + c[s]], s ascending: for f32 one rounding per add, in
// subspace order (no fast-math, and a sum of loads has nothing to
// contract). The S code bytes are read as 16-byte words when the row is
// 16-byte aligned (S = 48: three loads), as 4-byte words when it is 4-byte
// aligned (S = 100: 25 loads), else byte by byte.
template <typename Acc, typename T>
__device__ __forceinline__ Acc gather_sum(const T* tab, const uint8_t* __restrict__ c,
                                          int S, int E) {
  Acc acc = 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(c);
  if ((S & 15) == 0 && (addr & 15) == 0) {
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
    for (int w = 0; w < S / 16; ++w) {
      const uint4 v = __ldg(c4 + w);
      const T* t = tab + 16 * w * E;
      acc = add_word(acc, t, v.x, E);
      acc = add_word(acc, t + 4 * E, v.y, E);
      acc = add_word(acc, t + 8 * E, v.z, E);
      acc = add_word(acc, t + 12 * E, v.w, E);
    }
  } else if ((S & 3) == 0 && (addr & 3) == 0) {
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(c);
    for (int w = 0; w < S / 4; ++w) acc = add_word(acc, tab + 4 * w * E, __ldg(cw + w), E);
  } else {
    for (int s = 0; s < S; ++s) acc += static_cast<Acc>(tab[s * E + __ldg(c + s)]);
  }
  return acc;
}

// Let a kernel take `bytes` of dynamic shared memory: from 48 KB on, a
// launch needs this opt-in (the H100 gives a block up to 227 KB). Returns
// the CUDA error code.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes < 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace scan
