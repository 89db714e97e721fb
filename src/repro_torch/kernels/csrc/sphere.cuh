// The RT prefilter's disc-vs-disc test, shared by sphere_hits.cu and
// fused_three_stage.cu. Query disc (q0, q1, r) and cluster disc
// (c0, c1, reach) in the ray plane intersect iff
//   thr = r + reach >= 0  and  |q - c|^2 <= thr^2.
// A pad slot carries reach = -inf, so thr = -inf and it never hits.
//
// Rounding is the reference oracle's (src/repro/kernels/ref.py:
// rt_sphere_hits_ref) as its CPU backend compiles it: the squared distance
// is fma(dx, dx, dy*dy), one rounding for the last add; every other step
// rounds on its own. The __*_rn intrinsics keep nvcc from contracting
// anything else into an FMA.
#pragma once
#include <cuda_runtime.h>

namespace rt {

__device__ __forceinline__ bool sphere_hit(float q0, float q1, float r, float c0,
                                           float c1, float reach) {
  const float dx = __fsub_rn(q0, c0);
  const float dy = __fsub_rn(q1, c1);
  const float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  const float thr = __fadd_rn(r, reach);
  return thr >= 0.0f && d2 <= __fmul_rn(thr, thr);
}

}  // namespace rt
