// IVF filter for Hopper (sm_90a): stage A's (Q, C) score matrix of every
// query against every centroid.
//
// Replaces: src/repro/kernels/ivf_filter.py:ivf_filter (_filter_kernel_l2,
// _filter_kernel_ip). Contract (src/repro/kernels/ref.py:ivf_filter_ref):
//   l2: out[q, c] = csq[c] - 2 * sum_d x[q, d] * y[c, d]   (|q|^2 left out)
//   ip: out[q, c] = sum_d x[q, d] * y[c, d]
// The sum runs d ascending in full f32, one fused multiply-add a term (no
// TF32: three digits would flip probes the reference keeps). 2 * acc is
// exact, so the l2 epilogue rounds once, as the plain version's
// csq - 2 * (x @ y^T) does; the two differ only by the product's order of
// summation, within ~D ulps of sum_d |x_d y_d|.
//
// What bounds it: operations. At the search's shape (Q = 128, C = 1024,
// D = 96 or 200) it is 25-52 MFLOP, 0.38 / 0.78 us at the card's f32 rate
// (67 TFLOP/s), against 0.29 / 0.57 us for its bytes; at an insert batch
// (Q = 1000) 197 MFLOP, 2.9 us. At these shapes it is launch-bound: one
// cuBLAS addmm of the same matrix takes 11-13 us on the H100 (PERF.md), so
// the design keeps the card full rather than fast per block.
// Design: one block per 32 x 32 output tile, so Q = 128, C = 1024 gives 128
// blocks on the 132 SMs (a 64 x 64 tile would give 32). 256 threads: each
// thread owns one centroid column and four query rows of the tile. The
// block walks D in chunks of 32 staged in shared memory (rows padded to 33
// floats, so a warp reading 32 centroid rows at one d hits 32 banks; the
// query row is a broadcast). Ragged edges of Q, C and D load zeros and are
// not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;             // output rows and columns a block
constexpr int kRowsPerThread = 4;     // kTile / (threads / kTile)
constexpr int kThreads = kTile * kTile / kRowsPerThread;

template <bool kL2>
__global__ void __launch_bounds__(kThreads)
ivf_filter_kernel(const float* __restrict__ x,    // (Q, D) queries
                  const float* __restrict__ y,    // (C, D) centroids
                  const float* __restrict__ csq,  // (C,)
                  float* __restrict__ out,        // (Q, C)
                  int Q, int C, int D) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ys[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile;   // column in the tile
  const int ty = threadIdx.x / kTile;   // first of this thread's rows
  const int q0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};

  for (int d0 = 0; d0 < D; d0 += kTile) {
    // each thread stages four elements of each tile, row by row, with
    // neighbouring threads on neighbouring d (coalesced reads)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = ty + r * (kThreads / kTile), d = d0 + tx;
      const int qi = q0 + row, ci = c0 + row;
      xs[row][tx] = (qi < Q && d < D) ? x[(int64_t)qi * D + d] : 0.f;
      ys[row][tx] = (ci < C && d < D) ? y[(int64_t)ci * D + d] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kTile, D - d0);
    for (int k = 0; k < kmax; ++k) {
      const float yv = ys[tx][k];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(xs[ty + r * (kThreads / kTile)][k], yv, acc[r]);
    }
    __syncthreads();
  }

  const int ci = c0 + tx;
  if (ci >= C) return;
  const float base = kL2 ? csq[ci] : 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int qi = q0 + ty + r * (kThreads / kTile);
    if (qi < Q)
      out[(int64_t)qi * C + ci] = kL2 ? __fsub_rn(base, __fmul_rn(2.f, acc[r])) : acc[r];
  }
}

}  // namespace

// x: (Q, D) f32; y: (C, D) f32; csq: (C,) f32 (read for l2 only); out:
// (Q, C) f32, written. l2 != 0 selects the l2 epilogue.
extern "C" int ivf_filter_launch(const void* x, const void* y, const void* csq,
                                 void* out, int Q, int C, int D, int l2,
                                 void* stream) {
  if (Q == 0 || C == 0) return 0;
  const dim3 grid((unsigned)((C + kTile - 1) / kTile),
                  (unsigned)((Q + kTile - 1) / kTile));
  cudaStream_t st = (cudaStream_t)stream;
  if (l2)
    ivf_filter_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)y, (const float*)csq, (float*)out, Q, C, D);
  else
    ivf_filter_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)y, (const float*)csq, (float*)out, Q, C, D);
  return (int)cudaGetLastError();
}
