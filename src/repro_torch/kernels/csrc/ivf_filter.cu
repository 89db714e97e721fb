// IVF filter for Hopper (sm_90a): stage A, every query against every
// centroid, with two epilogues over one main loop.
//
// Replaces: src/repro/kernels/ivf_filter.py:ivf_filter (_filter_kernel_l2,
// _filter_kernel_ip) and, in its top-nprobe epilogue, the lax.top_k that
// src/repro/core/ivf.py:filter_clusters runs on its result. Contract
// (src/repro/kernels/ref.py:ivf_filter_ref):
//   l2: s[q, c] = csq[c] - 2 * sum_d x[q, d] * y[c, d]   (|q|^2 left out)
//   ip: s[q, c] = sum_d x[q, d] * y[c, d]
// The matrix epilogue writes s (Q, C). The top-nprobe epilogue writes each
// row's best nprobe (score, centroid) pairs in lax.top_k's order: l2
// ascending score, ip descending, equal scores by smaller centroid index;
// l2 scores come back as they are (not negated).
// The sum runs d ascending in full f32, one fused multiply-add a term (no
// TF32: three digits would flip probes the reference keeps). 2 * acc is
// exact, so the l2 epilogue rounds once, as the plain version's
// csq - 2 * (x @ y^T) does.
//
// What bounds it: operations, 2 Q C D of them. At a search batch (Q = 128,
// C = 1024, D = 96 / 200) that is 25 / 52 MFLOP, 0.38 / 0.78 us at the
// card's f32 rate (67 TFLOP/s), against 0.29 / 0.57 us for its bytes; at an
// insert batch (Q = 1000, D = 96) 197 MFLOP, 2.9 us. At these shapes the
// kernel is bound by launch and latency, not by either: a thread's share
// is a few thousand FMAs, two warps a block, one block an SM at a search
// batch, so what costs is the first global loads' latency, the dependent
// steps of the epilogue and, before this kernel took the top-nprobe in,
// the launches and the sort that followed it.
// Design:
// - Tile: 8 queries x 128 centroids a block, 64 threads (two warps). A
//   thread owns 4 queries x 4 centroids (columns lane + 32 j), so a warp
//   holds 4 whole rows of the tile. Q = 128, C = 1024 gives 16 x 8 = 128
//   blocks on the 132 SMs; Q = 1000 gives 1000.
// - Register tile: per 4 d a thread reads 4 float4 of queries (broadcasts)
//   and 4 float4 of centroids (rows padded to 36 floats, so the 8 lanes of
//   a quarter warp hit 8 disjoint bank quads) for 64 FMAs: 1/8 shared load
//   an FMA.
// - Loads overlap math: D in chunks of 32 through a 3-stage cp.async ring
//   in dynamic shared memory, one barrier a chunk; each thread's copies
//   have fixed rows and columns, so a chunk costs one address add a copy.
//   Ragged rows and d are zero-filled (a zero term leaves a sum unchanged)
//   and not written. A D that is not a multiple of 4, or a misaligned row,
//   takes 4-byte copies.
// - Top-nprobe epilogue, no sort and no second launch. Each score becomes
//   one 64-bit key (its order-preserving bits, negated first for ip, then
//   the centroid index), so the order above is the keys' and no two keys
//   tie. Each row's best K keys of the tile, sorted, go to a scratch (Q,
//   C tiles, K). For nprobe <= 32, K is nprobe rounded up to a power of two
//   (small_topk): the keys pass through shared memory so that each of a
//   row's 8 lanes holds 16 of them, sorts them in registers (a bitonic
//   network with every index known at compile time: no shuffles, no
//   dependent loads), and the 8 lanes fold their lists pairwise, three
//   rounds of shuffles: the elementwise minimum of one sorted list and
//   another read backwards is their best K as a bitonic sequence, which
//   log2 K more steps sort. Past 32, K = min(nprobe, 128) and warp_select
//   ranks the keys by counting (slower; the engine's probe counts stop at
//   32). Then __threadfence and one atomicAdd on the row tile's counter:
//   the block that arrives last folds the row tile's C tiles the same way,
//   writes scores and ids, and resets the counter to 0, so the next launch
//   finds it zeroed. The counters (one int a row tile, zeroed once when the
//   wrapper allocates them) serve PyTorch's current stream only: two
//   launches in flight at once on two streams would share them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kRows = 8;                  // queries a block
constexpr int kCols = 128;                // centroids a block
constexpr int kThreads = 64;              // two warps
constexpr int kWarpRows = 4;              // rows a warp owns
constexpr int kChunk = 32;                // d a ring stage
constexpr int kStride = kChunk + 4;       // floats a staged row
constexpr int kStages = 3;
constexpr int kStageFloats = (kRows + kCols) * kStride;
constexpr int kRingBytes = kStages * kStageFloats * 4;
constexpr u64 kPad = ~0ull;               // worse than every real key
constexpr int kKeyStride = kCols + 8;     // u64 a row of a warp's keys

__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         int bytes, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? bytes : 0;        // 0: fill with zeros
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One thread's share of staging a chunk of d into the ring: the block's 8
// query rows and 128 centroid rows are one array of 136 staged rows,
// queries first. Copy i of a thread lands in row r0 + kRowStep * i at
// column col, so a thread's rows, columns and bounds are fixed for the
// whole loop and only d0 moves.
template <bool kVec>
struct Stager {
  static constexpr int kWidth = kVec ? 4 : 1;            // floats a copy
  static constexpr int kPerRow = kChunk / kWidth;        // copies a row
  static constexpr int kRowStep = kThreads / kPerRow;
  static constexpr int kCopies = (kRows + kCols) / kRowStep;
  static constexpr int kQCopies = kRows / kRowStep;     // copies of queries
  const float* xrow;      // this thread's first query row, at its column
  const float* yrow;      // its first centroid row, at its column
  const float* safe;      // a valid address for the copies that fill zeros
  int64_t step;           // floats between two of its rows
  int soff, col, n_q, n_c;

  __device__ __forceinline__ Stager(const float* x, const float* y, int q0,
                                    int c0, int Q, int C, int D) {
    const int r0 = threadIdx.x / kPerRow;
    col = (threadIdx.x % kPerRow) * kWidth;
    xrow = x + (int64_t)(q0 + r0) * D + col;
    yrow = y + (int64_t)(c0 + r0) * D + col;
    safe = x;
    step = (int64_t)kRowStep * D;
    soff = r0 * kStride + col;
    n_q = min(kQCopies, max(0, (Q - q0 - r0 + kRowStep - 1) / kRowStep));
    n_c = min(kCopies - kQCopies, max(0, (C - c0 - r0 + kRowStep - 1) / kRowStep));
  }

  __device__ __forceinline__ void stage(float* st, int d0, int D) const {
    const bool d_ok = d0 + col < D;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool is_q = i < kQCopies;
      const int m = is_q ? i : i - kQCopies;
      const bool ok = d_ok && m < (is_q ? n_q : n_c);
      const float* src = (is_q ? xrow : yrow) + m * step + d0;
      cp_async(st + soff + i * kRowStep * kStride, ok ? src : safe,
               4 * kWidth, ok);
    }
  }
};

__device__ __forceinline__ float score_of(float acc, float csq, bool l2) {
  return l2 ? __fsub_rn(csq, __fmul_rn(2.f, acc)) : acc;
}

// The key of (score, centroid): smaller is better. -0 is taken as +0, as
// the plain version's comparisons take it.
__device__ __forceinline__ u64 key_of(float s, int c, bool l2) {
  unsigned b = __float_as_uint(__fadd_rn(l2 ? s : -s, 0.f));
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)b << 32) | (unsigned)c;
}

__device__ __forceinline__ float score_of_key(u64 k, bool l2) {
  unsigned b = (unsigned)(k >> 32);
  b = (b & 0x80000000u) ? (b ^ 0x80000000u) : ~b;
  const float s = __uint_as_float(b);
  return l2 ? s : __fadd_rn(-s, 0.f);   // scores are never -0
}

// Keys a C tile keeps of each row: nprobe rounded up to a power of two for
// nprobe <= 32 (the bitonic path), else min(nprobe, 128).
__host__ __device__ __forceinline__ int tile_keys(int nprobe) {
  if (nprobe > 32) return nprobe < kCols ? nprobe : kCols;
  int k = 1;
  while (k < nprobe) k <<= 1;
  return k;
}

// Sort a[0, L) ascending in registers: a bitonic network whose indices are
// all known at compile time.
template <int L>
__device__ __forceinline__ void sort_regs(u64 (&a)[L]) {
#pragma unroll
  for (int k = 2; k <= L; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const u64 lo = min(a[i], a[l]), hi = max(a[i], a[l]);
          const bool up = (i & k) == 0;
          a[i] = up ? lo : hi;
          a[l] = up ? hi : lo;
        }
      }
}

// a[0, L) is bitonic: sort it ascending.
template <int L>
__device__ __forceinline__ void merge_regs(u64 (&a)[L]) {
#pragma unroll
  for (int j = L >> 1; j > 0; j >>= 1)
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int l = i ^ j;
      if (l > i) {
        const u64 lo = min(a[i], a[l]);
        a[l] = max(a[i], a[l]);
        a[i] = lo;
      }
    }
}

// Each of the 8 lanes of a row holds a sorted list a[0, L); fold them
// (lane ^ X0, ..., lane ^ 4) so that every one holds the row's best L,
// sorted. Against the partner's list read backwards, the elementwise
// minimum is the two lists' best L as a bitonic sequence.
template <int L, int X0>
__device__ __forceinline__ void fold_lanes(u64 (&a)[L]) {
#pragma unroll
  for (int x = X0; x < 8; x <<= 1) {
#pragma unroll
    for (int p = 0; p < (L + 1) / 2; ++p) {      // p and L - 1 - p together
      const u64 hi = __shfl_xor_sync(0xffffffffu, a[L - 1 - p], x);
      const u64 lo = __shfl_xor_sync(0xffffffffu, a[p], x);
      a[p] = min(a[p], hi);
      a[L - 1 - p] = min(a[L - 1 - p], lo);
    }
    merge_regs<L>(a);
  }
}

// After a block's scratch writes, one atomicAdd on its row tile's counter:
// true in the block that arrives last, which then sees every block's
// writes. That block resets the counter when it is done.
__device__ __forceinline__ bool last_of_row_tile(int* counters) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(counters + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// The top-nprobe epilogue for nprobe <= KP <= 32 (KP a power of two). A
// warp's 4 rows x 128 keys lie in `keys` (row stride kKeyStride); lane
// (row, sub) = (lane / 8, lane % 8) takes columns sub + 8 m of its row,
// sorts them in registers and folds with the row's other 7 lanes. Writes
// each row's best KP of the tile to scratch; the block that arrives last
// for its row tile folds the tiles' lists the same way (lane sub takes
// tiles sub, sub + 8, ...) and writes scores and ids.
template <int KP, bool kL2>
__device__ __forceinline__ void small_topk(const u64* keys, float* out,
                                           int64_t* ids, u64* scratch,
                                           int* counters, int64_t row0, int Q,
                                           int nprobe, int lane) {
  const int n_ct = gridDim.x, row = lane >> 3, sub = lane & 7;
  const bool row_ok = row0 + row < Q;
  u64 a[KP];
  {
    u64 k16[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) k16[m] = keys[row * kKeyStride + sub + 8 * m];
    sort_regs<16>(k16);
    if constexpr (KP <= 16) {
#pragma unroll
      for (int p = 0; p < KP; ++p) a[p] = k16[p];
      fold_lanes<KP, 1>(a);
    } else {                            // two lanes' 16 make the first 32
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        a[p] = k16[p];
        a[16 + p] = __shfl_xor_sync(0xffffffffu, k16[15 - p], 1);
      }
      merge_regs<KP>(a);
      fold_lanes<KP, 2>(a);
    }
  }
  u64* mine = scratch + ((row0 + row) * n_ct + blockIdx.x) * KP;
#pragma unroll
  for (int p = 0; p < KP; ++p)
    if (p % 8 == sub && row_ok) mine[p] = a[p];

  if (!last_of_row_tile(counters)) return;
  const u64* lists = scratch + (row0 + row) * n_ct * KP;
#pragma unroll
  for (int p = 0; p < KP; ++p)
    a[p] = (row_ok && sub < n_ct) ? __ldcg(lists + sub * KP + p) : kPad;
  for (int t = sub + 8; t < n_ct; t += 8) {
#pragma unroll
    for (int p = 0; p < KP; ++p)
      if (row_ok) a[p] = min(a[p], __ldcg(lists + t * KP + KP - 1 - p));
    merge_regs<KP>(a);
  }
  fold_lanes<KP, 1>(a);
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    if (p % 8 == sub && p < nprobe && row_ok) {
      out[(row0 + row) * nprobe + p] = score_of_key(a[p], kL2);
      ids[(row0 + row) * nprobe + p] = (int64_t)(a[p] & 0xffffffffu);
    }
  }
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;
}

// For each of a warp's R rows, buf[r * stride, + n) holds n keys (kPad =
// none). Calls emit(r, rank, key) for every key of rank < K in its row
// (ranks count the real keys below; keys are distinct, so ranks are too)
// and returns in nc[r] how many keys were ranked: at least min(K, real
// keys). Overwrites buf.
template <int R, typename Emit>
__device__ __forceinline__ void warp_select(u64* buf, int stride, int n, int K,
                                            int (&nc)[R], Emit emit) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  u64 bound[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    u64 m = kPad;
    for (int f = lane; f < n; f += 32) m = min(m, buf[r * stride + f]);
    bound[r] = m;
  }
  if (K <= 32) {
    // the K-th smallest lane minimum: K real keys lie at or below it, so
    // the K best do too. Bitonic sort of the 32 minima, rows interleaved.
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const u64 o = __shfl_xor_sync(0xffffffffu, bound[r], j);
          bound[r] = keep_min ? min(bound[r], o) : max(bound[r], o);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      bound[r] = __shfl_sync(0xffffffffu, bound[r], K - 1);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) bound[r] = kPad;
  }
  // compact the keys within the bound to the front of the row, in place:
  // a key moves to a place at or before its own, which every lane has read
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int base = 0;
    for (int f0 = 0; f0 < n; f0 += 32) {
      const int f = f0 + lane;
      const u64 e = f < n ? buf[r * stride + f] : kPad;
      const bool keep = e != kPad && e <= bound[r];
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      __syncwarp();
      if (keep) buf[r * stride + base + __popc(bal & below)] = e;
      base += __popc(bal);
    }
    nc[r] = base;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const u64* row = buf + r * stride;
    for (int p = lane; p < nc[r]; p += 32) {
      const u64 e = row[p];
      int rank = 0;
      for (int q = 0; q < nc[r]; ++q) rank += row[q] < e;
      if (rank < K) emit(r, rank, e);
    }
  }
}

template <bool kL2, bool kVec, bool kTopk>
__global__ void __launch_bounds__(kThreads)
ivf_filter_kernel(const float* __restrict__ x,    // (Q, D) queries
                  const float* __restrict__ y,    // (C, D) centroids
                  const float* __restrict__ csq,  // (C,)
                  float* __restrict__ out,        // matrix: (Q, C); top: (Q, nprobe)
                  int64_t* __restrict__ ids,      // top: (Q, nprobe)
                  u64* __restrict__ scratch,      // top: (Q, C tiles, K)
                  int* __restrict__ counters,     // top: one a row tile
                  int Q, int C, int D, int nprobe) {
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x & 31;      // columns tx + 32 j of the tile
  const int ty = threadIdx.x >> 5;      // rows 4 ty .. 4 ty + 3 of the tile
  const int q0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  float acc[kWarpRows][4];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float base[4];                        // csq of the columns, read early
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ci = c0 + tx + 32 * j;
    base[j] = (kL2 && ci < C) ? csq[ci] : 0.f;
  }
  const Stager<kVec> stager(x, y, q0, c0, Q, C, D);
  const int nk = (D + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stager.stage(smem + s * kStageFloats, s * kChunk, D);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();       // chunk k has landed (own copies)
    __syncthreads();                    // everyone's; chunk k - 1 is done
    const int kn = k + kStages - 1;
    if (kn < nk) stager.stage(smem + (kn % kStages) * kStageFloats, kn * kChunk, D);
    cp_async_commit();
    const float* xs = smem + (k % kStages) * kStageFloats;
    const float* ys = xs + kRows * kStride;
    const int left = D - k * kChunk;    // valid d of this chunk
#pragma unroll
    for (int k4 = 0; k4 < kChunk / 4; ++k4) {
      if (k4 * 4 >= left) break;
      float4 xv[kWarpRows], yv[4];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            xs + (ty * kWarpRows + i) * kStride + k4 * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        yv[j] = *reinterpret_cast<const float4*>(
            ys + (tx + 32 * j) * kStride + k4 * 4);
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(xv[i].x, yv[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv[i].y, yv[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv[i].z, yv[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv[i].w, yv[j].w, acc[i][j]);
        }
    }
  }

  if (!kTopk) {
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int qi = q0 + ty * kWarpRows + i;
      if (qi >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = c0 + tx + 32 * j;
        if (ci < C) out[(int64_t)qi * C + ci] = score_of(acc[i][j], base[j], kL2);
      }
    }
    return;
  }

  // ---- top-nprobe: this tile's best K of each row ----
  const int n_ct = gridDim.x, K = tile_keys(nprobe);
  const int64_t row0 = q0 + ty * kWarpRows;
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free: reuse it
  u64* keys = reinterpret_cast<u64*>(smem) + ty * kWarpRows * kKeyStride;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = c0 + tx + 32 * j;
      keys[i * kKeyStride + tx + 32 * j] = (row0 + i < Q && ci < C)
          ? key_of(score_of(acc[i][j], base[j], kL2), ci, kL2) : kPad;
    }
  }
  __syncwarp();
  if (nprobe <= 32) {
    switch (K) {
      case 1: return small_topk<1, kL2>(keys, out, ids, scratch, counters, row0, Q, nprobe, tx);
      case 2: return small_topk<2, kL2>(keys, out, ids, scratch, counters, row0, Q, nprobe, tx);
      case 4: return small_topk<4, kL2>(keys, out, ids, scratch, counters, row0, Q, nprobe, tx);
      case 8: return small_topk<8, kL2>(keys, out, ids, scratch, counters, row0, Q, nprobe, tx);
      case 16: return small_topk<16, kL2>(keys, out, ids, scratch, counters, row0, Q, nprobe, tx);
      default: return small_topk<32, kL2>(keys, out, ids, scratch, counters, row0, Q, nprobe, tx);
    }
  }
  // past 32: rank by counting, in shared memory
  int nc[kWarpRows];
  warp_select<kWarpRows>(keys, kKeyStride, kCols, K, nc, [&](int r, int rank, u64 e) {
    scratch[((row0 + r) * n_ct + blockIdx.x) * K + rank] = e;
  });
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    if (row0 + i >= Q) continue;
    for (int p = nc[i] + tx; p < K; p += 32)     // a ragged tile's missing keys
      scratch[((row0 + i) * n_ct + blockIdx.x) * K + p] = kPad;
  }

  // ---- the last block of the row tile merges its C tiles ----
  if (!last_of_row_tile(counters)) return;
  const int n = n_ct * K;
  u64* buf = reinterpret_cast<u64*>(smem) + ty * kWarpRows * n;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const bool row_ok = row0 + i < Q;
    const u64* src = scratch + (row0 + i) * n;
    for (int f = tx; f < n; f += 32)
      buf[i * n + f] = row_ok ? __ldcg(src + f) : kPad;
  }
  __syncwarp();
  warp_select<kWarpRows>(buf, n, n, nprobe, nc, [&](int r, int rank, u64 e) {
    const int64_t o = (row0 + r) * nprobe + rank;
    out[o] = score_of_key(e, kL2);
    ids[o] = (int64_t)(e & 0xffffffffu);
  });
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;
}

template <bool kTopk>
int launch(const float* x, const float* y, const float* csq, float* out,
           int64_t* ids, u64* scratch, int* counters, int Q, int C, int D,
           int nprobe, int l2, cudaStream_t st) {
  const dim3 grid((unsigned)((C + kCols - 1) / kCols),
                  (unsigned)((Q + kRows - 1) / kRows));
  size_t smem = kRingBytes;
  if (kTopk && nprobe > 32) {            // the rank-counting merge's keys
    const size_t merge = (size_t)kThreads / 32 * kWarpRows * grid.x *
                         (size_t)tile_keys(nprobe) * sizeof(u64);
    smem = merge > smem ? merge : smem;
  }
  const bool vec = D % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  auto kernel = l2 ? (vec ? &ivf_filter_kernel<true, true, kTopk>
                          : &ivf_filter_kernel<true, false, kTopk>)
                   : (vec ? &ivf_filter_kernel<false, true, kTopk>
                          : &ivf_filter_kernel<false, false, kTopk>);
  const int rc = scan::allow_smem(kernel, smem);
  if (rc) return rc;
  kernel<<<grid, kThreads, smem, st>>>(x, y, csq, out, ids, scratch, counters,
                                       Q, C, D, nprobe);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (Q, D) f32; y: (C, D) f32; csq: (C,) f32 (read for l2 only); out:
// (Q, C) f32, written. l2 != 0 selects the l2 epilogue.
extern "C" int ivf_filter_launch(const void* x, const void* y, const void* csq,
                                 void* out, int Q, int C, int D, int l2,
                                 void* stream) {
  if (Q == 0 || C == 0) return 0;
  return launch<false>((const float*)x, (const float*)y, (const float*)csq,
                       (float*)out, nullptr, nullptr, nullptr, Q, C, D, 0, l2,
                       (cudaStream_t)stream);
}

// As ivf_filter_launch, with the top-nprobe epilogue: scores (Q, nprobe)
// f32 and ids (Q, nprobe) int64, written; scratch: (Q, ceil(C / 128),
// tile_keys(nprobe)) 64-bit keys; counters: ceil(Q / 8) int32, zero on
// entry and left zero. 1 <= nprobe <= C.
extern "C" int ivf_filter_topk_launch(const void* x, const void* y,
                                      const void* csq, void* scores, void* ids,
                                      void* scratch, void* counters, int Q,
                                      int C, int D, int nprobe, int l2,
                                      void* stream) {
  if (Q == 0) return 0;
  if (nprobe < 1 || nprobe > C) return (int)cudaErrorInvalidValue;
  return launch<true>((const float*)x, (const float*)y, (const float*)csq,
                      (float*)scores, (int64_t*)ids, (u64*)scratch,
                      (int*)counters, Q, C, D, nprobe, l2, (cudaStream_t)stream);
}
