// Fused two-stage scan for Hopper (sm_90a): int8 hit counts -> survivor
// threshold -> top-C candidates -> masked ADC on the candidates only.
//
// Replaces: src/repro/kernels/fused_two_stage.py:fused_two_stage
// (_fused_kernel). Contract and design: two_stage.cuh (the count and
// select kernels, shared with fused_three_stage.cu). Here the optional
// probe mask is an input: null scans every probe; the RT prefilter's
// composed path (fused3=False) passes its (Q, np) verdict.
//
// What bounds it: bytes. Stage 1 reads every kept probe's valid code rows
// once (S bytes a point), the int8 table and the valid mask, and writes
// counts; stage 2 writes dist and reads lut only at the C candidates. At
// the main-path shape the code bytes and the two (Q, np, P) outputs
// dominate.
#include "two_stage.cuh"

// lut: (Q, np, S, E) f32; table: (Q, np, S, E) int8; codes: (n_cl, P, S)
// uint8; valid: (n_cl, P) bool; cids: (Q, np) int64 cluster ids; probe_ok:
// (Q, np) bool or null. counts (Q, np, P) int32, dist (Q, np, P) f32, cand
// (Q, C) int32 and cand_dist (Q, C) f32 are written; hist (Q, np, 2S+2)
// int32 is scratch that the count kernel writes whole, so it needs no
// zeroing and a call is the two launches. count_threads, count_per_thread
// and select_threads pick the launch shape (two_stage::with_launch_shape:
// (256, 16, 256) is the default; a shape off its lattice returns
// cudaErrorInvalidValue and launches nothing); every shape gives the same
// bits.
extern "C" int fused_two_stage_launch(const void* lut, const void* table,
                                      const void* codes, const void* valid,
                                      const void* cids, const void* probe_ok,
                                      void* counts, void* dist, void* cand,
                                      void* cand_dist, void* hist, int Q,
                                      int n_probe, int P, int S, int E, int C,
                                      float bad, int count_threads,
                                      int count_per_thread, int select_threads,
                                      void* stream) {
  const two_stage::SphereTest none{};
  return two_stage::launch<false>(lut, table, codes, valid, cids, none,
                                  const_cast<void*>(probe_ok), counts, dist, cand,
                                  cand_dist, hist, Q, n_probe, P, S, E, C, bad,
                                  count_threads, count_per_thread, select_threads,
                                  stream);
}
