// Three-stage scan for Hopper (sm_90a): the RT sphere test, the int8
// hit-count prefilter and the masked ADC of the top-C survivors, without
// the hit table or the probe mask ever leaving the card.
//
// Replaces: src/repro/kernels/fused_three_stage.py:fused_three_stage
// (_fused3_kernel). Contract: the reference's host path
// fused_three_stage_host (same file, l.308): the dense sphere test
// (src/repro/kernels/ref.py:rt_sphere_hits_ref) gathered at
// slot_idx = grid.slot_of[cids] gives probe_ok, probe 0 is forced True,
// and the fused two-stage scan runs over valid & probe_ok. Outputs are that
// scan's four plus probe_ok (Q, np) bool.
//
// The TPU kernel walks every grid cell in a phase of its own (its grid needs
// a program per cell) and merges each cell's verdicts into a probe scratch.
// On the card a probe's verdict depends only on its own slot, so phase 0
// becomes the prologue of the count kernel's (q, probe) block: one disc
// test at slot_idx[q, probe] (rt::sphere_hit, the oracle's rounding), then
// the block scans the probe or, pruned, writes invalid counts without
// reading its table or codes. Everything else is the two-stage design
// (two_stage.cuh), whose select kernel reads the probe_ok just written; a
// call is those two launches.
//
// What bounds it: bytes, as the two-stage scan, but only the kept probes'
// code rows are read: at a calibrated radius the sphere test prunes most
// probes, so the work shrinks with the survivors.
#include "two_stage.cuh"

// lut, table, codes, valid, cids, the outputs and hist as in
// fused_two_stage_launch; q0, q1: (Q,) f32 ray-plane queries read at element
// strides q0_stride and q1_stride (the columns of the engine's (Q, 2)
// projection, read in place); radius: (Q,) f32; c0, c1, reach:
// (n_cells*cap,) f32 grid slot planes (reach -inf at pads); slot_idx:
// (Q, np) int32 grid slot of each probed cluster; probe_ok: (Q, np) bool,
// written; the launch shape as in fused_two_stage_launch.
extern "C" int fused_three_stage_launch(const void* lut, const void* table,
                                        const void* codes, const void* valid,
                                        const void* cids, const void* q0,
                                        const void* q1, const void* radius,
                                        const void* c0, const void* c1,
                                        const void* reach, const void* slot_idx,
                                        void* probe_ok, void* counts, void* dist,
                                        void* cand, void* cand_dist, void* hist,
                                        long long q0_stride, long long q1_stride,
                                        int Q, int n_probe, int P, int S, int E,
                                        int C, float bad, int count_threads,
                                        int count_per_thread, int select_threads,
                                        void* stream) {
  const two_stage::SphereTest sph{(const float*)q0,     (const float*)q1,
                                  q0_stride,            q1_stride,
                                  (const float*)radius, (const float*)c0,
                                  (const float*)c1,     (const float*)reach,
                                  (const int32_t*)slot_idx};
  return two_stage::launch<true>(lut, table, codes, valid, cids, sph, probe_ok,
                                 counts, dist, cand, cand_dist, hist, Q, n_probe,
                                 P, S, E, C, bad, count_threads, count_per_thread,
                                 select_threads, stream);
}
