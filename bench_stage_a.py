#!/usr/bin/env python3
"""Time the port's stages A, B and C and its insert label on the card, for one tree.

    python3 bench_stage_a.py [--src DIR] [--label NAME] [--reps 50]
    python3 bench_stage_a.py --stage-b [--src DIR] [--label NAME]
    python3 bench_stage_a.py --stage-c [--src DIR] [--label NAME]
    python3 bench_stage_a.py --hit-count [--src DIR] [--label NAME]
    python3 bench_stage_a.py --hit-count --calls FILE [--src DIR] [--label NAME]
    python3 bench_stage_a.py --pq-scan [--calls FILE] [--src DIR] [--label NAME]
    python3 bench_stage_a.py --sphere [--src DIR] [--label NAME]
    python3 bench_stage_a.py --build [--src DIR] [--label NAME]
    python3 bench_stage_a.py --kernels
    python3 bench_stage_a.py --phases
    python3 bench_stage_a.py --traces TRACE.json.gz ...

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src/``),
so that two trees can be timed in one call, in turns: unpack another commit
with ``git archive`` into a directory that ``.gitignore`` lists and run
this script once with each ``--src``. For each shape it times
``core.ivf.filter_clusters`` (a search batch's stage A) or
``core.juno._label_encode`` (an insert batch's labels and codes) on
random data from a fixed seed:

- ``device_ms``: median device time of one call over ``--reps`` calls (CUDA
  events; the stream sleeps first, so the events bracket device work
  only);
- ``host_ms``: median wall time of one call ended by a synchronise;
- ``kernels`` and ``sorts``: the kernels one call launches on the card,
  and how many of them are sorts (``torch.profiler``).

With ``--stage-b`` it times stage B instead, for the tree of ``--src``
(so two trees compare in turns as above): the ``selective_lut`` kernel on
contiguous (B, S) planes over B in {16, 128, 512, 1024, 2048, 4096}, S in
{48, 100}, l2 and ip (E = 256), with ``device_ms``, ``kernel_us``, the
least time the card could take (``bound_ms``: 5 bytes an entry written,
the inputs read once, at 3.35 TB/s) and ``write_floor_ms``, one ``fill_``
of the same output bytes (a yardstick of the card's reachable write rate,
not a library call); then ``ops.build_selective_lut`` as
``core/juno.py:_stage_b`` calls it (Q = 128, nprobe 8 and 16; l2 residuals
at D = 96, ip's ``qsub`` expanded over the probes at D = 200), with
``device_ms``, ``host_ms`` and ``kernels``.

With ``--build`` it times the tree's kernel build instead: each source of
``_build.SOURCES`` compiled alone, one ``nvcc`` at a time (the flags of
``_build.NVCC_FLAGS``, into a temporary directory, so nothing cached is
reused), with its seconds.

With ``--stage-c`` it times stage C's fused scans instead, for the tree
of ``--src`` (two trees in turns as above): ``ops.fused_two_stage_scan``
(every probe kept) and ``ops.fused_three_stage_scan`` (coverage "half",
"probe0" and "full", as ``chip_smoke.py`` phase 3 sets the radii) over
Q in {8, 32, 128} x C in {320, 3200}, at l2 S = 48 and ip S = 100 (np =
16, P = 3912, E = 256, a quarter of the slots valid at random, 1024
clusters probed with repeats across the batch as ``chip_smoke.py`` draws
them), plus both at Q = 128, C = 320, full coverage over 2048 distinct
clusters (no cluster probed twice), and at Q = 32 and 128, C = 320, with
the valid slots packed at the front of each cluster as a built index lays
them out (``cids`` "packed"; two-stage, three-stage at half and probe-0
coverage). Each row has ``device_ms`` (CUDA events), the profiler's
mean ``count_us`` and ``select_us`` (kernels whose names hold
``count_kernel`` and ``select_kernel``), ``kernels`` a call (every kernel
the profiler sees, fills and copies included), ``bound_ms`` (what the work
must move at 3.35 TB/s: the kept probes' distinct clusters' valid rows and
valid codes, their int8 tables, the LUT at the C candidates, the outputs
once), ``write_floor_ms`` (one ``fill_`` of the ``counts`` and ``dist``
bytes) and a hash of every output, so that two trees' outputs can be seen
to be bit-equal.

With ``--hit-count`` it times tiers M, L and composed H2's scan instead,
for the tree of ``--src`` (two trees in turns as above): the counts-only
``ops.hit_count_scan`` and the top-k route, ``ops.hit_count_topk_scan``
where the tree has it, else the route the engines took before it (the
counts, a stable sort, a slice), over the rows of ``chip_smoke.py`` phase 3
(np 8 with k 10 and 100 at l2 S = 48 and ip S = 100, np 16 with C 40 and
400 at l2, Q 128, 32 and 8; P = 3912, E = 256, 1024 clusters; a quarter
of the slots valid at random, packed at the front of each cluster, or
0.2% valid, fewer than k a query). Each row has ``device_ms`` (CUDA
events), the profiler's mean ``count_us`` (``hit_count_kernel``) and
``topk_us`` (``hit_topk_kernel``) a launch, ``sort_us`` (every sort kernel
of a call), ``kernels`` a call and a hash of the outputs (values as f32,
positions as int64), so that two trees' outputs can be seen to be
bit-equal. With ``--calls FILE`` it replays instead the calls of one engine
pass that ``chip_smoke.py --hit-calls`` recorded (the built index's codes
and valid mask, stage B's tables, the probed cluster ids, k), per tier
(np 8: M and L, np 16: composed H2), through both routes: the count,
top-k and sort kernels' ms over the pass (profiler), the kernels a pass,
on the recorded inputs also the summed device ms of its calls, a hash of
the outputs; and on four variants of the inputs that each change one
thing: random {-1, 0, +1} tables, all-zero tables (every valid point in one
histogram bin), the valid slots packed at the front of each cluster with
700–1254 a cluster, as the synthetic rows lay them out, and each cluster's
valid slots capped at the 90th percentile of the probed clusters' fill (its
fullest clusters cut down, the rest as built); every row also with the
count kernel's µs a launch by batch size.

With ``--pq-scan`` it times tier H's scan instead, for the tree of
``--src`` (two trees in turns as above): the scores-only
``ops.masked_adc_scan`` and the top-k route, ``ops.masked_adc_topk_scan``
where the tree has it, else the route before it (the scores, the offset
add, a stable sort, a slice), over the rows of ``chip_smoke.py`` phase 3
(np 16, P = 3912, E = 256, 1024 clusters; l2 S = 48 and ip S = 100 with
stage A's offset; k 100 and 10; Q 128, 32 and 8; a quarter of the slots
valid at random, packed at the front of each cluster, or 0.1% valid
(fewer than k = 100 a query at np 16); an
integer-valued LUT, so that exact ties cross probes; every probe but 0
pruned; and, as a yardstick of the LUT loads' bank conflicts, Q 128
rows whose codes have the reading lane as their low 5 bits, so that no
load conflicts). Each row has ``device_ms`` (CUDA events), the profiler's mean
``scan_us`` (``pq_scan_kernel``), ``topk_us`` (``pq_topk_kernel``) and
``merge_us`` (``pq_merge_kernel``) a launch, ``sort_us`` (every sort kernel
of a call), ``kernels`` a call and a hash of the outputs, so that two
trees' outputs can be seen to be bit-equal. With ``--calls FILE`` it
replays instead the tier-H calls of one pass of the unfused scan engine
that ``chip_smoke.py --hit-calls`` recorded (``pq_calls_<index>.pt``),
through the top-k route and the scores-only kernel: the kernels' ms over
the pass by kind, kernels a pass, the summed device ms and a hash.

With ``--sphere`` it times the rt search's probe mask
(``core.juno._rt_probe_mask``) of the tree on a synthetic grid at the
engines' Q 128 (np 16, S 48, D 96 and np 8, S 100, D 200), 32 and 8:
``device_ms``, ``host_ms``, kernels and host copies a call (profiler) and
a hash of ``probe_ok``; with the probe entry (``ops.rt_probe_mask``) also
its device ms, the probe kernel's own µs and an empty kernel's on the same
grid (the launch floor). A tree without the entry runs its own route. Then
the projection onto the ray plane at Q 8–1024 and D 96 and 200, as one
(Q, D) × (D, 2) product and as Q (1, D) × (D, 2) products (``bmm``, the
search's form): device ms, kernels a call, and whether the two agree.

With ``--kernels`` it times the ``ivf_filter`` kernel's two epilogues
instead (this tree only), over a sweep of shapes, nprobe and D: besides
``device_ms`` (CUDA events), ``kernel_us``, the kernel's own mean duration
in the profiler over ``--reps`` launches, which leaves out the events' and
the launch's share.

With ``--phases`` it builds a copy of ``csrc/ivf_filter.cu`` with SM clock
stamps (``clock64``, thread 0 of each block) written after each phase of
the top-nprobe epilogue into ``build/diag/``, and prints the median cycles
of each phase over the blocks of one launch (the merge phases over the
blocks that merged): a profile of the epilogue where no kernel profiler
runs. The copy is only measured, never used.

With ``--traces`` it reads gzipped Chrome traces of the profiled passes
that ``chip_smoke.py`` writes and sums the device time and launches of
their kernels by kind (stage A, sorts, stage B, count, select, ``pq_scan``,
the rt probe mask, the rest), and the segment from each stage-B launch to
the next scan kernel (kernels a segment, device ms a pass); this needs no
card.

Prints one JSON line a shape (or trace), each measured one with the card's
name and power limit. Needs a CUDA card except with ``--traces``; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def host_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def kernels_of(fn) -> tuple[int, int]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sorts = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and "Memcpy" not in ev.key \
                and "Memset" not in ev.key:
            n += ev.count
            sorts += ev.count if "sort" in ev.key.lower() else 0
    return n, sorts


def kernel_us(fn, reps: int, name: str = "ivf_filter") -> float:
    """Mean duration of the kernels whose name holds ``name`` (None when
    the profiler recorded none of them: it can miss a window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = n = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and name in ev.key:
            total += ev.self_device_time_total
            n += ev.count
    return total / n if n else None


def kernel_sweep(card: str, reps: int) -> None:
    from repro_torch.kernels import ivf_filter as ivff
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for q, c, d in ((128, 1024, 4), (128, 1024, 96), (128, 1024, 200),
                    (1000, 1024, 96), (8, 1024, 96), (128, 128, 96)):
        qs = torch.randn((q, d), generator=gen, device=dev)
        cent = torch.randn((c, d), generator=gen, device=dev)
        csq = torch.sum(cent * cent, -1)
        for nprobe in (0, 1, 8, 16, 32, 64):
            if nprobe > c:
                continue
            if nprobe:
                fn = lambda: ivff.ivf_filter_topk(qs, cent, csq,
                                                   nprobe=nprobe)
            else:
                fn = lambda: ivff.ivf_filter(qs, cent, csq)
            print(json.dumps({
                "epilogue": "top-nprobe" if nprobe else "matrix", "Q": q,
                "C": c, "D": d, "nprobe": nprobe, "metric": "l2",
                "device_ms": device_ms(fn, reps),
                "kernel_us": kernel_us(fn, reps), "card": card}),
                flush=True)


def stage_b(card: str, label: str, reps: int) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_lut as slut
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    e = 256
    for metric in ("l2", "ip"):
        for s in (48, 100):
            for b in (16, 128, 512, 1024, 2048, 4096):
                q = torch.randn((2, b, s), generator=gen, device=dev) * 0.5
                ent = torch.randn((2, s, e), generator=gen, device=dev) * 0.5
                esq = ent[0] * ent[0] + ent[1] * ent[1]
                tau = torch.rand((b, s), generator=gen, device=dev) * 0.8
                args = (q[0].contiguous(), q[1].contiguous(),
                        ent[0].contiguous(), ent[1].contiguous(), esq, tau)
                fn = lambda: slut.selective_lut(*args, metric=metric)
                n_bytes = 4 * (3 * b * s + 3 * s * e) + 5 * b * s * e
                buf = torch.empty(5 * b * s * e, dtype=torch.uint8, device=dev)
                print(json.dumps({
                    "label": label, "what": "selective_lut", "metric": metric,
                    "B": b, "S": s, "E": e, "device_ms": device_ms(fn, reps),
                    "kernel_us": kernel_us(fn, reps, "selective_lut"),
                    "bound_ms": n_bytes / 3.35e12 * 1e3,
                    "write_floor_ms": device_ms(lambda: buf.fill_(1), reps),
                    "card": card}), flush=True)
                del buf
    c, nq = 1024, 128
    for metric, d in (("l2", 96), ("ip", 200)):
        s = d // 2
        queries = torch.randn((nq, d), generator=gen, device=dev)
        cent = torch.randn((c, d), generator=gen, device=dev)
        entries = torch.randn((s, e, 2), generator=gen, device=dev)
        esq = torch.sum(entries * entries, -1)
        for nprobe in (8, 16):
            cids = torch.randint(0, c, (nq, nprobe), generator=gen, device=dev)
            if metric == "l2":
                qsub = (queries[:, None, :] - cent[cids]).reshape(
                    nq, nprobe, s, 2)
            else:
                qsub = queries.reshape(nq, 1, s, 2).expand(nq, nprobe, s, 2)
            tau = torch.rand((nq, nprobe, s), generator=gen, device=dev)
            fn = lambda: ops.build_selective_lut(qsub, entries, esq, tau,
                                                 metric=metric)
            n, _ = kernels_of(fn)
            print(json.dumps({
                "label": label, "what": "build_selective_lut",
                "metric": metric, "Q": nq, "nprobe": nprobe, "S": s, "E": e,
                "device_ms": device_ms(fn, reps),
                "host_ms": host_ms(fn, reps), "kernels": n, "card": card}),
                flush=True)



def _grid(g: int, cap: int, gen) -> tuple:
    """A g×g-cell synthetic centroid grid of ``cap`` slots a cell, as
    ``chip_smoke.py`` draws it (a copy: importing ``chip_smoke.py`` would
    bind this checkout's ``repro_torch``, not ``--src``'s): (c0, c1, reach)
    (g·g, cap) f32 with -inf reach at pad slots, and the flat indices of the
    real slots."""
    dev = torch.device("cuda")
    n_cells = g * g
    fill = torch.randint(0, cap + 1, (n_cells,), generator=gen, device=dev)
    fill[0], fill[-1] = 0, cap
    real = torch.arange(cap, device=dev)[None, :] < fill[:, None]
    cell = torch.arange(n_cells, device=dev)
    u = torch.rand((2, n_cells, cap), generator=gen, device=dev)
    c0 = ((cell // g)[:, None] + u[0]) / g
    c1 = ((cell % g)[:, None] + u[1]) / g
    reach = (torch.randn((n_cells, cap), generator=gen, device=dev) * 0.05).abs()
    reach = torch.where(real, reach, torch.tensor(float("-inf"), device=dev))
    return c0, c1, reach, torch.nonzero(real.reshape(-1))[:, 0]


_SPLIT = {"count_kernel": ("count_kernel",), "select_kernel": ("select_kernel",)}


def kernel_split(fn, reps: int, kinds: dict = _SPLIT
                 ) -> tuple[dict, dict, float]:
    """Mean µs a launch of each kind of kernel (``kinds``: name -> the
    substrings of its kernels' names; by default the two-stage count and
    select kernels) over ``reps`` calls of ``fn``, None where the
    profiler saw none; the launches of each kind a call; and the kernels a
    call (every CUDA kernel the profiler sees)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n, total = collections.Counter(), collections.Counter(), 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        total += ev.count
        for kind, subs in kinds.items():
            if any(sub in ev.key for sub in subs):
                us[kind] += ev.self_device_time_total
                n[kind] += ev.count
    return ({k: us[k] / n[k] if n[k] else None for k in kinds},
            {k: n[k] / reps for k in kinds}, total / reps)


def _digest(outs, names=("counts", "dist", "cand", "cand_dist",
                         "probe_ok")) -> dict:
    import hashlib
    return {n: hashlib.sha256(t.contiguous().cpu().numpy().tobytes())
            .hexdigest()[:16] for n, t in zip(names, outs)}


def stage_c(card: str, label: str, reps: int) -> None:
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    n_probe, p, e, n_clusters = 16, 3912, 256, 1024
    for metric, s in (("l2", 48), ("ip", 100)):
        # 2048 clusters: the first 1024 serve the repeated-cids rows, all
        # of them the distinct-cids row; a quarter of the slots valid at
        # random, and for the "packed" rows at the front of each cluster,
        # as a built index lays them out
        codes = torch.randint(0, e, (2 * n_clusters, p, s), generator=gen,
                              device=dev, dtype=torch.uint8)
        valid = torch.rand((2 * n_clusters, p), generator=gen,
                           device=dev) < 0.25
        fill = torch.randint(700, 1255, (2 * n_clusters, 1), generator=gen,
                             device=dev)
        packed = torch.arange(p, device=dev)[None, :] < fill
        c0, c1, reach, real = _grid(16, 64, gen)
        for q in (8, 32, 128):
            if metric == "l2":
                lut = torch.rand((q, n_probe, s, e), generator=gen,
                                 device=dev) * 4.0
            else:
                lut = torch.randn((q, n_probe, s, e), generator=gen,
                                  device=dev)
            table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                                  device=dev, dtype=torch.int8)
            repeated = torch.stack([
                torch.randperm(n_clusters, generator=gen, device=dev)[:n_probe]
                for _ in range(q)])
            cid_sets = [("repeated", repeated)]
            if q == 128:
                cid_sets.append(("distinct", torch.randperm(
                    2 * n_clusters, generator=gen, device=dev)[:q * n_probe]
                    .reshape(q, n_probe)))
            if q >= 32:
                cid_sets.append(("packed", repeated))
            slot_idx = real[torch.randint(0, real.numel(), (q, n_probe),
                                          generator=gen, device=dev)
                            ].to(torch.int32)
            # q0, q1 as the engine passes them: columns of a (Q, 2) product
            qp2 = torch.rand((q, 2), generator=gen, device=dev)
            q0, q1 = qp2[:, 0], qp2[:, 1]
            dx = q0.double()[:, None] - c0.reshape(-1)[slot_idx.long()].double()
            dy = q1.double()[:, None] - c1.reshape(-1)[slot_idx.long()].double()
            gap = torch.sqrt(dx * dx + dy * dy) - \
                reach.reshape(-1)[slot_idx.long()].double()
            radii = {"half": torch.median(gap, dim=1).values.float(),
                     "probe0": torch.full((q,), -1e6, device=dev),
                     "full": torch.full((q,), 1e6, device=dev)}
            for cids_kind, cids in cid_sets:
                vmask = packed if cids_kind == "packed" else valid
                for cap_c in ((320, 3200) if cids_kind == "repeated"
                              else (320,)):
                    kinds = [("fused_two_stage", "full")] + [
                        ("fused_three_stage", cov) for cov in
                        {"repeated": ("half", "probe0", "full"),
                         "distinct": ("full",),
                         "packed": ("half", "probe0")}[cids_kind]]
                    for what, cov in kinds:
                        kw = dict(cap_c=cap_c, metric=metric)
                        sph = (q0, q1, radii[cov], c0, c1, reach, slot_idx)
                        if what == "fused_two_stage":
                            fn = lambda kw=kw, cids=cids, v=vmask: \
                                ops.fused_two_stage_scan(
                                    lut, table, codes, v, cids, **kw)
                        else:
                            fn = lambda kw=kw, cids=cids, sph=sph, v=vmask: \
                                ops.fused_three_stage_scan(
                                    lut, table, codes, v, cids, *sph, **kw)
                        outs = fn()
                        kept = (outs[4] if len(outs) == 5 else
                                torch.ones_like(cids, dtype=torch.bool))
                        rows = torch.unique(cids[kept])
                        w = n_probe * p
                        n_bytes = (rows.numel() * p
                                   + int(vmask[rows].sum()) * s
                                   + int(kept.sum()) * s * e
                                   + q * cap_c * s * 4 + cids.numel() * 8
                                   + q * w * 8 + q * cap_c * 8)
                        if what == "fused_three_stage":
                            n_bytes += q * n_probe * (4 + 12 + 1) + 12 * q
                        split, _, n_kernels = kernel_split(fn, reps)
                        buf = torch.empty(q * w * 8, dtype=torch.uint8,
                                          device=dev)
                        print(json.dumps({
                            "label": label, "what": what, "metric": metric,
                            "coverage": cov, "cids": cids_kind, "Q": q,
                            "np": n_probe, "P": p, "S": s, "E": e,
                            "C": cap_c,
                            "probes_kept": float(kept.float().mean()),
                            "device_ms": device_ms(fn, reps),
                            "count_us": split["count_kernel"],
                            "select_us": split["select_kernel"],
                            "kernels": n_kernels,
                            "bound_ms": n_bytes / 3.35e12 * 1e3,
                            "write_floor_ms": device_ms(
                                lambda: buf.fill_(1), reps),
                            "hash": _digest(outs), "card": card}),
                            flush=True)
                        del buf, outs
            del lut, table
        del codes, valid
        torch.cuda.empty_cache()

def hit_count_rows(card: str, label: str, reps: int) -> None:
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    p, e, n_clusters = 3912, 256, 1024
    # (Q, np, valid layout, k values) a metric
    configs = {"l2": [(128, 8, "random", (100, 10)), (128, 16, "random", (40, 400)),
                      (32, 8, "random", (100,)), (8, 8, "random", (100,)),
                      (32, 16, "random", (400,)), (8, 16, "random", (400,)),
                      (128, 8, "packed", (100,)), (128, 16, "packed", (400,)),
                      (128, 8, "few", (100,))],
               "ip": [(128, 8, "random", (100, 10)), (128, 8, "packed", (100,))]}
    for metric, s in (("l2", 48), ("ip", 100)):
        codes = torch.randint(0, e, (n_clusters, p, s), generator=gen,
                              device=dev, dtype=torch.uint8)
        fill = torch.randint(700, 1255, (n_clusters, 1), generator=gen,
                             device=dev)
        u = torch.rand((n_clusters, p), generator=gen, device=dev)
        valids = {"random": u < 0.25, "few": u < 0.002,
                  "packed": torch.arange(p, device=dev)[None, :] < fill}
        for q, n_probe, layout, ks in configs[metric]:
            table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                                  device=dev, dtype=torch.int8)
            cids = torch.stack([torch.randperm(n_clusters, generator=gen,
                                               device=dev)[:n_probe]
                                for _ in range(q)])
            v = valids[layout]
            counts = lambda v=v, table=table, cids=cids: ops.hit_count_scan(
                table, codes, v, cids)
            fns = [("counts", "counts kernel", None, counts)]
            for k in ks:
                if hasattr(ops, "hit_count_topk_scan"):
                    fn = lambda v=v, table=table, cids=cids, k=k: \
                        ops.hit_count_topk_scan(table, codes, v, cids, k)
                    route = "count + top-k kernels"
                else:
                    def fn(counts=counts, q=q, k=k):
                        c = counts().reshape(q, -1)
                        vals, pos = torch.sort(c, dim=1, descending=True,
                                               stable=True)
                        return vals[:, :k].float(), pos[:, :k]
                    route = "counts kernel + sort(stable) + slice"
                fns.append(("top-k", route, k, fn))
            for what, route, k, fn in fns:
                outs = fn()
                outs = outs if isinstance(outs, tuple) else (outs,)
                us, n, n_kernels = kernel_split(
                    fn, reps, {"count_us": ("hit_count_kernel",),
                               "topk_us": ("hit_topk_kernel",),
                               "sort_us": ("ort",)})
                # the sorts: every sort kernel of a call, summed
                if us["sort_us"] is not None:
                    us["sort_us"] *= n["sort_us"]
                print(json.dumps({
                    "label": label, "what": what, "route": route,
                    "metric": metric, "Q": q, "np": n_probe, "P": p, "S": s,
                    "E": e, "k": k, "valid": layout,
                    "device_ms": device_ms(fn, reps), **us,
                    "kernels": n_kernels,
                    "hash": _digest(outs, ("values", "positions")
                                    if len(outs) == 2 else ("counts",)),
                    "card": card}), flush=True)
            del table, cids
        del codes, valids
        torch.cuda.empty_cache()


def hit_count_calls(card: str, label: str, reps: int, path: str) -> None:
    """Replay one engine pass's recorded ``hit_count_topk_scan`` calls
    (``chip_smoke.py --hit-calls``) through this tree's counts-only and
    top-k routes, per tier, on the recorded inputs and on three variants
    of them, to tell what in the engine's inputs sets the count kernel's
    time."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rec = torch.load(path)
    codes, valid = rec["codes"].to(dev), rec["valid"].to(dev)
    n_cl, p = valid.shape
    fill = torch.randint(700, 1255, (n_cl, 1), generator=gen, device=dev)
    uniform = torch.arange(p, device=dev)[None, :] < fill
    calls = [{k: (v.to(dev) if torch.is_tensor(v) else v)
              for k, v in c.items()} for c in rec["calls"]]
    has_topk = hasattr(ops, "hit_count_topk_scan")
    kinds = {"count_us": ("hit_count_kernel",), "topk_us": ("hit_topk_kernel",),
             "sort_us": ("ort",)}
    for n_probe in sorted({c["cids"].shape[1] for c in calls}):
        group = [c for c in calls if c["cids"].shape[1] == n_probe]
        # the 90th percentile of the fill of the clusters the pass probes
        cap = int(torch.quantile(torch.cat(
            [valid.sum(1)[c["cids"]].reshape(-1) for c in group]).float(),
            0.9))
        variants = {
            "engine": [(c["table"], valid) for c in group],
            "random table": [(torch.randint(-1, 2, c["table"].shape,
                                            generator=gen, device=dev,
                                            dtype=torch.int8), valid)
                             for c in group],
            "zero table": [(torch.zeros_like(c["table"]), valid)
                           for c in group],
            "uniform fill": [(c["table"], uniform) for c in group],
            "capped fill": [(c["table"], valid & (torch.arange(p, device=dev)
                                                  < cap)) for c in group]}
        for variant, ins in variants.items():
            def counts(c, tab, v):
                return ops.hit_count_scan(tab, codes, v, c["cids"],
                                          probe_ok=c["probe_ok"])

            def topk(c, tab, v):
                if has_topk:
                    return ops.hit_count_topk_scan(tab, codes, v, c["cids"],
                                                   c["k"],
                                                   probe_ok=c["probe_ok"])
                cnt = counts(c, tab, v).reshape(c["cids"].shape[0], -1)
                vals, pos = torch.sort(cnt, dim=1, descending=True,
                                       stable=True)
                return vals[:, :c["k"]].float(), pos[:, :c["k"]]

            for what, fn in (("counts", counts), ("top-k", topk)):
                def whole(sel=None, fn=fn):
                    return [fn(c, *x) for c, x in zip(group, ins)
                            if sel is None or c["cids"].shape[0] == sel]
                us, n, n_kernels = kernel_split(whole, 5, kinds)
                row = {"label": label, "what": what, "variant": variant,
                       "tier": "M/L" if n_probe == 8 else "composed H2",
                       "np": n_probe, "calls": len(group),
                       "route": ("count + top-k kernels" if has_topk else
                                 "counts kernel + sort(stable) + slice")
                       if what == "top-k" else "counts kernel",
                       # kernel ms over the pass, by kind
                       **{k.replace("_us", "_ms_pass"):
                          None if us[k] is None else us[k] * n[k] / 1e3
                          for k in kinds},
                       "kernels_a_pass": n_kernels, "card": card,
                       # the count kernel's µs a launch by batch size
                       "count_us_by_Q": {
                           q: kernel_split(lambda q=q: whole(q), 5, kinds)[0][
                               "count_us"]
                           for q in sorted({c["cids"].shape[0]
                                            for c in group})}}
                if variant == "capped fill":
                    row["cap"] = cap
                if variant == "engine":
                    outs = [t for o in whole() for t in
                            (o if isinstance(o, tuple) else (o,))]
                    row["device_ms_pass"] = sum(
                        device_ms(lambda c=c, x=x, fn=fn: fn(c, *x), reps)
                        for c, x in zip(group, ins))
                    row["hash"] = _digest([torch.cat([o.reshape(-1).float()
                                                      for o in outs])],
                                          ("outputs",))
                print(json.dumps(row), flush=True)
        del variants
        torch.cuda.empty_cache()


_PQ_KINDS = {"scan_us": ("pq_scan_kernel",), "topk_us": ("pq_topk_kernel",),
             "merge_us": ("pq_merge_kernel",), "sort_us": ("ort",)}


def _pq_route(ops, lut, codes, valid, cids, k, metric, probe_ok=None,
              base=None):
    """Tier H's top-k as this tree runs it: ``ops.masked_adc_topk_scan``
    where the tree has it, else the route before it (the scores, the
    offset add, a stable sort of the negated (l2) or plain (ip) scores, a
    slice). Returns (the call, the route's name)."""
    if hasattr(ops, "masked_adc_topk_scan"):
        return (lambda: ops.masked_adc_topk_scan(
            lut, codes, valid, cids, k, metric=metric, probe_ok=probe_ok,
            probe_base=base), "select + merge kernels")

    def fn():
        sc = ops.masked_adc_scan(lut, codes, valid, cids, metric=metric,
                                 probe_ok=probe_ok)
        if base is not None:
            sc = sc + base[..., None]
        sc = sc.reshape(sc.shape[0], -1)
        vals, pos = torch.sort(sc if metric == "ip" else -sc, dim=1,
                               descending=True, stable=True)
        vals = vals[:, :k]
        return (vals if metric == "ip" else -vals), pos[:, :k]
    return fn, "scores kernel + add + sort(stable) + slice"


def _pq_row(fn, reps: int) -> dict:
    """Device ms, the kernels' µs by kind (the sorts summed over a call),
    kernels a call and a hash of the outputs of one tier-H call."""
    outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    us, n, n_kernels = kernel_split(fn, reps, _PQ_KINDS)
    if us["sort_us"] is not None:
        us["sort_us"] *= n["sort_us"]
    return {"device_ms": device_ms(fn, reps), **us, "kernels": n_kernels,
            "hash": _digest(outs, ("values", "positions")
                            if len(outs) == 2 else ("scores",))}


def pq_scan_rows(card: str, label: str, reps: int) -> None:
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    n_probe, p, e, n_clusters = 16, 3912, 256, 1024
    # (Q, valid layout, LUT kind, codes, probe 0 only, k values), at both
    # metrics; "bank-spread" codes have as low 5 bits the lane that reads
    # them (point p's lane is p mod 32): no LUT load conflicts, a
    # yardstick of what the conflicts of random codes cost
    configs = [(128, "random", "random", "random", False, (100, 10)),
               (32, "random", "random", "random", False, (100,)),
               (8, "random", "random", "random", False, (100,)),
               (128, "packed", "random", "random", False, (100,)),
               (128, "few", "random", "random", False, (100,)),
               (128, "random", "integer", "random", False, (100,)),
               (128, "random", "random", "random", True, (100,)),
               (128, "random", "random", "bank-spread", False, (100,)),
               (128, "packed", "random", "bank-spread", False, (100,))]
    for metric, s in (("l2", 48), ("ip", 100)):
        lane = torch.arange(p, device=dev)[None, :, None] % 32
        codes = {"random": torch.randint(0, e, (n_clusters, p, s),
                                         generator=gen, device=dev,
                                         dtype=torch.uint8),
                 "bank-spread": (torch.randint(0, 8, (n_clusters, p, s),
                                               generator=gen, device=dev)
                                 * 32 + lane).to(torch.uint8)}
        fill = torch.randint(700, 1255, (n_clusters, 1), generator=gen,
                             device=dev)
        u = torch.rand((n_clusters, p), generator=gen, device=dev)
        valids = {"random": u < 0.25, "few": u < 0.001,
                  "packed": torch.arange(p, device=dev)[None, :] < fill}
        for q, layout, lut_kind, code_kind, pruned, ks in configs:
            shp = (q, n_probe, s, e)
            if lut_kind == "integer":
                lut = torch.randint(0, 3, shp, generator=gen,
                                    device=dev).float()
            elif metric == "l2":
                lut = torch.rand(shp, generator=gen, device=dev) * 4.0
            else:
                lut = torch.randn(shp, generator=gen, device=dev)
            base = (torch.randn((q, n_probe), generator=gen, device=dev)
                    if metric == "ip" else None)
            cids = torch.stack([torch.randperm(n_clusters, generator=gen,
                                               device=dev)[:n_probe]
                                for _ in range(q)])
            pok = None
            if pruned:
                pok = torch.zeros((q, n_probe), dtype=torch.bool, device=dev)
                pok[:, 0] = True
            c, v = codes[code_kind], valids[layout]
            info = {"label": label, "metric": metric, "Q": q, "np": n_probe,
                    "P": p, "S": s, "E": e, "valid": layout, "lut": lut_kind,
                    "codes": code_kind, "pruned": pruned, "card": card}
            scores = lambda lut=lut, c=c, v=v, cids=cids, pok=pok: \
                ops.masked_adc_scan(lut, c, v, cids, metric=metric,
                                    probe_ok=pok)
            print(json.dumps({"what": "scores", "route": "scores kernel",
                              **info, **_pq_row(scores, reps)}), flush=True)
            for k in ks:
                fn, route = _pq_route(ops, lut, c, v, cids, k, metric,
                                      pok, base)
                print(json.dumps({"what": "top-k", "route": route, "k": k,
                                  **info, **_pq_row(fn, reps)}), flush=True)
            del lut, cids
        del codes, valids
        torch.cuda.empty_cache()


def pq_scan_calls(card: str, label: str, reps: int, path: str) -> None:
    """Replay one engine pass's recorded ``masked_adc_topk_scan`` calls
    (``chip_smoke.py --hit-calls``, tier H of the unfused scan engine)
    through this tree's tier-H route, and its scores-only kernel alone:
    the kernels' ms over the pass by kind, kernels a pass, the summed
    device ms of the calls and a hash of every output."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    rec = torch.load(path)
    codes, valid = rec["codes"].to(dev), rec["valid"].to(dev)
    calls = [{k: (v.to(dev) if torch.is_tensor(v) else v)
              for k, v in c.items()} for c in rec["calls"]]
    fns = {"top-k": [_pq_route(ops, c["lut"], codes, valid, c["cids"],
                               c["k"], c["metric"], c["probe_ok"],
                               c["probe_base"]) for c in calls],
           "scores": [(lambda c=c: ops.masked_adc_scan(
               c["lut"], codes, valid, c["cids"], metric=c["metric"],
               probe_ok=c["probe_ok"]), "scores kernel") for c in calls]}
    for what, pairs in fns.items():
        def whole(pairs=pairs):
            return [fn() for fn, _ in pairs]
        us, n, n_kernels = kernel_split(whole, 5, _PQ_KINDS)
        outs = [t for o in whole() for t in
                (o if isinstance(o, tuple) else (o,))]
        print(json.dumps({
            "label": label, "what": what, "tier": "H", "route": pairs[0][1],
            "calls": len(calls), "np": calls[0]["cids"].shape[1],
            "Q": dict(collections.Counter(c["cids"].shape[0] for c in calls)),
            "k": sorted({c["k"] for c in calls}),
            # kernel ms over the pass, by kind
            **{k.replace("_us", "_ms_pass"):
               None if us[k] is None else us[k] * n[k] / 1e3
               for k in _PQ_KINDS},
            "kernels_a_pass": n_kernels,
            "device_ms_pass": sum(device_ms(fn, reps) for fn, _ in pairs),
            "hash": _digest([torch.cat([o.reshape(-1).float()
                                        for o in outs])], ("outputs",)),
            "card": card}), flush=True)
        del outs
    torch.cuda.empty_cache()


#: where each phase's stamp goes in the kernel source: (anchor, stamp
#: inserted before it); phase k ends at stamp k
_PHASES = (
    ("main loop", "  if (!kTopk) {\n"),
    ("sort and fold the tile", "  u64* mine = scratch + ((row0 + row) * n_ct + blockIdx.x) * KP;"),
    ("store the tile's best", "  if (!last_of_row_tile(counters)) return;"),
    ("__threadfence", "  __syncthreads();\n  if (threadIdx.x == 0)\n    is_last ="),
    ("atomicAdd and barrier", "  if (is_last) __threadfence();"),
    ("merge: fence, start the lists' loads", "  fold_lanes<KP, 1>(a);\n#pragma unroll\n  for (int p = 0; p < KP; ++p) {\n    if (p % 8"),
    ("merge: fold (waiting on the loads), write", "  if (threadIdx.x == 0) counters[blockIdx.y] = 0;\n}\n\n// For each"),
)


def phase_sweep(card: str) -> None:
    import ctypes
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels import ivf_filter as ivff
    src = (_build.CSRC / "ivf_filter.cu").read_text()
    src = src.replace('#include "scan_common.cuh"', (
        f'#include "{_build.CSRC / "scan_common.cuh"}"\n'
        "__device__ unsigned long long g_st[1 << 16];\n"
        "#define STAMP(k) do { if (threadIdx.x == 0) g_st[((blockIdx.y * "
        "gridDim.x + blockIdx.x) * 8 + (k)) & 0xffff] = clock64(); } "
        "while (0)\n"))
    src = src.replace("  extern __shared__ __align__(16) float smem[];\n",
                      "  extern __shared__ __align__(16) float smem[];\n"
                      "  STAMP(0);\n", 1)
    for k, (_, anchor) in enumerate(_PHASES, 1):
        if anchor not in src:
            raise RuntimeError(f"phase anchor not found: {anchor!r}")
        at = src.index(anchor)
        src = src[:at] + f"  STAMP({k});\n" + src[at:]
    src += ("\nextern \"C\" int read_stamps(void* dst, int n) {\n"
            "  return (int)cudaMemcpyFromSymbol(dst, g_st, 8 * n);\n}\n"
            "extern \"C\" int clear_stamps() {\n  void* p;\n"
            "  cudaGetSymbolAddress(&p, g_st);\n"
            "  return (int)cudaMemset(p, 0, 8 << 16);\n}\n")
    diag = _build.BUILD_DIR.parent / "diag"
    diag.mkdir(parents=True, exist_ok=True)
    (diag / "ivf_filter_phases.cu").write_text(src)
    so = diag / "libivf_filter_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(diag / "ivf_filter_phases.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    _build.library = lambda name: lib
    ivff._topk_launcher.cache_clear()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for q, c, d, nprobe in ((128, 1024, 96, 1), (128, 1024, 96, 8),
                            (128, 1024, 96, 16), (128, 1024, 96, 32),
                            (128, 1024, 200, 16), (1000, 1024, 96, 1)):
        x = torch.randn((q, d), generator=gen, device=dev)
        y = torch.randn((c, d), generator=gen, device=dev)
        csq = torch.sum(y * y, -1)
        for _ in range(3):
            ivff.ivf_filter_topk(x, y, csq, nprobe=nprobe)
        torch.cuda.synchronize()
        lib.clear_stamps()
        ivff.ivf_filter_topk(x, y, csq, nprobe=nprobe)
        torch.cuda.synchronize()
        n_blocks = -(-c // 128) * -(-q // 8)
        st = np.zeros(n_blocks * 8, np.uint64)
        lib.read_stamps(st.ctypes.data_as(ctypes.c_void_p), n_blocks * 8)
        st = st.reshape(n_blocks, 8).astype(np.int64)
        merged = st[:, 7] > 0
        phases = {}
        for k, (name, _) in enumerate(_PHASES, 1):
            rows = st[merged] if k >= 6 else st
            phases[name] = int(np.median(rows[:, k] - rows[:, k - 1]))
        print(json.dumps({"Q": q, "C": c, "D": d, "nprobe": nprobe,
                          "metric": "l2", "cycles": phases,
                          "blocks_merged": int(merged.sum()),
                          "cycles_to_end_merged": int(np.median(
                              st[merged, 7] - st[merged, 0])),
                          "card": card}), flush=True)


def sphere_rows(card: str, label: str, reps: int) -> None:
    """The rt search's probe mask, ``core/juno.py:_rt_probe_mask``, as the
    scans' rt path calls it, on a synthetic 16×16-cell grid with every
    real slot one cluster's: device and host ms a call, kernels and host
    copies a call (profiler), and a hash of ``probe_ok``; on a tree with
    the probe entry (``ops.rt_probe_mask``) also the probe kernel's own µs
    and that of an empty kernel on its grid (the launch floor), beside
    ``ops.rt_probe_mask``'s device ms. A tree without the entry runs its
    own route (``query_radius``, the dense table, the gathers)."""
    import hashlib

    import numpy as np
    from repro_torch.core.juno import _rt_probe_mask
    from repro_torch.kernels import ops
    from repro_torch.kernels import sphere_hits as sph
    from repro_torch.rt import grid_from_arrays
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    for q, n_probe, s, cap, d in ((128, 16, 48, 88, 96), (128, 8, 100, 176, 200),
                                  (32, 16, 48, 88, 96), (8, 16, 48, 88, 96)):
        c0, c1, reach, real = _grid(16, cap, gen)
        slot_of = real[torch.randperm(real.numel(), generator=gen,
                                      device=dev)].to(torch.int32)
        proj = np.ascontiguousarray(np.linalg.qr(np.random.default_rng(d)
                                                 .standard_normal((d, 2)))[0],
                                    np.float32)
        host = lambda t: t.cpu().numpy()  # noqa: E731
        grid = grid_from_arrays(dict(
            proj=proj, lo=np.zeros(2, np.float32), hi=np.ones(2, np.float32),
            boxes=np.zeros((256, 4), np.float32),
            cell_ids=np.full((256, cap), -1, np.int32), cell_c0=host(c0),
            cell_c1=host(c1), slot_reach=host(reach),
            cell_reach=host(reach).max(1), slot_of=host(slot_of),
            radius_scale=np.float32((2.0 / d) ** 0.5),
            radius_bias=np.float32(-0.02)), dev, prefix="")
        x = torch.randn((q, d), generator=gen, device=dev) * 0.3
        tau = torch.rand((q, n_probe, s), generator=gen, device=dev) * 0.05
        cids = torch.randint(0, real.numel(), (q, n_probe), generator=gen,
                             device=dev)

        def fn():
            return _rt_probe_mask(grid, x, tau, cids, 1.0)

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        copies = sum(ev.count for ev in evs if "Memcpy" in ev.key)
        row = {"label": label, "what": "_rt_probe_mask", "Q": q,
               "np": n_probe, "S": s, "cap": cap, "D": d,
               "device_ms": device_ms(fn, reps), "host_ms": host_ms(fn, reps),
               "kernels": sum(ev.count for ev in evs) - copies,
               "host_copies": copies,
               "probe_ok": hashlib.sha256(fn().cpu().numpy().tobytes())
               .hexdigest()[:16], "card": card}
        if hasattr(ops, "rt_probe_mask"):
            qp = x @ grid.proj
            args = (qp[:, 0], qp[:, 1], tau[:, 0], cids, grid.slot_of,
                    grid.cell_c0, grid.cell_c1, grid.slot_reach,
                    grid.radius_scale, grid.radius_bias)
            probe = lambda: ops.rt_probe_mask(*args)  # noqa: E731
            row.update(
                probe_device_ms=device_ms(probe, reps),
                probe_kernel_us=kernel_us(probe, reps, "sphere_probe_kernel"),
                floor_kernel_us=kernel_us(lambda: sph.sphere_floor(q, dev),
                                          reps, "sphere_floor_kernel"),
                floor_device_ms=device_ms(lambda: sph.sphere_floor(q, dev),
                                          reps))
        print(json.dumps(row), flush=True)
    # the projection onto the ray plane in two forms: the (Q, D) × (D, 2)
    # product, and Q products (1, D) × (D, 2) as ``_rt_probe`` takes it
    for d in (96, 200):
        proj = torch.linalg.qr(torch.randn((d, 2), generator=gen,
                                           device=dev))[0].contiguous()
        for q in (8, 32, 128, 1024):
            x = torch.randn((q, d), generator=gen, device=dev)
            forms = {"mm": lambda: x @ proj,
                     "bmm": lambda: torch.bmm(
                         x[:, None, :], proj.expand(q, -1, -1))[:, 0]}
            for form, fn in forms.items():
                print(json.dumps({
                    "label": label, "what": "projection", "form": form,
                    "Q": q, "D": d, "device_ms": device_ms(fn, reps),
                    "kernels": kernels_of(fn)[0],
                    "equal_to_mm": torch.equal(fn(), forms["mm"]()),
                    "card": card}), flush=True)


#: kernel kinds of ``--traces``, by a substring of the kernel's name
_KINDS = (("stage A (ivf_filter)", "ivf_filter"),
          ("radixSortKVInPlace", "radixSortKVInPlace"),
          ("other sorts", "ort"), ("stage B (selective_lut)", "selective_lut"),
          ("hit_count", "hit_count_kernel"), ("hit_count top-k", "hit_topk_kernel"),
          ("two-stage count", "count_kernel"), ("two-stage select", "select_kernel"),
          ("pq_scan", "pq_scan"), ("pq_scan top-k select", "pq_topk_kernel"),
          ("pq_scan top-k merge", "pq_merge_kernel"),
          ("rt probe mask (sphere_probe)", "sphere_probe_kernel"),
          ("rt dense table (sphere_hits)", "sphere_hits_kernel"))
#: the scans' first kernels: the end of ``--traces``' stage-B-to-scan
#: segment (``hit_count_kernel`` and the fused scans' ``count_kernel``
#: both hold ``count_kernel``)
_SCANS = ("pq_topk_kernel", "pq_scan_kernel", "count_kernel")


def trace_kinds(paths: list[str]) -> None:
    for path in paths:
        with gzip.open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("cat") == "kernel" and e.get("ph") == "X"]
        ms, n = collections.Counter(), collections.Counter()
        for e in events:
            kind = next((k for k, sub in _KINDS if sub in e["name"]), "rest")
            ms[kind] += e["dur"] / 1e3
            n[kind] += 1
        print(json.dumps({"trace": path, "kernels": len(events),
                          "device_ms": sum(ms.values()),
                          "kinds": {k: {"ms": ms[k], "launches": n[k]}
                                    for k in sorted(ms)},
                          "stage_b_to_scan": b_to_scan(events)}), flush=True)


def b_to_scan(events: list[dict]) -> dict:
    """The kernels on the stream between each stage-B launch and the next
    scan kernel (the rt probe mask's, and tier L's clip): their number a
    segment (median, min, max) and their device ms summed over the pass."""
    events = sorted(events, key=lambda e: e["ts"])
    counts, total = [], 0.0
    for i, e in enumerate(events):
        if "selective_lut" not in e["name"]:
            continue
        j = i + 1
        while j < len(events) and not any(k in events[j]["name"]
                                          for k in _SCANS):
            j += 1
        if j == len(events):
            continue
        counts.append(j - i - 1)
        total += sum(ev["dur"] for ev in events[i + 1:j]) / 1e3
    return {"segments": len(counts),
            "kernels_median": statistics.median(counts) if counts else None,
            "kernels_min": min(counts, default=None),
            "kernels_max": max(counts, default=None), "ms": total}


def build_seconds(card: str, label: str) -> None:
    """Each kernel source of the tree compiled alone, one at a time: the
    seconds of its ``nvcc``."""
    import tempfile
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            os.path.join(tmp, f"lib{name}.so"),
                            str(_build.CSRC / f"{name}.cu")],
                           check=True, capture_output=True, timeout=600)
            secs = time.perf_counter() - t0
        print(json.dumps({"label": label, "what": "nvcc", "source": name,
                          "seconds": secs, "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--stage-b", action="store_true",
                    help="time stage B (selective_lut) of this tree instead")
    ap.add_argument("--stage-c", action="store_true",
                    help="time stage C's fused scans of this tree instead")
    ap.add_argument("--hit-count", action="store_true",
                    help="time tiers M/L and composed H2's hit-count scan "
                         "of this tree instead")
    ap.add_argument("--pq-scan", action="store_true",
                    help="time tier H's scan and its top-k of this tree "
                         "instead")
    ap.add_argument("--sphere", action="store_true",
                    help="time the rt search's probe mask of this tree "
                         "instead")
    ap.add_argument("--build", action="store_true",
                    help="time each kernel source's nvcc build of this tree "
                         "instead")
    ap.add_argument("--calls", metavar="FILE",
                    help="with --hit-count or --pq-scan: replay the engine "
                         "calls that chip_smoke.py --hit-calls wrote "
                         "instead")
    ap.add_argument("--kernels", action="store_true",
                    help="sweep the ivf_filter kernel's epilogues instead")
    ap.add_argument("--phases", action="store_true",
                    help="clock the top-nprobe epilogue's phases instead")
    ap.add_argument("--traces", nargs="+", metavar="TRACE",
                    help="sum chip_smoke.py's gzipped traces by kernel kind")
    args = ap.parse_args()
    if args.traces:
        trace_kinds(args.traces)
        return 0
    if not torch.cuda.is_available():
        print("bench_stage_a: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.ivf import IVFIndex, filter_clusters
    from repro_torch.core.juno import _label_encode
    from repro_torch.core.pq import PQCodebook
    from repro_torch.kernels import _build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    if args.build:
        build_seconds(card, args.label)
        return 0
    _build.build_all()
    if args.stage_b:
        stage_b(card, args.label, args.reps)
        return 0
    if args.stage_c:
        stage_c(card, args.label, args.reps)
        return 0
    if args.hit_count:
        if args.calls:
            hit_count_calls(card, args.label, args.reps, args.calls)
        else:
            hit_count_rows(card, args.label, args.reps)
        return 0
    if args.pq_scan:
        if args.calls:
            pq_scan_calls(card, args.label, args.reps, args.calls)
        else:
            pq_scan_rows(card, args.label, args.reps)
        return 0
    if args.sphere:
        sphere_rows(card, args.label, args.reps)
        return 0
    if args.kernels:
        kernel_sweep(card, args.reps)
        return 0
    if args.phases:
        phase_sweep(card)
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    c = 1024

    def index(d):
        cent = torch.randn((c, d), generator=gen, device=dev)
        none = torch.zeros((c, 1), device=dev)
        return IVFIndex(cent, torch.sum(cent * cent, -1), none.int(),
                        none.bool(), none.int()[:, 0])

    cases = []
    for d, metric in ((96, "l2"), (200, "ip")):
        ivf = index(d)
        q = torch.randn((128, d), generator=gen, device=dev)
        for nprobe in (8, 16, 32):
            cases.append((dict(what="filter_clusters", Q=128, C=c, D=d,
                               metric=metric, nprobe=nprobe),
                          lambda ivf=ivf, q=q, m=metric, n=nprobe:
                          filter_clusters(q, ivf, nprobe=n, metric=m)))
    ivf = index(96)
    pts = torch.randn((1000, 96), generator=gen, device=dev)
    entries = torch.randn((48, 256, 2), generator=gen, device=dev)
    book = PQCodebook(entries, torch.sum(entries * entries, -1))
    cases.append((dict(what="_label_encode", Q=1000, C=c, D=96, metric="l2",
                       nprobe=1, S=48, E=256),
                  lambda: _label_encode(pts, ivf, book)))
    for info, fn in cases:
        n, sorts = kernels_of(fn)
        print(json.dumps({"label": args.label, **info,
                          "device_ms": device_ms(fn, args.reps),
                          "host_ms": host_ms(fn, args.reps),
                          "kernels": n, "sorts": sorts, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
