#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of JUNO (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each raising on failure:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — all four CUDA kernels compiled from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``, in
   parallel;
3. kernels — each kernel against its plain PyTorch version on the card at
   the main paths' shapes (LUT, hit table, counts and candidates equal;
   ADC sums within 1e-5 of the sum of their terms' magnitudes), timed
   with CUDA events (median of 20) beside the plain version, one PyTorch
   call that computes the same sums where there is one, and the least
   time the card could take; plus the stage-A GEMM (``ivf_filter``, not
   ported) against ``torch.addmm``;
4. l2 serving — a 1M-point DEEP-like index (D=96, S=48, E=256, C=1024)
   built on the card and served by two engines, ``fused=True`` and the
   default ``fused=False``, on a stream of ≥ 64 requests that routes to
   tiers H, H2, M and L: each engine's kernel launches over one pass,
   QPS, latency and signatures; then per tier (H, fused H2, composed H2,
   M, L) recall@10-in-100 against ``exact_topk`` and QPS, composed H2
   against fused H2 at the same rerank (ids equal up to score ties), and
   the ids of 32 queries against the same search on the CPU (plain
   versions);
5. ip serving — the same with a 1M-point TTI-like index (D=200, S=100);
6. the kernel line, then the card line, then the result line.

It needs a CUDA card and the repo's ``src/``; without either it exits
non-zero before printing any result. Detailed numbers (``chip_smoke.json``),
the compiler's register report and the profiler traces go to ``--out``
(default ``build/chip_smoke/``).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.core import (JunoConfig, build, exact_topk,  # noqa: E402
                              index_to, recall_n_at_k, search)
from repro_torch.data import DEEP_LIKE, TTI_LIKE, make_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_two_stage as fts  # noqa: E402
from repro_torch.kernels import hit_count as hc  # noqa: E402
from repro_torch.kernels import pq_scan as pqs  # noqa: E402
from repro_torch.kernels import selective_lut as slut  # noqa: E402
from repro_torch.kernels.ref import NEG  # noqa: E402
from repro_torch.serve.ann import AnnServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 rate outside the tensor cores
RTOL = 1e-5                    # f32 sums over S in another order
N_POINTS = 1_000_000
SOURCES = {
    "selective_lut": ("src/repro_torch/kernels/csrc/selective_lut.cu",
                      "src/repro/kernels/selective_lut.py:80"),
    "fused_two_stage": ("src/repro_torch/kernels/csrc/fused_two_stage.cu",
                        "src/repro/kernels/fused_two_stage.py:182"),
    "pq_scan": ("src/repro_torch/kernels/csrc/pq_scan.cu",
                "src/repro/kernels/pq_scan.py:41"),
    "hit_count": ("src/repro_torch/kernels/csrc/hit_count.cu",
                  "src/repro/kernels/hit_count.py:36"),
}
# the kernels each engine configuration must launch (and must not)
ENGINE_KERNELS = {
    True: ({"selective_lut", "fused_two_stage", "hit_count"}, {"pq_scan"}),
    False: ({"selective_lut", "pq_scan", "hit_count"}, {"fused_two_stage"}),
}
# the tiers whose recall and QPS are read, as search() arguments (k=100)
TIERS = {
    "H": dict(mode="H", nprobe=16),
    "H2_fused": dict(mode="H2", fused=True, nprobe=16,
                     rerank=AnnServeEngine.FUSED_RERANK_MULT * 100),
    "H2_composed": dict(mode="H2", nprobe=16),
    "M": dict(mode="M", nprobe=8),
    "L": dict(mode="L", nprobe=8),
}


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events).

    Before each call the stream sleeps ~1 ms so the host has enqueued the
    whole call before the start event fires: the events then bracket
    device work only, not the host's launch overhead.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def profile_window(fn, trace_path: str) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``).

    Returns the window's host wall time, the summed device time of its
    kernels and copies, the idle share ``1 - busy / wall`` and the top
    kernels by device time; the Chrome trace goes to ``trace_path``.
    The profiler adds host time of its own, so ``wall`` (and the idle
    share) is an upper bound of the unprofiled run's.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels[ev.key] = (kernels.get(ev.key, (0.0, 0))[0] + us / 1e3,
                               ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3) if kernels else None,
            "top": [{"kernel": k[:120], "ms": ms, "count": n}
                    for k, (ms, n) in top]}


def phase_device() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log("device", **info)
    return info


def phase_build(out_dir: str) -> None:
    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
        for name, out in reports.items():
            fh.write(f"== {name}\n{out}\n")
    regs = [ln.strip() for out in reports.values() for ln in out.splitlines()
            if "registers" in ln]
    log("build", seconds=secs, ptxas=regs)


def check_selective_lut(metric: str, b: int, s: int, e: int, gen) -> dict:
    dev = torch.device("cuda")
    q = torch.randn((2, b, s), generator=gen, device=dev) * 0.5
    ent = torch.randn((2, s, e), generator=gen, device=dev) * 0.5
    esq = ent[0] * ent[0] + ent[1] * ent[1]
    tau = torch.rand((b, s), generator=gen, device=dev) * 0.8
    args = (q[0].contiguous(), q[1].contiguous(), ent[0].contiguous(),
            ent[1].contiguous(), esq, tau)
    lut_k, hit_k = slut.selective_lut(*args, metric=metric)
    lut_p, hit_p = slut.selective_lut_plain(*args, metric=metric)
    torch.cuda.synchronize()
    if not (torch.equal(hit_k, hit_p) and torch.equal(lut_k, lut_p)):
        raise AssertionError(f"selective_lut {metric} S={s}: kernel != plain "
                             f"({int((hit_k != hit_p).sum())} hit, "
                             f"{int((lut_k != lut_p).sum())} lut entries)")
    n_bytes = 4 * (3 * b * s + 3 * s * e) + 5 * b * s * e
    bnd, by = bound_ms(n_bytes, 12 * b * s * e)
    return {"metric": metric, "B": b, "S": s, "E": e,
            "max_abs_err": float((lut_k - lut_p).abs().max()),
            "ms": time_ms(lambda: slut.selective_lut(*args, metric=metric)),
            "plain_ms": time_ms(
                lambda: slut.selective_lut_plain(*args, metric=metric)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "bytes": n_bytes}


def _assert_sums_close(got: torch.Tensor, want: torch.Tensor,
                       scale: torch.Tensor, what: str) -> float:
    """``got`` equals ``want`` where ``want`` is ±inf and lies within
    ``RTOL * scale`` of it elsewhere, ``scale`` being the sum of the
    terms' magnitudes (an f32 sum over S in another order differs by at
    most ~S·ulp of that; for non-negative terms it is rtol 1e-5).
    Returns the largest absolute difference."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or \
            not torch.equal(got[~fin], want[~fin]):
        raise AssertionError(f"{what}: ±inf placement differs from plain")
    if not fin.any():
        return 0.0
    err = (got - want)[fin].abs()
    if (err > RTOL * scale[fin]).any():
        raise AssertionError(f"{what}: {int((err > RTOL * scale[fin]).sum())} "
                             f"sums beyond rtol {RTOL} of their terms")
    return float(err.max())


def _scan_index(q: int, n_probe: int, p: int, s: int, e: int,
                n_clusters: int, gen):
    """Random per-cluster codes, a ~25%-filled valid mask (as a 1M-point,
    1024-cluster index has) and random probed cluster ids, on the card.
    Also returns the bytes of what the scans must read of them: each
    distinct probed cluster's valid row and its valid points' codes."""
    dev = torch.device("cuda")
    codes = torch.randint(0, e, (n_clusters, p, s), generator=gen, device=dev,
                          dtype=torch.uint8)
    valid = torch.rand((n_clusters, p), generator=gen, device=dev) < 0.25
    cids = torch.stack([torch.randperm(n_clusters, generator=gen, device=dev)
                        [:n_probe] for _ in range(q)])
    rows = torch.unique(cids)
    n_valid = int(valid[rows].sum())
    return codes, valid, cids, {"distinct_clusters": int(rows.numel()),
                                "valid_points": n_valid,
                                "index_bytes": rows.numel() * p + n_valid * s}


def _lut(q: int, n_probe: int, s: int, e: int, metric: str, gen):
    dev = torch.device("cuda")
    if metric == "l2":
        # non-negative entries, as an l2 LUT holds
        return torch.rand((q, n_probe, s, e), generator=gen, device=dev) * 4.0
    # signed similarities, as an ip LUT holds: the sums may cancel
    return torch.randn((q, n_probe, s, e), generator=gen, device=dev)


def _bag_call(tab: torch.Tensor, codes: torch.Tensor, cids: torch.Tensor):
    """The library yardstick of a per-point table scan: one
    ``embedding_bag(mode="sum")`` over the flat table with precomputed
    offsets ((q·np + probe)·S + s)·E + code, one bag per probed point —
    the same sums, less the valid mask. Returns the call."""
    q, n_probe, s, e = tab.shape
    base = (torch.arange(q * n_probe, device=tab.device, dtype=torch.int32)
            .reshape(q, n_probe, 1, 1) * s
            + torch.arange(s, device=tab.device, dtype=torch.int32)) * e
    idx = (codes[cids].to(torch.int32) + base).reshape(-1, s)
    weight = tab.float().reshape(-1, 1)
    return lambda: torch.nn.functional.embedding_bag(idx, weight, mode="sum")


def check_fused_two_stage(q: int, n_probe: int, p: int, s: int, e: int,
                          n_clusters: int, cap_c: int, metric: str,
                          gen) -> dict:
    lut = _lut(q, n_probe, s, e, metric, gen)
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                          device=lut.device, dtype=torch.int8)
    codes, valid, cids, need = _scan_index(q, n_probe, p, s, e, n_clusters,
                                           gen)
    kw = dict(cap_c=cap_c, metric=metric)
    got = fts.fused_two_stage(lut, table, codes, valid, cids, **kw)
    want = fts.fused_two_stage_plain(lut, table, codes[cids], valid[cids], **kw)
    # Σ|terms| at the same candidates (counts and cand do not read the LUT)
    scale = fts.fused_two_stage_plain(lut.abs(), table, codes[cids],
                                      valid[cids], **kw)
    torch.cuda.synchronize()
    what = f"fused_two_stage {metric} S={s} C={cap_c}"
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
        raise AssertionError(f"{what}: counts or cand differ from plain")
    err = _assert_sums_close(got[3], want[3], scale[3], what + " cand_dist")
    _assert_sums_close(got[1], want[1], scale[1], what + " dist")
    # bytes the work needs: the probed clusters' valid rows and valid
    # points' codes once, the int8 tables, the LUT at the C candidates
    # only, the outputs once
    w = n_probe * p
    n_bytes = (need["index_bytes"] + table.numel() + q * cap_c * s * 4
               + cids.numel() * 8 + q * w * 8 + q * cap_c * 8)
    bnd, by = bound_ms(n_bytes, int(valid[cids].sum()) * s + q * cap_c * s)
    return {"metric": metric, "Q": q, "np": n_probe, "P": p, "S": s, "E": e,
            "C": cap_c, "max_abs_err": err,
            "ms": time_ms(lambda: fts.fused_two_stage(
                lut, table, codes, valid, cids, **kw)),
            "plain_ms": time_ms(lambda: fts.fused_two_stage_plain(
                lut, table, codes[cids], valid[cids], **kw)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "bytes": n_bytes, **need}


def check_hit_count(q: int, n_probe: int, p: int, s: int, e: int,
                    n_clusters: int, label: str, gen) -> dict:
    dev = torch.device("cuda")
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                          device=dev, dtype=torch.int8)
    codes, valid, cids, need = _scan_index(q, n_probe, p, s, e, n_clusters,
                                           gen)
    got = hc.hit_count(table, codes, valid, cids)
    want = hc.hit_count_plain(table, codes[cids], valid[cids])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"hit_count {label} S={s} np={n_probe}: "
                             f"{int((got != want).sum())} counts differ")
    lib = _bag_call(table, codes, cids)
    lib_out = lib().reshape(q, n_probe, p)
    if not torch.equal(lib_out[want != NEG].to(torch.int32),
                       want[want != NEG]):
        raise AssertionError(f"hit_count {label}: the embedding_bag yardstick "
                             f"computes other sums")
    # bytes: valid rows + valid codes, the int8 tables, cids, int32 output
    n_bytes = need["index_bytes"] + table.numel() + cids.numel() * 8 \
        + 4 * got.numel()
    bnd, by = bound_ms(n_bytes, int(valid[cids].sum()) * s)
    out = {"tier": label, "Q": q, "np": n_probe, "P": p, "S": s, "E": e,
           "max_abs_err": 0.0,
           "ms": time_ms(lambda: hc.hit_count(table, codes, valid, cids)),
           "plain_ms": time_ms(lambda: hc.hit_count_plain(
               table, codes[cids], valid[cids])),
           "library_ms": time_ms(lib),
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes, **need}
    del lib
    return out


def check_pq_scan(q: int, n_probe: int, p: int, s: int, e: int,
                  n_clusters: int, metric: str, gen) -> dict:
    lut = _lut(q, n_probe, s, e, metric, gen)
    codes, valid, cids, need = _scan_index(q, n_probe, p, s, e, n_clusters,
                                           gen)
    got = pqs.pq_scan(lut, codes, valid, cids, metric=metric)
    want = pqs.pq_scan_plain(lut, codes[cids], valid[cids], metric=metric)
    scale = pqs.pq_scan_plain(lut.abs(), codes[cids], valid[cids])
    torch.cuda.synchronize()
    what = f"pq_scan {metric} S={s}"
    err = _assert_sums_close(got, want, scale, what)
    lib = _bag_call(lut, codes, cids)
    fin = torch.isfinite(want)
    _assert_sums_close(lib().reshape(q, n_probe, p)[fin], want[fin],
                       scale[fin], what + " embedding_bag yardstick")
    # bytes: valid rows + valid codes, the f32 LUTs, cids, f32 output
    n_bytes = need["index_bytes"] + 4 * lut.numel() + cids.numel() * 8 \
        + 4 * got.numel()
    bnd, by = bound_ms(n_bytes, int(valid[cids].sum()) * s)
    out = {"metric": metric, "Q": q, "np": n_probe, "P": p, "S": s, "E": e,
           "max_abs_err": err,
           "ms": time_ms(lambda: pqs.pq_scan(lut, codes, valid, cids,
                                             metric=metric)),
           "plain_ms": time_ms(lambda: pqs.pq_scan_plain(
               lut, codes[cids], valid[cids], metric=metric)),
           "library_ms": time_ms(lib),
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes, **need}
    del lib
    return out


def check_ivf_filter(q: int, c: int, d: int, gen) -> dict:
    """Stage A's GEMM (the ``ivf_filter`` TPU kernel, not ported): the
    port's plain arithmetic against one ``torch.addmm`` call."""
    dev = torch.device("cuda")
    qs = torch.randn((q, d), generator=gen, device=dev)
    cent = torch.randn((c, d), generator=gen, device=dev)
    csq = torch.sum(cent * cent, dim=-1)

    def plain():
        return csq[None, :] - 2.0 * (qs @ cent.T)

    def library():
        return torch.addmm(csq[None, :], qs, cent.T, alpha=-2.0)

    err = float((plain() - library()).abs().max())
    n_bytes = 4 * (q * d + c * d + c + q * c)
    bnd, by = bound_ms(n_bytes, 2 * q * c * d)
    return {"Q": q, "C": c, "D": d, "max_abs_err": err, "ms": None,
            "plain_ms": time_ms(plain), "library_ms": time_ms(library),
            "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}


def phase_kernels(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"selective_lut": [check_selective_lut("l2", 2048, 48, 256, gen),
                              check_selective_lut("ip", 2048, 48, 256, gen),
                              check_selective_lut("ip", 2048, 100, 256, gen)]}
    rows["fused_two_stage"] = [
        check_fused_two_stage(128, 16, 3912, s, 256, 1024, c, metric, gen)
        for metric, s in (("l2", 48), ("ip", 100)) for c in (320, 3200)]
    rows["pq_scan"] = [check_pq_scan(128, 16, 3912, s, 256, 1024, metric, gen)
                       for metric, s in (("l2", 48), ("ip", 100))]
    torch.cuda.empty_cache()
    rows["hit_count"] = [
        check_hit_count(128, n_probe, 3912, s, 256, 1024, label, gen)
        for label, n_probe, s in (("M/L l2", 8, 48), ("M/L ip", 8, 100),
                                  ("composed H2 l2", 16, 48))]
    torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            log(f"kernel.{name}", **r)
    ivf = [check_ivf_filter(128, 1024, d, gen) for d in (96, 200)]
    for r in ivf:
        log("kernel.ivf_filter", **r)
    return {"kernels": rows, "ivf_filter": ivf}


def _requests(rng, n_queries: int, n_req: int = 64) -> list[dict]:
    """k in {10, 100}; recall targets 0.95 (H), 0.85 (H2), 0.6 (M) and
    0.3 (L), each with both k; 1–200 rows a request."""
    out = []
    for i in range(n_req):
        rows = int(rng.integers(1, 201))
        lo = int(rng.integers(0, n_queries - rows))
        out.append(dict(rows=(lo, lo + rows), k=(10, 100)[i % 2],
                        recall_target=(0.95, 0.85, 0.6, 0.3)[(i // 2) % 4]))
    return out


def check_results(ids, scores, n_points: int, what: str) -> int:
    """Hold one result block to the search's contract: ids lie in
    [0, N) with a finite score, except where the probed clusters held
    fewer than k valid points; such a pad result has id -1 and the
    invalid-slot score (-2^30 as a count, ±inf as a distance or
    similarity), as in the reference. Returns the number of pad results."""
    ids, scores = np.asarray(ids), np.asarray(scores)
    pad = ids < 0
    sentinel = ~np.isfinite(scores) | (scores == NEG)
    if (ids[pad] != -1).any() or (ids >= n_points).any() or \
            (pad != sentinel).any():
        raise AssertionError(
            f"{what}: {int((pad & ~sentinel).sum())} pad ids with a real "
            f"score, {int((sentinel & ~pad).sum())} real ids with a pad "
            f"score, {int((ids >= n_points).sum())} ids >= N")
    return int(pad.sum())


def serve_engine(index, queries, stream, *, metric: str, fused: bool,
                 n_points: int, trace_path: str) -> dict:
    """Warm-up, one pass with the launch counts read, four more timed
    passes and one profiled pass of one engine configuration."""
    def serve() -> tuple[AnnServeEngine, list, float]:
        eng = AnnServeEngine(index, metric=metric, fused=fused)
        reqs = [eng.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                           recall_target=r["recall_target"]) for r in stream]
        t = time.perf_counter()
        eng.run()
        return eng, reqs, time.perf_counter() - t

    serve()                                    # warm-up: cuBLAS, allocator
    _build.reset_launches()
    eng, reqs, t_serve = serve()
    launches = dict(_build.LAUNCHES)
    padded = 0
    for r in reqs:
        if not r.done or r.ids.shape != (r.queries.shape[0], r.k):
            raise AssertionError(f"request {r.rid} not served")
        padded += check_results(r.ids, r.scores, n_points, f"request {r.rid}")
    must, must_not = ENGINE_KERNELS[fused]
    if any(launches[n] <= 0 for n in must) or \
            any(launches[n] != 0 for n in must_not):
        raise AssertionError(f"fused={fused}: launches {launches}, expected "
                             f"{sorted(must)} and not {sorted(must_not)}")
    t_repeats = [t_serve] + [serve()[2] for _ in range(4)]
    prof = profile_window(serve, trace_path)
    rows = eng.stats["queries"]
    return {"fused": fused, "requests": len(reqs), "rows": rows,
            "ticks": eng.stats["ticks"],
            "qps": rows / statistics.median(t_repeats),
            "qps_repeats": [rows / t for t in t_repeats],
            "latency": eng.latency_stats(), "profile": prof,
            "signatures": {str(k): v
                           for k, v in eng.stats["signatures"].items()},
            "tiers": sorted({eng.route(r)[1] for r in reqs}),
            "padded_results": padded, "launches": launches}


def _ids_equal_up_to_ties(ids, ref_ids, scores, ref_scores, what: str,
                          rtol: float = 1e-5, atol: float = 1e-6) -> None:
    """Scores within tolerance; ids equal except inside runs of tied
    reference scores (the rule of the CPU tests' parity helper)."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    scores, ref_scores = np.asarray(scores), np.asarray(ref_scores)
    close = lambda a, b: (a == b) | (np.abs(a - b) <= atol + rtol * np.abs(b))  # noqa: E731
    if not close(scores, ref_scores).all():
        raise AssertionError(f"{what}: scores differ beyond rtol {rtol}")
    tie_prev = np.zeros(ref_scores.shape, bool)
    tie_prev[:, 1:] = close(ref_scores[:, 1:], ref_scores[:, :-1])
    tie_next = np.zeros(ref_scores.shape, bool)
    tie_next[:, :-1] = tie_prev[:, 1:]
    bad = (ids != ref_ids) & ~(tie_prev | tie_next)
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} ids differ outside "
                             f"score ties")


def shared_ids(ids: torch.Tensor, ref_ids: torch.Tensor) -> float:
    """Mean share of each row's ids found in the reference row, counted
    as multisets (a row may repeat the pad id -1)."""
    return float(np.mean([
        sum((collections.Counter(a.tolist())
             & collections.Counter(b.tolist())).values()) / a.numel()
        for a, b in zip(ids, ref_ids)]))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tier_table(index, cpu_index, queries, pts, metric: str) -> dict:
    """Per tier: recall@10-in-100 on 256 queries, QPS of ``search`` over
    1024 (median of three, after a warm-up), and the same 32 queries on
    the CPU (plain versions); composed H2 against fused H2 at one rerank."""
    dev = index.ivf.centroids.device
    q_eval = torch.from_numpy(queries[:1024]).to(dev)
    pts_dev = torch.from_numpy(pts).to(dev)
    _, gt = exact_topk(q_eval[:256], pts_dev, k=10, metric=metric)
    del pts_dev
    out = {}
    for tier, kw in TIERS.items():
        kw = dict(kw, k=100, metric=metric)
        search(index, q_eval, batch=128, **kw)
        times = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            scores, ids = search(index, q_eval, batch=128, **kw)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        padded = check_results(ids.cpu(), scores.cpu(), pts.shape[0], tier)
        ids = ids[:256]
        recall = recall_n_at_k(ids.long(), gt)
        if tier in ("H", "H2_fused", "H2_composed") and recall < 0.2:
            raise AssertionError(f"{tier}: recall@10-in-100 {recall:.4f}")
        _, ids_cpu = search(cpu_index, q_eval[:32].cpu(), batch=8, **kw)
        ids_gpu = ids[:32].cpu()
        same = shared_ids(ids_gpu, ids_cpu)
        r_gpu = recall_n_at_k(ids_gpu.long(), gt[:32].cpu())
        r_cpu = recall_n_at_k(ids_cpu.long(), gt[:32].cpu())
        if same < 0.99 or abs(r_gpu - r_cpu) > 0.01:
            raise AssertionError(f"{tier} GPU vs CPU: {same:.4f} ids shared, "
                                 f"recall {r_gpu:.4f} vs {r_cpu:.4f}")
        out[tier] = {"recall10_at_100": recall,
                     "qps": q_eval.shape[0] / statistics.median(times),
                     "padded_results": padded,
                     "cpu_ids_shared": same, "recall_gpu32": r_gpu,
                     "recall_cpu32": r_cpu, **{k: v for k, v in kw.items()
                                               if k != "metric"}}
    # composed against fused H2 at the fused engine's rerank budget
    kw = dict(TIERS["H2_fused"], k=100, metric=metric)
    s_f, i_f = search(index, q_eval[:256], batch=128, **kw)
    s_c, i_c = search(index, q_eval[:256], batch=128, **dict(kw, fused=False))
    _ids_equal_up_to_ties(i_c.cpu(), i_f.cpu(), s_c.cpu(), s_f.cpu(),
                          "composed vs fused H2")
    out["composed_equals_fused_at_rerank"] = kw["rerank"]
    return out


def phase_serve(name: str, spec, seed: int, n_points: int, card: str,
                out_dir: str) -> dict:
    t0 = time.perf_counter()
    pts, queries = make_dataset(spec, n_points, 4096, seed=seed)
    t_data = time.perf_counter() - t0
    cfg = JunoConfig(n_clusters=1024, n_entries=256, sub_dim=2,
                     metric=spec.metric)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build(pts, cfg, seed=seed)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n, s = index.codes.shape
    p = index.cluster_codes.shape[1]

    stream = _requests(np.random.default_rng(seed), queries.shape[0])
    engines = {}
    for label, fused in (("fused", True), ("unfused", False)):
        engines[label] = serve_engine(
            index, queries, stream, metric=spec.metric, fused=fused,
            n_points=n,
            trace_path=os.path.join(out_dir, f"trace_{name}_{label}.json"))
        log(f"serve.{name}.{label}", **engines[label])

    cpu_index = index_to(index, "cpu")
    tiers = tier_table(index, cpu_index, queries, pts, spec.metric)
    log(f"tiers.{name}", **tiers)
    out = {"name": name, "N": n, "D": spec.dim, "S": s, "E": 256, "P": p,
           "C_clusters": 1024, "data_s": t_data, "build_s": t_build,
           "engines": engines, "tiers": tiers,
           "max_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "card": card}
    del index, cpu_index
    torch.cuda.empty_cache()
    return out


def kernel_line(kernels: dict, serves: list[dict]) -> dict:
    line = []
    for name, rows in kernels.items():
        head = rows[0]
        src, replaces = SOURCES[name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(e["launches"][name] for s in serves
                            for e in s["engines"].values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "variants": rows})
    return {"kernels": line}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "chip_smoke"),
                    help="directory for the report, ptxas output and traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    device = phase_device()
    phase_build(args.out)
    kernels = phase_kernels(args.seed)
    serves = [phase_serve(name, spec, args.seed, N_POINTS, device["nvidia_smi"],
                          args.out)
              for name, spec in (("l2", DEEP_LIKE), ("ip", TTI_LIKE))]
    line = kernel_line(kernels["kernels"], serves)
    report = {"device": device, **kernels, "serve": serves,
              "seconds": time.perf_counter() - t_start}
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(line), flush=True)
    print(device["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
