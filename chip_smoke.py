#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of JUNO (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each raising on failure:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — both CUDA kernels compiled from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a``, in parallel;
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes, l2 at S=48 and ip at S=100 (LUT, hit table,
   counts and candidates equal; ``cand_dist`` and ``dist`` within 1e-5 of
   the sum of their terms' magnitudes), timed with CUDA events (median of 20)
   beside the plain version and the least time the card could take;
4. l2 serving — a 1M-point DEEP-like index (D=96, S=48, E=256, C=1024)
   built on the card and served by ``AnnServeEngine(fused=True)``: ≥ 48
   mixed requests, both kernels' launch counts > 0, recall@10-in-100
   against ``exact_topk``, ids of 32 queries against the same search on
   the CPU (plain versions);
5. ip serving — the same with a 1M-point TTI-like index (D=200, S=100);
6. the kernel line, then the card line, then the result line.

It needs a CUDA card and the repo's ``src/``; without either it exits
non-zero before printing any result. Detailed numbers (``chip_smoke.json``),
the compiler's register report and the profiler traces go to ``--out``
(default ``build/chip_smoke/``).
"""
from __future__ import annotations

import argparse
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
from repro_torch.kernels import selective_lut as slut  # noqa: E402
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
            "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}


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


def check_fused_two_stage(q: int, n_probe: int, p: int, s: int, e: int,
                          n_clusters: int, cap_c: int, metric: str,
                          gen) -> dict:
    dev = torch.device("cuda")
    if metric == "l2":
        # non-negative entries, as an l2 LUT holds
        lut = torch.rand((q, n_probe, s, e), generator=gen, device=dev) * 4.0
    else:
        # signed similarities, as an ip LUT holds: the sums may cancel
        lut = torch.randn((q, n_probe, s, e), generator=gen, device=dev)
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                          device=dev, dtype=torch.int8)
    codes = torch.randint(0, e, (n_clusters, p, s), generator=gen, device=dev,
                          dtype=torch.uint8)
    # ~N/C of P slots filled, as a 1M-point, 1024-cluster index has
    valid = torch.rand((n_clusters, p), generator=gen, device=dev) < 0.25
    cids = torch.stack([torch.randperm(n_clusters, generator=gen, device=dev)
                        [:n_probe] for _ in range(q)])
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
    # bytes the work needs: each probed cluster's codes and valid row once,
    # the int8 tables, the LUT at the C candidates only, the outputs once
    rows = int(torch.unique(cids).numel())
    w = n_probe * p
    n_bytes = (rows * p * (s + 1) + table.numel() + q * cap_c * s * 4
               + cids.numel() * 8 + q * w * 8 + q * cap_c * 8)
    bnd, by = bound_ms(n_bytes, q * w * s + q * cap_c * s)
    return {"metric": metric, "Q": q, "np": n_probe, "P": p, "S": s, "E": e,
            "C": cap_c, "max_abs_err": err,
            "ms": time_ms(lambda: fts.fused_two_stage(
                lut, table, codes, valid, cids, **kw)),
            "plain_ms": time_ms(lambda: fts.fused_two_stage_plain(
                lut, table, codes[cids], valid[cids], **kw)),
            "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
            "distinct_clusters": rows}


def phase_kernels(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lut_rows = [check_selective_lut("l2", 2048, 48, 256, gen),
                check_selective_lut("ip", 2048, 48, 256, gen),
                check_selective_lut("ip", 2048, 100, 256, gen)]
    for r in lut_rows:
        log("kernel.selective_lut", **r)
    fused_rows = [check_fused_two_stage(128, 16, 3912, s, 256, 1024, c,
                                        metric, gen)
                  for metric, s in (("l2", 48), ("ip", 100))
                  for c in (320, 3200)]
    for r in fused_rows:
        log("kernel.fused_two_stage", **r)
    return {"selective_lut": lut_rows, "fused_two_stage": fused_rows}


def _requests(rng, n_queries: int, n_req: int = 56) -> list[dict]:
    out = []
    for i in range(n_req):
        rows = int(rng.integers(1, 201))
        lo = int(rng.integers(0, n_queries - rows))
        out.append(dict(rows=(lo, lo + rows), k=(10, 100)[i % 2],
                        recall_target=(0.95, 0.85)[(i // 2) % 2]))
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

    def serve() -> tuple[AnnServeEngine, list, float]:
        eng = AnnServeEngine(index, metric=spec.metric)
        reqs = [eng.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                           recall_target=r["recall_target"]) for r in stream]
        t = time.perf_counter()
        eng.run()
        return eng, reqs, time.perf_counter() - t

    serve()                                    # warm-up: cuBLAS, allocator
    _build.reset_launches()
    eng, reqs, t_serve = serve()
    launches = dict(_build.LAUNCHES)
    for r in reqs:
        if not r.done or r.ids.shape != (r.queries.shape[0], r.k):
            raise AssertionError(f"request {r.rid} not served")
        if (r.ids < 0).any() or (r.ids >= n).any() or \
                not np.isfinite(r.scores).all():
            raise AssertionError(f"request {r.rid}: invalid ids or scores")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    t_repeats = [t_serve] + [serve()[2] for _ in range(4)]
    prof = profile_window(serve, os.path.join(out_dir, f"trace_{name}.json"))

    # recall@10-in-100 of the H tier's signature against exact search
    q_eval = torch.from_numpy(queries[:256]).cuda()
    kw = dict(nprobe=16, k=100, metric=spec.metric,
              rerank=AnnServeEngine.FUSED_RERANK_MULT * 100)
    _, ids = search(index, q_eval, **kw)
    pts_dev = torch.from_numpy(pts).cuda()
    _, gt = exact_topk(q_eval, pts_dev, k=10, metric=spec.metric)
    recall = recall_n_at_k(ids.long(), gt)
    del pts_dev

    # the same search on the CPU (plain versions) for 32 queries
    cpu_index = index_to(index, "cpu")
    _, ids_cpu = search(cpu_index, q_eval[:32].cpu(), batch=8, **kw)
    ids_gpu = ids[:32].cpu()
    same = np.mean([len(set(a.tolist()) & set(b.tolist())) / a.numel()
                    for a, b in zip(ids_gpu, ids_cpu)])
    r_gpu = recall_n_at_k(ids_gpu.long(), gt[:32].cpu())
    r_cpu = recall_n_at_k(ids_cpu.long(), gt[:32].cpu())
    if same < 0.99 or abs(r_gpu - r_cpu) > 0.01:
        raise AssertionError(f"GPU vs CPU search: {same:.4f} ids shared, "
                             f"recall {r_gpu:.4f} vs {r_cpu:.4f}")
    if recall < 0.2:
        raise AssertionError(f"recall@10-in-100 {recall:.4f}: search broken")
    out = {"name": name, "N": n, "D": spec.dim, "S": s, "E": 256, "P": p,
           "C_clusters": 1024, "data_s": t_data, "build_s": t_build,
           "requests": len(reqs), "rows": eng.stats["queries"],
           "ticks": eng.stats["ticks"],
           "qps": eng.stats["queries"] / statistics.median(t_repeats),
           "qps_repeats": [eng.stats["queries"] / t for t in t_repeats],
           "profile": prof,
           "latency": eng.latency_stats(),
           "signatures": {str(k): v for k, v in eng.stats["signatures"].items()},
           "launches": launches, "recall10_at_100": recall,
           "cpu_ids_shared": same, "recall_gpu32": r_gpu,
           "recall_cpu32": r_cpu,
           "max_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "card": card}
    log(f"serve.{name}", **out)
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
            "launches": sum(s["launches"][name] for s in serves),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "variants": rows})
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
    line = kernel_line(kernels, serves)
    report = {"device": device, "kernels": kernels, "serve": serves,
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
