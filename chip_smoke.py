#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of JUNO (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each raising on failure:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — all seven CUDA kernels compiled from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``, in
   parallel;
3. kernels — each kernel against its plain PyTorch version on the card at
   the main paths' shapes (LUT, hit table, sphere hits, ``probe_ok``,
   counts and candidates equal; ADC sums within 1e-5 of the sum of their
   terms' magnitudes; ``ivf_filter``'s scores within 1e-5 of
   ``Σ_d |q_d c_d|``, twice that for l2, plus the csq term's ulp, its
   top-16 ids equal away from a tie, at (Q, C, D) = (128, 1024, 96) and
   (128, 1024, 200) for a search batch and (1000, 1024, 96) for an insert
   batch, l2 and ip; its top-nprobe epilogue, which stage A runs, at the
   search shapes with nprobe 8, 16 and 32, the insert shape with nprobe
   1 and the streaming build's eval batch, nprobe 1, at (Q, C, D) =
   (8192, 1024, 96), (8192, 10240, 96) and (8192, 1024, 200): scores
   within that bound, ids equal away from a tie at the nprobe-th
   place, and equal, index-ascending, where centroids repeat), timed with
   CUDA events (median of 20) beside the plain version, the PyTorch calls
   that compute the same result where there are any (``embedding_bag``,
   ``addmm``/``mm``, for the top-nprobe ``addmm``/``mm`` then a stable
   ``sort``), and the least time the card could take; ``selective_lut``
   at (B, S) = (2048, 48) l2, (2048, 48) and (2048, 100) ip, at the
   engines' batch sizes (128, 48) l2, (512, 100) and (4096, 100) ip, and
   on stage B's ip route (``ops.build_selective_lut`` from a ``qsub``
   expanded over 16 probes: one kernel a call, no copy, counted on its
   capture into a CUDA graph), each also with
   the profiler's kernel time and a write floor (one ``fill_`` of the same
   output bytes: a yardstick, not a library call); ``fused_two_stage`` and
   ``fused_three_stage`` (at half, probe-0-only and full coverage) at the
   engine's batch of 128 queries, both also at its buckets of 32 and 8
   (C = 320), the three-stage kernel also over 2048 distinct clusters, and
   both at Q = 128 with the valid slots packed at the front of each cluster
   as a built index lays them out (the other rows scatter them), each
   row with the profiler's count- and select-kernel time, the write floor of
   ``counts`` and ``dist``, and the call through ``ops`` held to two
   kernels, counted on its capture into a CUDA graph (the three-stage one
   with q0, q1 as a (Q, 2) tensor's columns); ``hit_count``'s top-k route,
   which tiers M, L and composed H2 run (values and positions equal to the
   plain counts' stable sort), at M/L's np 8 with k 10 and 100 (l2 S = 48,
   ip S = 100), composed H2's np 16 with C 40 and 400, Q 128, 32 and 8,
   scattered and packed valid slots and a row of sentinel ties, each with
   the profiler's count- and top-k-kernel time, ``count_sort_ms`` (the
   counts kernel, a stable sort and a slice: the route before the top-k
   kernel) and two kernels a call by capture; then its counts-only kernel
   at the three shapes of earlier runs, one kernel a call; ``pq_scan``'s
   top-k route, which tier H runs (values and positions bit-equal to a
   stable sort of the scores-only kernel's own output plus stage A's
   offset, and within 1e-5 of plain with positions equal up to ties), at
   np 16 with k 100 and 10, l2 S = 48 and ip S = 100 (with the offset), Q
   128, 32 and 8, scattered, packed and few valid slots, an integer LUT
   (exact ties across probes) and every probe but 0 pruned, each with the
   profiler's select- and merge-kernel time, ``scan_sort_ms`` (the scores
   kernel, the add, a stable sort and a slice: the route before the top-k
   kernels), the library's ``embedding_bag`` + sort + slice and two
   kernels a call by capture; then its scores-only kernel at the two
   shapes of earlier runs, one kernel a call; ``sphere_hits``'s probe
   entry, which the rt search runs (``probe_ok``, radius and slots
   bit-equal to plain, and the verdicts to the dense entry's table at that
   radius gathered at the slots), at np 16 and 8, S 48 and 100, Q 128, 32
   and 8, scale 1, 0 and 1e6, each with the launch floor (an empty kernel
   on its grid, timed the same way) and one kernel a call by capture;
   then its dense entry at caps 64 and 32; then ``autotune.lattice``: the
   six launch shapes of the two-stage core (``kernels/autotune.py``) for
   both fused scans at l2 S 48 and ip S 100, Q 128, 32 and 8 (np 16, P
   3912, C 320), each bit-equal to the default launch, its median ms, its
   ratio to the default's and the winner; ``autotune.cache``:
   ``ensure_tuned`` on the card writes its cache, installs it again
   without measuring and refuses it once the kernels' tag changes;
4. l2 serving — a 1M-point DEEP-like index (D=96, S=48, E=256, C=1024)
   and its RT centroid grid built on the card (then ``sphere_hits``'s probe
   entry on that grid at Q 128, np 16 and 8, as the search calls it: equal
   to plain, timed beside its bound and launch floor, and the search's
   ``_rt_probe_mask`` two kernels a call by capture, the projection GEMM
   and the probe kernel;
   the dense entry against its plain version on that grid, the main
   path's ``cap``; and the rt router's host time over the request stream),
   served by four engines —
   ``fused`` True and False, each with ``prefilter`` "scan" and "rt" — on
   a stream of 64 requests that routes to tiers H, H2, M and L: each
   engine's kernel launches over one pass (``ivf_filter`` for stage A in
   all four, one launch a stage-A call, counted on ``filter_clusters``),
   QPS, latency, signatures, the profiled pass's sort launches and
   the other sorts' device ms, and the ``hit_count_topk_scan`` calls of
   its warm-up pass (batch sizes, np, k, and the valid slots of the
   clusters they probed beside every cluster's), and its
   ``masked_adc_topk_scan`` calls (tier H) likewise (``pq_calls``); no
   pass may spend 1 ms on sorts other than ``radixSortKVInPlace``; the
   unfused scan engine's calls replayed as ``hit_count`` rows (every call
   equal to its plain version; device ms, count- and top-k-kernel ms,
   ``count_sort_ms`` and the bound, summed over the pass) and as a
   ``pq_scan`` row (every call bit-equal to the route before the top-k
   kernels and close to plain; device ms, select- and merge-kernel ms,
   ``scan_sort_ms`` and the bound, summed over the pass); then
   ``autotune.l2``: every fused scan call of a fused and an rt fused pass
   replayed at the other five launch shapes, bit-equal, and the four
   engines with the tuned configs installed, and with the lattice's last
   shape, bit-equal to the untuned engines request by request with the
   same signatures and exactly their kernels launched; then
   per tier (H, fused H2, composed H2, M, L; under rt fused H2 is the
   three-stage kernel)
   recall@10-in-100 against ``exact_topk`` and QPS, composed H2 against
   fused H2 at the same rerank (ids equal up to score ties), and the ids
   of 32 queries against the same search on the CPU (plain versions);
   under rt also the scan path's ids at full coverage and the three-stage
   kernel against ``fused3=False``; then ``mutate.l2`` on the same index:
   a default engine and an rt fused engine over one ``MutableJunoIndex``;
   20 rounds of 1,000 inserts (``ivf_filter`` once a batch), 500 deletes
   and one pass of the stream through each engine (no deleted id in a
   result; the rt router recomputes its state after each insert batch);
   inserted points, asked for themselves, found in tier H's top-10 as often
   as build points where the exact top-10 of the live set holds them
   (4,000 of each; less 4 standard errors of the gap); a forced spill of
   200 points into the side buffer, with which QPS is read and every tier
   is held against the CPU (≥ 99% ids) and, at ``rt_scale`` 1e6, against
   the scan path; ``compact()`` and
   ``swap_index()`` (the rebuild, timed) keep tiers H, M and L (ids up to
   score ties; H2's changed rows printed); the freshness tiers
   (``max_minors=2``) take 3 × 256 spills at a constant delta capacity,
   equal ``rebuild_index`` of the same state, and fold back; then
   ``paged.l2`` on the same index and stream: the index and its grid
   committed to an ``ArtifactStore`` in a temporary directory under
   ``build/`` (its bytes, the ``put`` and ``verify`` seconds), served by
   four paged engines (fused or not, scan or rt) over
   ``PagedIndexData`` with a cache of a quarter of ``cluster_codes``:
   each engine's ids and scores bit-equal to the resident engine of the
   same configuration, request by request, its launches exactly that
   configuration's kernels, evictions > 0, QPS as the median of two
   passes in turns with the resident engine, the ratio, the cache
   counters and ``gather``'s host seconds a pass; one gather of the
   largest batch taken apart (the rows' copy out of the memory map, their
   sha256, the host→device copies, the stack; one pinned copy beside);
   the exact rerank of 40
   candidates from the raw vectors (an ``.npy``): its recall@10 beside the
   paged engine's, its scores the raw vectors' of its ids; a flipped byte
   of a probed row failing the first search with ``ArtifactError`` (and
   ``verify``), restored after; the same 200 inserts and 550 deletes on a
   paged and a resident engine (the inserts all in the side buffer, found
   as the resident engine finds them; no deleted id returned); a swap to
   generation 2 (the resident state rebuilt) that drops the cached rows,
   keeps the counters and then serves the resident engine's results on
   it; with ``max_minors=2`` and the store, a full L0 committed as a
   minor artifact, faulted in on the first search and its ids found; the
   directory is deleted at the end; then ``obs.l2``: the four engines
   (fused or not, scan or rt) with obs on and off, three passes in turns,
   ids and scores bit-equal request by request, QPS of each and the
   ratio; the registry's tick, row and per-tier request counts equal to
   the engines' own; every ``engine.dispatch`` span under an
   ``engine.tick``; a ``RecallProbe(every=8)`` on the fused engine (its
   online recall@10 beside the tiers' recall); an ``ArtifactStore`` with
   a registry (one put, load and verify counted); a fused paged engine
   with its fetch plane bound (fault spans = misses, ``juno_cache_*`` =
   ``cache_stats()``, bit-equal to obs off); the merged dump as JSONL in
   ``--out``, passing ``validate_events``; then ``pipeline.l2``: the
   serve phase's 1M points through ``build_streaming`` (probe counters,
   shapes and dtypes of the in-memory index's, recall@10-in-100 of H, M
   and L within 0.01 of its) and 10M DEEP-like points streamed out of
   ``make_dataset``'s draws, never held whole (C = 10,240, P = 3912,
   ``max_train_points`` 1M): each pass's seconds, the device's peak over
   passes 1–2 below the raw points' bytes, the fused and unfused engines'
   QPS, tiers H, H2, M and L's recall against an exact top-100 streamed
   over the source, ``split_shards``/``merge_shards`` bit-equal, and an
   ``ArtifactStore`` round trip served bit-equal (the mutate phase's
   freshness engine also holds its ``MergeScheduler``'s series to its
   stats); before ``pipeline.l2``, ``dist.l2``: the same index
   cluster-sharded (``repro_torch.dist``, 4 shards of 256 clusters, all on
   this card): a 1-shard ``DistributedMutableIndex`` under each of the
   four engine configurations bit-equal to the unsharded engines, request
   by request; 4 shards at full coverage (``local_nprobe`` 256, 128
   queries) against ``search`` at nprobe 1024, tier H's scores bit-equal
   and ids equal up to exact ties, M and L's counts equal; recall@10-in-100
   of H, fused H2, M and L at ``ceil(nprobe / 4)`` a shard beside the
   unsharded tiers', and (l2 only) a 4-shard engine's QPS in turns with
   the unsharded one; rt and the three-stage scan at full-coverage radii
   equal to scan across shards; 32 queries against the CPU (≥ 99% ids);
   5 rounds of 1,000 inserts and 500 deletes through the sharded engine
   (no deleted id served), a 200-point spill over the four shards,
   ``rebuild_shard`` on each (scores bit-equal before and after), and a
   lane-scheduled drain with the tiers on; then ``fleet.l2``: 2- and
   1-replica ``AnnServeFleet`` bit-equal to one engine, request by
   request; a 2 × 2 sharded fleet serving the stream, unchanged by a
   ``fail_replica`` mid-stream, fanning 1,000 inserts out with identical
   ids, and shedding with typed rejections under ``policy="shed"``
   (``max_queue`` 256); 2 paged replicas over the paged phase's artifact
   sharing one cluster cache, bit-equal to the resident engine; each
   fleet's QPS, p50/p99 and shed/expired/rerouted counts;
5. ip serving — the same with a 1M-point TTI-like index (D=200, S=100),
   then ``autotune.ip``, ``mutate.ip``, ``paged.ip``, ``obs.ip``,
   ``dist.ip`` and ``fleet.ip``;
6. ``attn.phi4_mini`` — JUNO-attention (``repro_torch.models``, plain
   PyTorch: the reference reaches no kernel there) at phi4-mini-3.8b's
   full attention shape at decode_32k (B 4, S 32,768, 24 query heads on 8
   KV heads of 128 dims) over synthetic bf16 caches: the index's build
   seconds, ``encode_step``'s ms, a decode step's ms at top_c 256, 512
   and 1024 beside exact attention and ``scaled_dot_product_attention``,
   rel_err and cosine against exact attention in f32, top_c = S equal to
   exact attention, a 2-KV-head slice redone on the CPU (the k-means from
   the card's init draws: codebooks within 1e-2, every differing code a
   near-tie; the top-C positions equal up to score ties and the output
   within 4 bf16 ulps), and ``traffic_model``'s bytes;
7. ``lm.phi4_mini`` — the dense LM serving path (``repro_torch.models``,
   ``serve/engine.py``; plain PyTorch: the reference's LM path reaches no
   kernel) on phi4-mini-3.8b FULL in bf16 from a seeded random init: the
   init's parameters, bytes and seconds; a ``ServeEngine`` of 8 slots of
   4096 positions serving 16 requests (prompts 32-1024 tokens, 16-64 new)
   to the end: ticks, ms a tick (median, p99), tokens/s, the tick's byte
   bound beside a CUDA-event time of one plain decode and of the engine's
   CUDA graph of it and of the K cache's f32 upcast, every output made in
   the first 256 ticks equal to a replay of them through plain ``decode``;
   prefill (B 4, T 4096: the flash path) and one decode against
   ``forward`` in f32 at 4 layers (within 2e-2) and in bf16 at 32
   (recorded); a 2-layer slice on the CPU (logits within 2^-5 of the
   largest); JUNO-attention on layer 0's keys of that prefill at top_c
   256, 512 and 1024 (rel_err, cosine, ms beside exact attention; top_c =
   S within 4 bf16 ulps); no kernel of the port launched;
8. ``lm.families`` — the MoE, MLA, Mamba-2, hybrid, cross-attention and
   Whisper families (plain PyTorch: the reference reaches no kernel
   there) at full width in bf16 from a seeded init, one JSON line a
   model, each model freed before the next (its device peak recorded):
   deepseek-v2-lite-16b FULL served by a ``ServeEngine`` of 8 slots of
   4096 (8 requests, every output equal to a plain replay of the first
   256 ticks, whole where its last tick is replayed; ms a tick
   beside the byte bound, which reads every expert), f32 prefill/decode
   against forward at 4 layers under the MoE capacity rule, the share of
   dropped slots at B 4 × T 4096, the absorbed MLA decode against the
   decompressed path; mamba2-1.3b and hymba-1.5b FULL served on 4 slots
   (slots re-admitted, the SSM state carried over as in the reference),
   prefill/decode against forward at B 4 × T 4096 in f32 at 4 layers
   (gated) and bf16 whole (recorded); whisper-large-v3 FULL: prefill of
   1500 frames and a 32-token prompt at B 4, 32 greedy steps, f32 at 4 +
   4 layers; llama4-scout at 4 layers and llama-3.2-vision at 10 (full
   width; ``reduced`` says why): prefill, 16 steps, f32 checks (the VLM's
   decode must miss forward: the reference's cross-cache fault); no
   kernel of the port launched;
9. train (``train.phi4_mini``) — the training path (``repro_torch.train``:
   autograd's backward through the remat'd blocks, in-place AdamW; plain
   PyTorch, no kernel of the port) on phi4-mini-3.8b FULL: f32 master
   weights, bf16 compute, 8 steps on one B 2 × T 1024 batch (the loss
   falls) and 4 on fresh batches, ms a step against its FLOP and byte
   bounds, tokens/s, the device peak beside the 16 B a parameter of
   state, the optimizer's own ms; a 2-layer f32 slice's loss and
   gradients against the CPU's; remat on against off at 4 layers; AdamW
   in place against plain; bf16 cast-through and 2 micro-batches at 4
   layers; a crash-restart run equal to an uninterrupted one and the
   trainer CLI's resume at SMOKE width; no kernel of the port launched;
10. shard (``shard.phi4_mini``) — the sharded train step
   (``repro_torch.dist.sharding``: DTensor state on a ``DeviceMesh``, the
   SP schedule, ``grad_pspecs``; plain PyTorch, no kernel of the port) on
   a one-rank NCCL group's (1, 1) ("data", "model") mesh: phi4-mini-3.8b
   FULL at as many layers as fit (32), 3 steps from the train phase's seed
   and batch, sharded and unsharded at the same depth (loss within 1e-4
   and grad norm within 1e-3, relative), ms a step, a profiled step's
   device busy time and the peak of each;
   a 2-layer f32 slice's gradients sharded against unsharded (within 1e-5
   of the largest; ``torch.equal`` recorded); a SMOKE-width checkpoint
   saved from the mesh restored onto it and onto no mesh, equal;
   ``shard.phi4_mini_serve``: prefill of 8 prompts of 512 tokens into a
   cache of 8 × 4096 and 64 greedy decode ticks through the sharded
   serving path (parameters in the dry run's serving layout, bf16; the
   cache laid out by its schema) and unsharded from the same parameters
   and prompts: the greedy tokens equal, every step's logits within 1e-3
   of the largest, ms a tick both ways and the peaks; no kernel of the
   port launched;
11. dryrun — the dry-run CLI (``repro_torch.launch.dryrun``, a fake world
   of 256 or 512 ranks, ``--device cuda``) over five cells in
   subprocesses started before the train phase: hymba-1.5b long_500k on
   the multi-pod mesh, mamba2-1.3b train_4k single-pod under SP,
   phi4-mini long_500k (a skip), the JUNO 100M-point cell and phi4-mini
   train_4k, each status gated, one line a cell (the dominant roofline
   term; compute, memory and collective seconds at the H100's data-sheet
   rates; counted over analytic FLOPs); then in process the fake pass of
   the train phase's FULL step (B 2 × T 1024, no mesh): its counted FLOPs
   equal to ``FlopCounterMode``'s count of the train phase's last real
   step and its predicted state bytes to the real state's, MemTracker's
   peak beside the card's and the analytic compute bound beside the
   measured ms a step;
12. the kernel line, then the card line, then the result line. A
   kernel's ``launches`` there counts its wrapper's calls in one pass of the
   four engines over both indexes, the ``mutate`` rounds, the first
   pass of each paged engine, the ``obs`` passes, the ``dist`` and
   ``fleet`` phases, the ``autotune`` engines' configured passes, the
   ``pipeline`` builds and 10M engine passes and ``lm.phi4_mini``,
   ``lm.families``, ``train.phi4_mini``, ``shard.phi4_mini`` and the
   dry run (none)
   (an rt
   engine that launches the dense ``sphere_hits`` entry fails; the line's
   ``sphere_hits`` counts both entries, each in ``entries``): a
   ``hit_count`` call on the top-k route, which every engine takes, is two
   kernels (count, then top-k), and so is a ``pq_scan`` call on its top-k
   route, which every unfused engine takes for tier H (select, then
   merge); the line says so (``launches_are``).

It needs a CUDA card and the repo's ``src/``; without either it exits
non-zero before printing any result. Detailed numbers (``chip_smoke.json``),
the compiler's register report and the profiler traces go to ``--out``
(default ``build/chip_smoke/``); with ``--hit-calls DIR`` the replayed
``hit_count`` and ``pq_scan`` calls, their inputs included, go to DIR for
``bench_stage_a.py --hit-count --calls`` and ``--pq-scan --calls``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import gzip
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch import resolve_device, rt  # noqa: E402
from repro_torch.build import (ArtifactError, ArtifactStore,  # noqa: E402
                               BuildProbe, array_source, build_streaming,
                               load_index, merge_shards, rebuild_index,
                               split_shards)
from repro_torch.core import (JunoConfig, MergeScheduler,  # noqa: E402
                              build, exact_topk, index_to, promote_l0,
                              recall_n_at_k, search)
from repro_torch.core import density as density_lib  # noqa: E402
from repro_torch.core import juno as juno_lib  # noqa: E402
from repro_torch.core.ivf import cluster_capacity, filter_clusters  # noqa: E402
from repro_torch.core.juno import (MutableJunoIndex, SideBuffer,  # noqa: E402
                                   _rt_probe_mask)
from repro_torch.data import (DEEP_LIKE, TTI_LIKE, make_dataset,  # noqa: E402
                              point_chunks)
from repro_torch.dist import (DistributedMutableIndex,  # noqa: E402
                              make_distributed_search, shard_index)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import fused_three_stage as f3s  # noqa: E402
from repro_torch.kernels import fused_two_stage as fts  # noqa: E402
from repro_torch.kernels import hit_count as hc  # noqa: E402
from repro_torch.kernels import ivf_filter as ivff  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq_scan as pqs  # noqa: E402
from repro_torch.kernels import selective_lut as slut  # noqa: E402
from repro_torch.kernels import sphere_hits as sph  # noqa: E402
from repro_torch.kernels.ref import NEG  # noqa: E402
from repro_torch.configs import get_config as get_lm_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.tokens import make_batch as lm_batch  # noqa: E402
from repro_torch.dist import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.dist import sharding as shmod  # noqa: E402
from repro_torch.launch import dryrun as dryrun_lib  # noqa: E402
from repro_torch.launch.mesh import normalize_pspec  # noqa: E402
from repro_torch.launch.shapes import ShapeSpec  # noqa: E402
from repro_torch.dist.fault_tolerance import run_with_restart  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.train import (AdamWConfig, OptState,  # noqa: E402
                               TrainConfig, TrainState, adamw_update,
                               adamw_update_, init_opt_state,
                               init_train_state, make_train_step)
from repro_torch.models import (build_kv_index, draw_kv_init,  # noqa: E402
                                encode_step, juno_decode_attention,
                                kv_index_from_arrays, traffic_model)
from repro_torch.models import get_model, init_params  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import params as lm_params  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import mla as lm_mla  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.models import whisper as lm_whisper  # noqa: E402
from repro_torch.models.juno_attention import (_approx_scores,  # noqa: E402
                                               _top_positions)
from repro_torch.obs import (MetricsRegistry, Observability,  # noqa: E402
                             RecallProbe, Tracer, to_events, validate_events,
                             write_jsonl)
from repro_torch.serve import ann as ann_lib  # noqa: E402
from repro_torch.serve.ann import AnnServeEngine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.fleet import (AnnServeFleet,  # noqa: E402
                                     _ShardedAnnServeEngine)
from repro_torch.serve.paged import (PagedAnnServeEngine,  # noqa: E402
                                     PagedIndexData)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 rate outside the tensor cores
F64_OPS_PER_S = 34e12          # H100 SXM f64 rate outside the tensor cores
RTOL = 1e-5                    # f32 sums over S in another order
N_POINTS = 1_000_000
SIDE = 256                     # side-buffer capacity of the mutable index
ROUNDS = 20                    # mutate phase: insert/delete/serve rounds
INSERT_BATCH = 1000
DELETE_BATCH = 500
OWN_QUERIES = 4000             # inserted and build points asked for themselves
OWN_SIGMAS = 4                 # their gap's limit, in standard errors
SPILL = 200                    # side points live while requests are served
FULL = 1e6                     # rt_scale at which every disc covers every cluster
SOURCES = {
    "selective_lut": ("src/repro_torch/kernels/csrc/selective_lut.cu",
                      "src/repro/kernels/selective_lut.py:80"),
    "fused_two_stage": ("src/repro_torch/kernels/csrc/fused_two_stage.cu",
                        "src/repro/kernels/fused_two_stage.py:182"),
    "pq_scan": ("src/repro_torch/kernels/csrc/pq_scan.cu",
                "src/repro/kernels/pq_scan.py:41"),
    "hit_count": ("src/repro_torch/kernels/csrc/hit_count.cu",
                  "src/repro/kernels/hit_count.py:36"),
    "sphere_hits": ("src/repro_torch/kernels/csrc/sphere_hits.cu",
                    "src/repro/rt/intersect.py:68"),
    "fused_three_stage": ("src/repro_torch/kernels/csrc/fused_three_stage.cu",
                          "src/repro/kernels/fused_three_stage.py:203"),
    "ivf_filter": ("src/repro_torch/kernels/csrc/ivf_filter.cu",
                   "src/repro/kernels/ivf_filter.py:43"),
}
# the kernels each engine configuration (prefilter, fused) must launch; it
# must launch no other
ENGINE_KERNELS = {
    ("scan", True): {"ivf_filter", "selective_lut", "fused_two_stage",
                     "hit_count"},
    ("scan", False): {"ivf_filter", "selective_lut", "pq_scan", "hit_count"},
    ("rt", True): {"ivf_filter", "selective_lut", "fused_three_stage",
                   "hit_count", "sphere_probe"},
    ("rt", False): {"ivf_filter", "selective_lut", "sphere_probe", "pq_scan",
                    "hit_count"},
}
# the line's kernels whose launches are counted under several keys of
# ``_build.LAUNCHES``, one an entry: the rt search launches sphere_hits.cu's
# probe entry, the dense entry is the reference's contract
ENTRIES = {"sphere_hits": ("sphere_probe", "sphere_hits")}
# the kernels whose ``launches`` count wrapper calls of several kernels
CALL_LAUNCHES = {
    "pq_scan": "wrapper calls; each top-k call (every call of the main "
               "path) is two kernels: pq_topk_kernel, then pq_merge_kernel",
    "hit_count": "wrapper calls; each top-k call (every call of the main "
                 "path) is two kernels: hit_count_kernel, then "
                 "hit_topk_kernel",
    "sphere_hits": "launches of both entries of sphere_hits.cu (sphere_probe: "
                   "the rt search's probe mask, one kernel a call; "
                   "sphere_hits: the dense table), each in entries"}
# the tiers whose recall and QPS are read, as search() arguments (k=100);
# under prefilter="rt" fused H2 runs the three-stage kernel
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


def bound_ms(n_bytes: float, n_ops: float, n_f64_ops: float = 0.0
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S + n_f64_ops / F64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def profile_window(fn, trace_path: str) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``).

    Returns the window's host wall time, the summed device time of its
    kernels and copies, the idle share ``1 - busy / wall``, the sorts'
    launches and device ms and the top kernels by device time; the Chrome
    trace goes to ``trace_path``,
    gzipped (``.gz`` appended).
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
    with open(trace_path, "rb") as src, gzip.open(trace_path + ".gz",
                                                    "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace_path)
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels[ev.key] = (kernels.get(ev.key, (0.0, 0))[0] + us / 1e3,
                               ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    sorts = sum(n for k, (_, n) in kernels.items()
                if "radixSortKVInPlace" in k)
    # every other sort kernel (cub's segmented and onesweep sorts: the
    # scans' top-k), as bench_stage_a.py --traces groups them
    other = [(ms, n) for k, (ms, n) in kernels.items()
             if "ort" in k and "radixSortKVInPlace" not in k]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3) if kernels else None,
            "radix_sort_launches": sorts,
            "other_sorts_ms": sum(ms for ms, _ in other),
            "other_sorts_launches": sum(n for _, n in other),
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


def kernel_us(fn, name: str, reps: int = 20) -> float:
    """Mean device time, in microseconds, of the kernels whose name holds
    ``name`` over ``reps`` calls of ``fn`` (``torch.profiler``): the
    kernel's own time, without the events' and the launch's share. None
    when the profiler recorded none of them (it can miss a window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and name in ev.key]
    n = sum(ev.count for ev in evs)
    return sum(ev.self_device_time_total for ev in evs) / n if n else None


def captured_kernels(fn) -> list[str]:
    """Every node of one call of ``fn`` captured into a CUDA graph, in
    order: a kernel node as its function's (mangled) name, any other node
    (copy, memset) as its type. A capture holds every operation the call
    puts on the stream; a profiler window on the card has come back empty,
    or without a call's first kernel, so launches a call are not counted
    from one. ``fn`` runs once first, outside the capture."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)   # kept for the dump
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        g.debug_dump(path)
        with open(path) as fh:
            dot = fh.read()
    del g
    # a node's definition runs to the next one's; its first word in
    # capitals is its type, a kernel's name follows its ID
    starts = [m.start() for m in
              re.finditer(r'(?m)^\s*"graph_\d+_node_\d+"\s*\[', dot)]
    nodes = []
    for a, b in zip(starts, starts[1:] + [len(dot)]):
        text = dot[a:b]
        kind = re.search(r"\b([A-Z][A-Z_]{3,})\b", text).group(1)
        name = re.search(r"\{ID \| \d+ \(topoId: \d+\) \| (\w+)", text)
        nodes.append(name.group(1) if kind == "KERNEL" and name else kind)
    return nodes


def write_floor_ms(n_bytes: int) -> float:
    """A yardstick, not a library call: one ``fill_`` of ``n_bytes`` bytes,
    the card's reachable write rate for a kernel that writes that much."""
    buf = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: buf.fill_(1))
    del buf
    return ms


def _lut_row(metric: str, args: tuple, got: tuple, fn, b: int, s: int,
             e: int) -> dict:
    """A ``selective_lut`` row: ``got`` (the kernel's lut and hit) equal to
    the plain version on ``args`` (contiguous planes), timed beside it,
    its bound and the write floor; ``fn`` is the call that is timed."""
    lut_p, hit_p = slut.selective_lut_plain(*args, metric=metric)
    torch.cuda.synchronize()
    lut_k, hit_k = (t.reshape(lut_p.shape) for t in got)
    if not (torch.equal(hit_k, hit_p) and torch.equal(lut_k, lut_p)):
        raise AssertionError(f"selective_lut {metric} B={b} S={s}: kernel != "
                             f"plain ({int((hit_k != hit_p).sum())} hit, "
                             f"{int((lut_k != lut_p).sum())} lut entries)")
    n_bytes = 4 * (3 * b * s + 3 * s * e) + 5 * b * s * e
    bnd, by = bound_ms(n_bytes, 12 * b * s * e)
    return {"metric": metric, "B": b, "S": s, "E": e,
            "max_abs_err": float((lut_k - lut_p).abs().max()),
            "ms": time_ms(fn), "kernel_us": kernel_us(fn, "selective_lut"),
            "plain_ms": time_ms(
                lambda: slut.selective_lut_plain(*args, metric=metric)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "write_floor_ms": write_floor_ms(5 * b * s * e),
            "bytes": n_bytes}


def check_selective_lut(metric: str, b: int, s: int, e: int, gen) -> dict:
    dev = torch.device("cuda")
    q = torch.randn((2, b, s), generator=gen, device=dev) * 0.5
    ent = torch.randn((2, s, e), generator=gen, device=dev) * 0.5
    esq = ent[0] * ent[0] + ent[1] * ent[1]
    tau = torch.rand((b, s), generator=gen, device=dev) * 0.8
    args = (q[0].contiguous(), q[1].contiguous(), ent[0].contiguous(),
            ent[1].contiguous(), esq, tau)
    got = slut.selective_lut(*args, metric=metric)
    return _lut_row(metric, args, got,
                    lambda: slut.selective_lut(*args, metric=metric), b, s, e)


def check_stage_b_route(q: int, n_probe: int, s: int, e: int, gen) -> dict:
    """Stage B as the ip query path runs it: ``ops.build_selective_lut``
    from ``qsub`` expanded over the probes (``core/juno.py:_stage_b``) and
    views of ``entries``: equal to the plain version on contiguous copies,
    and one kernel a call."""
    dev = torch.device("cuda")
    qsub = (torch.randn((q, 1, s, 2), generator=gen, device=dev) * 0.5
            ).expand(q, n_probe, s, 2)
    entries = torch.randn((s, e, 2), generator=gen, device=dev) * 0.5
    esq = torch.sum(entries * entries, -1)
    tau = torch.rand((q, n_probe, s), generator=gen, device=dev) * 0.8

    def call():
        return ops.build_selective_lut(qsub, entries, esq, tau, metric="ip")

    got = call()
    args = (qsub[..., 0].reshape(-1, s).contiguous(),
            qsub[..., 1].reshape(-1, s).contiguous(),
            entries[..., 0].contiguous(), entries[..., 1].contiguous(), esq,
            tau.reshape(-1, s).contiguous())
    row = _lut_row("ip", args, got, call, q * n_probe, s, e)
    launched = captured_kernels(call)
    if len(launched) != 1 or "selective_lut" not in launched[0]:
        raise AssertionError(f"stage B route: {len(launched)} kernels a call "
                             f"({launched}), want one selective_lut")
    return {"route": "ops.build_selective_lut, qsub expanded over the probes",
            "Q": q, "nprobe": n_probe, "kernels_a_call": len(launched), **row}


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
                n_clusters: int, gen, distinct: bool = False,
                packed: bool = False, share: float = 0.25):
    """Random per-cluster codes, a ~25%-filled valid mask (as a 1M-point,
    1024-cluster index has; ``share`` sets another fill for scattered
    slots) and random probed cluster ids, on the card:
    distinct within a query (clusters repeat across the batch) or, with
    ``distinct``, across the whole batch. The valid slots are scattered at
    random or, with ``packed``, at the front of each cluster, as a built
    index lays them out (700–1254 a cluster). Also returns the bytes of
    what the scans must read of them: each distinct probed cluster's valid
    row and its valid points' codes."""
    dev = torch.device("cuda")
    codes = torch.randint(0, e, (n_clusters, p, s), generator=gen, device=dev,
                          dtype=torch.uint8)
    if packed:
        fill = torch.randint(700, 1255, (n_clusters, 1), generator=gen,
                             device=dev)
        valid = torch.arange(p, device=dev)[None, :] < fill
    else:
        valid = torch.rand((n_clusters, p), generator=gen, device=dev) < share
    if distinct:
        cids = torch.randperm(n_clusters, generator=gen, device=dev
                              )[:q * n_probe].reshape(q, n_probe)
    else:
        cids = torch.stack([torch.randperm(n_clusters, generator=gen,
                                           device=dev)[:n_probe]
                            for _ in range(q)])
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


def _scan_split(fn, q: int, w: int) -> dict:
    """The two kernels' own times over calls of ``fn`` (profiler) and the
    write floor of their (Q, np·P) outputs: one ``fill_`` of the ``counts``
    and ``dist`` bytes."""
    return {"count_us": kernel_us(fn, "count_kernel"),
            "select_us": kernel_us(fn, "select_kernel"),
            "write_floor_ms": write_floor_ms(q * w * 8)}


def _two_kernels(fn, what: str) -> int:
    """Raise unless one call of ``fn`` is exactly the count and then the
    select kernel on the card (its capture into a CUDA graph, so a memset
    or copy node fails it too); returns that count."""
    launched = captured_kernels(fn)
    if (len(launched) != 2 or "count_kernel" not in launched[0]
            or "select_kernel" not in launched[1]):
        raise AssertionError(f"{what}: {len(launched)} kernels a call "
                             f"({launched}), want count and select")
    return len(launched)


def check_fused_two_stage(q: int, n_probe: int, p: int, s: int, e: int,
                          n_clusters: int, cap_c: int, metric: str,
                          gen, packed: bool = False) -> dict:
    """The two-stage kernel against its plain version; ``packed``: the
    valid slots at the front of each cluster (``_scan_index``)."""
    lut = _lut(q, n_probe, s, e, metric, gen)
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                          device=lut.device, dtype=torch.int8)
    codes, valid, cids, need = _scan_index(q, n_probe, p, s, e, n_clusters,
                                           gen, packed=packed)
    kw = dict(cap_c=cap_c, metric=metric)
    got = fts.fused_two_stage(lut, table, codes, valid, cids, **kw)
    want = fts.fused_two_stage_plain(lut, table, codes[cids], valid[cids], **kw)
    # Σ|terms| at the same candidates (counts and cand do not read the LUT)
    scale = fts.fused_two_stage_plain(lut.abs(), table, codes[cids],
                                      valid[cids], **kw)
    torch.cuda.synchronize()
    what = (f"fused_two_stage {metric} Q={q} S={s} C={cap_c}"
            f"{' packed' if packed else ''}")
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

    def call():
        return fts.fused_two_stage(lut, table, codes, valid, cids, **kw)

    return {"metric": metric, "Q": q, "np": n_probe, "P": p, "S": s, "E": e,
            "C": cap_c, "valid": "packed" if packed else "random",
            "max_abs_err": err, "ms": time_ms(call),
            "plain_ms": time_ms(lambda: fts.fused_two_stage_plain(
                lut, table, codes[cids], valid[cids], **kw)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "bytes": n_bytes, **_scan_split(call, q, w),
            "kernels_a_call": _two_kernels(
                lambda: ops.fused_two_stage_scan(lut, table, codes, valid,
                                                 cids, **kw), what),
            **need}


def check_hit_count(q: int, n_probe: int, p: int, s: int, e: int,
                    n_clusters: int, label: str, gen) -> dict:
    """The counts-only ``hit_count`` kernel against its plain version,
    timed beside it and the ``embedding_bag`` yardstick; one kernel a
    call."""
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
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
           "count_us": kernel_us(lambda: hc.hit_count(table, codes, valid,
                                                      cids),
                                 "hit_count_kernel"),
           "kernels_a_call": _hit_kernels(
               lambda: ops.hit_count_scan(table, codes, valid, cids),
               ("hit_count_kernel",), f"hit_count {label}"), **need}
    del lib
    return out


def _hit_kernels(fn, want: tuple, what: str) -> int:
    """Raise unless one call of ``fn`` is exactly the kernels ``want`` in
    that order on the card (its capture into a CUDA graph, so a sort,
    memset or copy node fails it too); returns their number."""
    launched = captured_kernels(fn)
    if len(launched) != len(want) or not all(
            n in node for n, node in zip(want, launched)):
        raise AssertionError(f"{what}: {len(launched)} kernels a call "
                             f"({launched}), want {want}")
    return len(launched)


def check_hit_count_topk(q: int, n_probe: int, p: int, s: int, e: int,
                         n_clusters: int, k: int, label: str, gen, *,
                         packed: bool = False, few: bool = False) -> dict:
    """The top-k route (``hit_count_topk``: the count kernel, then the
    top-k kernel) against its plain version (the plain counts, a stable
    sort, a slice): values and positions equal. ``packed``: the valid
    slots at the front of each cluster; ``few``: 0.2% of the slots valid,
    fewer than k a query, so the invalid sentinel's ties fill the quota.
    Timed beside the plain version, the library's two calls
    (``embedding_bag``, then ``torch.sort(stable=True)`` and the slice)
    and ``count_sort_ms``: this tree's counts kernel, then the stable sort
    and the slice, the route the engines took before (two calls)."""
    dev = torch.device("cuda")
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                          device=dev, dtype=torch.int8)
    codes, valid, cids, need = _scan_index(
        q, n_probe, p, s, e, n_clusters, gen, packed=packed,
        share=0.002 if few else 0.25)
    what = (f"hit_count_topk {label} Q={q} np={n_probe} S={s} k={k}"
            f"{' packed' if packed else ''}{' few' if few else ''}")
    got = hc.hit_count_topk(table, codes, valid, cids, k)
    want = hc.hit_count_topk_plain(table, codes[cids], valid[cids], k)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(
            f"{what}: {int((got[1] != want[1]).sum())} positions and "
            f"{int((got[0] != want[0]).sum())} values differ from plain")
    sentinel = int((want[0] == NEG).sum())
    if few and not sentinel:
        raise AssertionError(f"{what}: no sentinel ties in the top k")

    def call():
        return hc.hit_count_topk(table, codes, valid, cids, k)

    def count_sort():
        c = hc.hit_count(table, codes, valid, cids).reshape(q, -1)
        v, i = torch.sort(c, dim=1, descending=True, stable=True)
        return v[:, :k], i[:, :k]

    bag = _bag_call(table, codes, cids)

    def library():
        v, i = torch.sort(bag().reshape(q, -1), dim=1, descending=True,
                          stable=True)
        return v[:, :k], i[:, :k]

    # bytes the function needs: the probed clusters' valid rows and valid
    # points' codes once, the int8 tables, cids, the (Q, k) outputs; the
    # route also writes the counts and reads them back
    n_bytes = need["index_bytes"] + table.numel() + cids.numel() * 8 \
        + 12 * q * k
    n_ops = int(valid[cids].sum()) * s
    bnd, by = bound_ms(n_bytes, n_ops)
    counts_bytes = 8 * q * n_probe * p + 8 * q * n_probe * (2 * s + 2)
    out = {"route": "top-k", "tier": label, "Q": q, "np": n_probe, "P": p,
           "S": s, "E": e, "k": k, "valid": "packed" if packed else
           ("few" if few else "random"), "sentinel_results": sentinel,
           "max_abs_err": 0.0, "ms": time_ms(call),
           "plain_ms": time_ms(lambda: hc.hit_count_topk_plain(
               table, codes[cids], valid[cids], k)),
           "library_ms": time_ms(library),
           "library": "embedding_bag + sort(stable) + slice: two library "
                      "calls, the valid mask left out",
           "count_sort_ms": time_ms(count_sort),
           "count_sort": "hit_count kernel + sort(stable) + slice: two calls",
           "count_us": kernel_us(call, "hit_count_kernel"),
           "select_us": kernel_us(call, "hit_topk_kernel"),
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
           "bound_with_counts_ms": bound_ms(n_bytes + counts_bytes,
                                            n_ops)[0],
           "kernels_a_call": _hit_kernels(
               lambda: ops.hit_count_topk_scan(table, codes, valid, cids, k),
               ("hit_count_kernel", "hit_topk_kernel"), what),
           **need}
    del bag
    return out


def check_hit_count_pass(name: str, calls: list[dict]) -> list[dict]:
    """The top-k route over the calls of one engine pass, replayed on their
    recorded inputs (the built index's codes and valid slots, stage B's
    tables, the probed cluster ids, k), one row a tier (np 8: M and L, np
    16: composed H2): each call's values and positions equal to its plain
    version's; device ms (CUDA events, a call at a time), the profiler's
    count- and top-k-kernel ms, the plain version's and ``count_sort_ms``
    (the counts kernel, a stable sort and a slice), and the bound, each
    summed over the pass's calls."""
    rows = []
    for n_probe in sorted({c["cids"].shape[1] for c in calls}):
        cs = [c for c in calls if c["cids"].shape[1] == n_probe]
        what = f"hit_count_topk {name} engine pass np={n_probe}"

        def args(c):
            return c["table"], c["codes"], c["valid"], c["cids"]

        def call(c):
            return hc.hit_count_topk(*args(c), c["k"], probe_ok=c["probe_ok"])

        def plain(c):
            v = c["valid"][c["cids"]]
            if c["probe_ok"] is not None:
                v = v & c["probe_ok"][..., None]
            return hc.hit_count_topk_plain(c["table"], c["codes"][c["cids"]],
                                           v, c["k"])

        def count_sort(c):
            counts = hc.hit_count(*args(c), probe_ok=c["probe_ok"])
            v, i = torch.sort(counts.reshape(counts.shape[0], -1), dim=1,
                              descending=True, stable=True)
            return v[:, :c["k"]], i[:, :c["k"]]

        n_bytes = n_ops = 0
        for c in cs:
            got, want = call(c), plain(c)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{what} Q={c['cids'].shape[0]} "
                                     f"k={c['k']}: differs from plain")
            # as check_hit_count_topk: the probed clusters' valid rows and
            # valid codes, the tables, cids, the (Q, k) outputs
            rows_ = torch.unique(c["cids"])
            n_bytes += (rows_.numel() * c["valid"].shape[1]
                        + int(c["valid"][rows_].sum()) * c["S"]
                        + c["table"].numel() + c["cids"].numel() * 8
                        + 12 * c["cids"].shape[0] * c["k"])
            n_ops += int(c["valid"][c["cids"]].sum()) * c["S"]
        bnd, by = bound_ms(n_bytes, n_ops)

        def whole_pass():
            for c in cs:
                call(c)

        split = {k: kernel_us(whole_pass, kname, reps=5)
                 for k, kname in (("count", "hit_count_kernel"),
                                  ("select", "hit_topk_kernel"))}
        rows.append({
            "route": "top-k", "tier": "M/L" if n_probe == 8 else "composed H2",
            "index": name, "shape": "engine pass", "calls": len(cs),
            "np": n_probe, "S": cs[0]["S"], "max_abs_err": 0.0,
            "ms": sum(time_ms(lambda c=c: call(c)) for c in cs),
            "plain_ms": sum(time_ms(lambda c=c: plain(c), reps=5) for c in cs),
            "count_sort_ms": sum(time_ms(lambda c=c: count_sort(c))
                                 for c in cs),
            "library_ms": None,
            "count_ms": None if split["count"] is None
            else split["count"] * len(cs) / 1e3,
            "select_ms": None if split["select"] is None
            else split["select"] * len(cs) / 1e3,
            "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
            "calls_shape": hit_call_summary(cs)[f"np{n_probe}"]})
    return rows


def check_pq_scan(q: int, n_probe: int, p: int, s: int, e: int,
                  n_clusters: int, metric: str, gen) -> dict:
    """The scores-only ``pq_scan`` kernel against its plain version, timed
    beside it and the ``embedding_bag`` yardstick; one kernel a call."""
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

    def call():
        return pqs.pq_scan(lut, codes, valid, cids, metric=metric)

    out = {"route": "scores", "metric": metric, "Q": q, "np": n_probe,
           "P": p, "S": s, "E": e, "max_abs_err": err, "ms": time_ms(call),
           "plain_ms": time_ms(lambda: pqs.pq_scan_plain(
               lut, codes[cids], valid[cids], metric=metric)),
           "library_ms": time_ms(lib),
           "scan_us": kernel_us(call, "pq_scan_kernel"),
           "kernels_a_call": _hit_kernels(
               lambda: ops.masked_adc_scan(lut, codes, valid, cids,
                                           metric=metric),
               ("pq_scan_kernel",), what),
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes, **need}
    del lib
    return out


def _pq_topk_close(got: tuple, own: tuple, plain: torch.Tensor,
                   scale: torch.Tensor, k: int, metric: str,
                   what: str) -> float:
    """Hold the top-k route's (values, positions) to ``own``, the stable
    sort of the scores-only kernel's output plus the offset (bit-equal,
    sign bits too), and to the plain (Q, np·P) scores ``plain`` (each
    value within ``RTOL`` of ``scale``, the sum of its terms' magnitudes
    plus |offset|, of plain's value at the same place and of plain's score
    at its own position: positions differ from plain's only inside ties;
    the ±inf places equal). Returns the largest difference from plain."""
    if not (torch.equal(got[0], own[0]) and torch.equal(got[1], own[1])
            and torch.equal(torch.signbit(got[0]), torch.signbit(own[0]))):
        raise AssertionError(
            f"{what}: {int((got[1] != own[1]).sum())} positions and "
            f"{int((got[0] != own[0]).sum())} values differ from the stable "
            f"sort of the scores kernel's own output")
    want = pqs._sorted_top(plain, k, metric)
    fin = torch.isfinite(want[0])
    if not (torch.equal(torch.isfinite(got[0]), fin)
            and torch.equal(got[0][~fin], want[0][~fin])
            and torch.equal(got[1][~fin], want[1][~fin])):
        raise AssertionError(f"{what}: ±inf places differ from plain")
    tol = RTOL * torch.maximum(torch.gather(scale, 1, got[1]),
                               torch.gather(scale, 1, want[1]))
    err = (got[0] - want[0]).abs()
    err_own = (got[0] - torch.gather(plain, 1, got[1])).abs()
    if (err[fin] > tol[fin]).any() or (err_own[fin] > tol[fin]).any():
        raise AssertionError(f"{what}: values beyond rtol {RTOL} of plain, "
                             f"or positions that differ outside ties")
    return float(err[fin].max()) if fin.any() else 0.0


def _pq_need(lut, valid, cids, probe_ok, base, k: int) -> tuple[int, int]:
    """What one top-k call must move and do: the bytes of the kept
    probes' distinct clusters' valid rows and valid points' codes (once),
    the kept probes' f32 LUTs, cids and offsets, ``probe_ok``, the (Q, k)
    outputs (a pruned probe's LUT, codes and valid row are never read; the
    scores, 4·Q·np·P bytes, are not written), and the adds (one a kept
    valid point and subspace)."""
    q, _, s, e = lut.shape
    kept = cids if probe_ok is None else cids[probe_ok]
    rows_ = torch.unique(kept)
    n_bytes = (rows_.numel() * valid.shape[1] + int(valid[rows_].sum()) * s
               + kept.numel() * (4 * s * e + 8 + (0 if base is None else 4))
               + (0 if probe_ok is None else probe_ok.numel())
               + 12 * q * k)
    return n_bytes, int(valid[kept].sum()) * s


def _pq_plain(lut, codes, valid, cids, probe_ok, base, metric):
    """The plain (Q, np·P) scores (plus the offset) and the sums of their
    terms' magnitudes (plus |offset|) of one call."""
    q = lut.shape[0]
    v = valid[cids] if probe_ok is None else valid[cids] & probe_ok[..., None]
    plain = pqs.pq_scan_plain(lut, codes[cids], v, metric=metric)
    scale = pqs.pq_scan_plain(lut.abs(), codes[cids], v)
    if base is not None:
        plain = plain + base[..., None]
        scale = scale + base.abs()[..., None]
    return plain.reshape(q, -1), scale.reshape(q, -1)


def check_pq_scan_topk(q: int, n_probe: int, p: int, s: int, e: int,
                       n_clusters: int, k: int, metric: str, gen, *,
                       layout: str = "random", lut_kind: str = "random",
                       pruned: bool = False) -> dict:
    """Tier H's top-k route (``pq_scan_topk``: the per-probe select
    kernel, then the per-query merge kernel) at ip with stage A's offset
    ``probe_base``: bit-equal to the stable sort of its own scores-only
    output plus the offset, and close to plain (``_pq_topk_close``).
    ``layout``: the valid slots at random (a quarter), ``packed`` at the
    front of each cluster, or ``few`` (0.1%: about 63 a query at np 16,
    fewer than k = 100, so the ±inf sentinel's ties fill the quota); ``lut_kind`` ``integer``: the
    LUT holds 0, 1, 2 only, so exact ties cross probes; ``pruned``: every
    probe but 0 pruned. Timed beside the plain version, ``scan_sort_ms``
    (the scores kernel, the add, a stable sort and a slice: the route
    before the top-k kernels) and the library's calls (``embedding_bag``,
    a stable sort and a slice), with the profiler's µs of the two kernels
    and two kernels a call by capture."""
    dev = torch.device("cuda")
    if lut_kind == "integer":
        lut = torch.randint(0, 3, (q, n_probe, s, e), generator=gen,
                            device=dev).float()
    else:
        lut = _lut(q, n_probe, s, e, metric, gen)
    base = (torch.randn((q, n_probe), generator=gen, device=dev)
            if metric == "ip" else None)
    codes, valid, cids, need = _scan_index(
        q, n_probe, p, s, e, n_clusters, gen, packed=layout == "packed",
        share=0.001 if layout == "few" else 0.25)
    pok = None
    if pruned:
        pok = torch.zeros((q, n_probe), dtype=torch.bool, device=dev)
        pok[:, 0] = True
    what = (f"pq_scan_topk {metric} Q={q} np={n_probe} S={s} k={k} {layout}"
            f"{' integer LUT' if lut_kind == 'integer' else ''}"
            f"{' pruned' if pruned else ''}")

    def call():
        return pqs.pq_scan_topk(lut, codes, valid, cids, k, metric=metric,
                                probe_ok=pok, probe_base=base)

    def scan_sort():
        return pqs.pq_scan_sort_topk(lut, codes, valid, cids, k,
                                     metric=metric, probe_ok=pok,
                                     probe_base=base)

    got, own = call(), scan_sort()
    plain, scale = _pq_plain(lut, codes, valid, cids, pok, base, metric)
    torch.cuda.synchronize()
    err = _pq_topk_close(got, own, plain, scale, k, metric, what)
    sentinel = int((~torch.isfinite(got[0])).sum())
    if layout == "few" and not sentinel:
        raise AssertionError(f"{what}: no sentinel ties in the top k")
    del plain, scale
    bag = _bag_call(lut, codes, cids)

    def library():
        v = bag().reshape(q, -1)
        return pqs._sorted_top(v, k, metric)

    n_bytes, n_ops = _pq_need(lut, valid, cids, pok, base, k)
    bnd, by = bound_ms(n_bytes, n_ops)
    kk = min(k, p)
    out = {"route": "top-k", "metric": metric, "Q": q, "np": n_probe,
           "P": p, "S": s, "E": e, "k": k, "valid": layout, "lut": lut_kind,
           "pruned": pruned, "sentinel_results": sentinel,
           "max_abs_err": err, "ms": time_ms(call),
           "plain_ms": time_ms(lambda: pqs.pq_scan_topk_plain(
               lut, codes[cids], valid[cids] if pok is None
               else valid[cids] & pok[..., None], k, metric=metric,
               probe_base=base), reps=5),
           "library_ms": time_ms(library),
           "library": "embedding_bag + sort(stable) + slice: two library "
                      "calls, the valid mask and offset left out",
           "scan_sort_ms": time_ms(scan_sort),
           "scan_sort": "pq_scan kernel + add + sort(stable) + slice",
           "topk_us": kernel_us(call, "pq_topk_kernel"),
           "merge_us": kernel_us(call, "pq_merge_kernel"),
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
           # what the route also moves: the candidates, written and read
           "bound_with_candidates_ms": bound_ms(
               n_bytes + 16 * q * n_probe * kk, n_ops)[0],
           "kernels_a_call": _hit_kernels(
               lambda: ops.masked_adc_topk_scan(
                   lut, codes, valid, cids, k, metric=metric, probe_ok=pok,
                   probe_base=base),
               ("pq_topk_kernel", "pq_merge_kernel"), what),
           **need}
    del bag
    return out


def check_pq_scan_pass(name: str, calls: list[dict]) -> list[dict]:
    """Tier H's top-k route over the calls of one engine pass, replayed on
    their recorded inputs (the built index's codes and valid slots, stage
    B's LUTs, the probed cluster ids, k, probe_ok, the offsets): each call
    bit-equal to the route it took before this PR
    (``pq_scan_sort_topk``: the scores kernel, the add, a stable sort, a
    slice) and close to plain;
    device ms (CUDA events, a call at a time), the profiler's select- and
    merge-kernel ms, the plain version's and ``scan_sort_ms``, and the
    bound, summed over the pass's calls."""
    if not calls:
        return []
    what = f"pq_scan_topk {name} engine pass"

    def call(c):
        return pqs.pq_scan_topk(c["lut"], c["codes"], c["valid"], c["cids"],
                                c["k"], metric=c["metric"],
                                probe_ok=c["probe_ok"],
                                probe_base=c["probe_base"])

    def scan_sort(c):
        return pqs.pq_scan_sort_topk(c["lut"], c["codes"], c["valid"],
                                     c["cids"], c["k"], metric=c["metric"],
                                     probe_ok=c["probe_ok"],
                                     probe_base=c["probe_base"])

    def plain(c):
        v = c["valid"][c["cids"]]
        if c["probe_ok"] is not None:
            v = v & c["probe_ok"][..., None]
        return pqs.pq_scan_topk_plain(c["lut"], c["codes"][c["cids"]], v,
                                      c["k"], metric=c["metric"],
                                      probe_base=c["probe_base"])

    n_bytes = n_ops = 0
    err = 0.0
    for c in calls:
        pl, sc = _pq_plain(c["lut"], c["codes"], c["valid"], c["cids"],
                           c["probe_ok"], c["probe_base"], c["metric"])
        err = max(err, _pq_topk_close(
            call(c), scan_sort(c), pl, sc, c["k"], c["metric"],
            f"{what} Q={c['cids'].shape[0]} k={c['k']}"))
        del pl, sc
        b, o = _pq_need(c["lut"], c["valid"], c["cids"], c["probe_ok"],
                        c["probe_base"], c["k"])
        n_bytes, n_ops = n_bytes + b, n_ops + o
    bnd, by = bound_ms(n_bytes, n_ops)

    def whole_pass():
        for c in calls:
            call(c)

    split = {k: kernel_us(whole_pass, kname, reps=5)
             for k, kname in (("select", "pq_topk_kernel"),
                              ("merge", "pq_merge_kernel"))}
    return [{
        "route": "top-k", "tier": "H", "index": name, "shape": "engine pass",
        "calls": len(calls), "np": calls[0]["cids"].shape[1],
        "S": calls[0]["S"], "max_abs_err": err,
        "equal_to_route_before": True,
        "ms": sum(time_ms(lambda c=c: call(c)) for c in calls),
        "plain_ms": sum(time_ms(lambda c=c: plain(c), reps=3) for c in calls),
        "scan_sort_ms": sum(time_ms(lambda c=c: scan_sort(c))
                            for c in calls),
        "library_ms": None,
        "select_ms": None if split["select"] is None
        else split["select"] * len(calls) / 1e3,
        "merge_ms": None if split["merge"] is None
        else split["merge"] * len(calls) / 1e3,
        "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
        "calls_shape": hit_call_summary(calls)}]


def save_calls(path: str, calls: list[dict]) -> None:
    """Write recorded calls, tables included, for ``bench_stage_a.py
    --hit-count --calls`` or ``--pq-scan --calls``: the index's codes and
    valid mask once, then each call's table (hit table or LUT), cids, k,
    probe_ok and the rest, on the host."""
    torch.save({"codes": calls[0]["codes"].cpu(),
                "valid": calls[0]["valid"].cpu(),
                "calls": [{k: (v.cpu() if torch.is_tensor(v) else v)
                           for k, v in c.items() if k not in ("codes", "valid")}
                          for c in calls]}, path)


def _grid(g: int, cap: int, gen) -> tuple:
    """A synthetic centroid grid on the card with the build's invariants:
    g×g cells of ``cap`` slots over the unit square, each cell filled to a
    random count (the first empty, the last full), slot centroids inside
    their cell, ``-inf`` reach at pad slots. Returns (c0, c1, reach) as
    (g·g, cap) f32 and the flat indices of the real slots."""
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


def _slot_gap(q0, q1, c0, c1, reach, slots) -> torch.Tensor:
    """|q − c| − reach at the given slots (Q, n), in float64."""
    dx = q0.double()[:, None] - c0.reshape(-1)[slots].double()
    dy = q1.double()[:, None] - c1.reshape(-1)[slots].double()
    return torch.sqrt(dx * dx + dy * dy) - reach.reshape(-1)[slots].double()


def _sphere_row(args: tuple, **info) -> dict:
    """``sphere_hits`` against its plain version on ``args`` (q0, q1,
    radius, c0, c1, reach): hits equal, then timed beside its bound."""
    got = sph.sphere_hits(*args)
    want = sph.sphere_hits_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"sphere_hits {info}: {int((got != want).sum())} "
                             f"hits differ from plain")
    q = args[0].shape[0]
    n_cells, cap = args[3].shape
    n_slots = n_cells * cap
    # bytes: queries and radii, the three slot planes, the int8 table;
    # operations: two subtractions, three multiplies (one fused add), one
    # add per (query, slot)
    n_bytes = 4 * 3 * q + 4 * 3 * n_slots + q * n_slots
    bnd, by = bound_ms(n_bytes, 7 * q * n_slots)
    return {**info, "Q": q, "cells": n_cells, "cap": cap, "max_abs_err": 0.0,
            "hit_share": float(got.float().mean()),
            "ms": time_ms(lambda: sph.sphere_hits(*args)),
            "plain_ms": time_ms(lambda: sph.sphere_hits_plain(*args)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "bytes": n_bytes}


def check_sphere_hits(q: int, g: int, cap: int, gen) -> dict:
    """The sphere test over a synthetic grid with pads and an empty cell;
    radii 0, 1e6, on a slot's disc boundary, and in a calibrated-like
    range (a few cells' width)."""
    dev = torch.device("cuda")
    c0, c1, reach, real = _grid(g, cap, gen)
    q0 = torch.rand((q,), generator=gen, device=dev) * 1.4 - 0.2
    q1 = torch.rand((q,), generator=gen, device=dev) * 1.4 - 0.2
    radius = torch.rand((q,), generator=gen, device=dev) * (4.0 / g)
    a = q // 4
    radius[:a] = 0.0
    radius[a:2 * a] = FULL
    pick = real[torch.randint(0, real.numel(), (a,), generator=gen,
                              device=dev)]
    gap = _slot_gap(q0[2 * a:3 * a], q1[2 * a:3 * a], c0, c1, reach,
                    pick[:, None])[:, 0]
    radius[2 * a:3 * a] = gap.float()                   # on the boundary
    return _sphere_row((q0, q1, radius, c0, c1, reach), grid="synthetic")


def check_sphere_hits_on_grid(name: str, index, grid, queries, metric: str,
                              q: int = 128) -> dict:
    """The sphere test as the search calls it on the index's own grid (the
    main path's ``cap``): one batch of real queries at ``rt_scale`` 1."""
    qb = torch.from_numpy(queries[:q]).to(index.ivf.centroids.device)
    _, tau = _probe_tau(index, qb, metric, 16)
    qp = qb @ grid.proj
    return _sphere_row((qp[:, 0].contiguous(), qp[:, 1].contiguous(),
                        rt.query_radius(grid, tau[:, 0]), grid.cell_c0,
                        grid.cell_c1, grid.slot_reach), grid=f"{name} index")


def _probe_row(args: tuple, scale: float, **info) -> dict:
    """The probe entry against its plain version on ``args`` (q0, q1, τ
    row, cids, slot_of, c0, c1, reach, radius_scale, radius_bias):
    ``probe_ok``, radius and slots equal, and the verdicts equal to the
    dense kernel's table at that radius gathered at the slots; then timed
    beside its bound, the plain version, the launch floor (an empty kernel
    on the same grid, timed the same way), both kernels' own µs
    (profiler) and one kernel a call by capture."""
    dev = args[0].device
    got = sph.sphere_probe(*args, scale)
    want = sph.sphere_probe_plain(*args, scale)
    dense = sph.sphere_hits(args[0].contiguous(), args[1].contiguous(),
                            got[1], *args[5:8])
    torch.cuda.synchronize()
    what = f"sphere_probe {info}"
    for name, a, b in zip(("probe_ok", "radius", "slot"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs from plain in "
                                 f"{int((a != b).sum())} places")
    gathered = torch.gather(dense, 1, got[2].long()) > 0
    gathered[:, 0] = True
    if not torch.equal(got[0], gathered):
        raise AssertionError(f"{what}: probe_ok != the dense table gathered")
    q, n_probe = args[3].shape
    s = args[2].shape[1]
    # bytes: each probe's cid, slot_of entry, three slot-plane reads, its
    # verdict and its slot; the τ row, the query, the two grid scalars and
    # the radius. operations: a square and an add a (query, subspace) in
    # f64; seven a probe and four a radius in f32
    n_bytes = (q * n_probe * (args[3].element_size() + 4 + 12 + 1 + 4)
               + q * s * 4 + q * 8 + 8 + q * 4)
    bnd, by = bound_ms(n_bytes, 7 * q * n_probe + 4 * q, 2 * q * s)

    def call():
        return ops.rt_probe_mask(*args, scale=scale)

    nodes = captured_kernels(call)
    if len(nodes) != 1 or "sphere_probe_kernel" not in nodes[0]:
        raise AssertionError(f"{what}: a call is {nodes}, not one kernel")
    return {**info, "entry": "sphere_probe", "Q": q, "np": n_probe, "S": s,
            "cells": args[5].shape[0], "cap": args[5].shape[1],
            "scale": scale, "max_abs_err": 0.0,
            "probes_kept": float(got[0].float().mean()),
            "ms": time_ms(call),
            "launch_floor_ms": time_ms(lambda: sph.sphere_floor(q, dev)),
            "kernel_us": kernel_us(call, "sphere_probe_kernel"),
            "floor_kernel_us": kernel_us(lambda: sph.sphere_floor(q, dev),
                                         "sphere_floor_kernel"),
            "plain_ms": time_ms(lambda: sph.sphere_probe_plain(*args, scale)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "bytes": n_bytes, "kernels_a_call": len(nodes)}


def check_sphere_probe(q: int, n_probe: int, s: int, g: int, cap: int,
                       scale: float, gen) -> dict:
    """The probe entry over a synthetic grid with pads and an empty cell:
    every real slot one cluster's, random probed clusters, τ the probe-0
    row of a (Q, np, S) tensor and q0, q1 a (Q, 2) tensor's columns, as
    the search passes them."""
    dev = torch.device("cuda")
    c0, c1, reach, real = _grid(g, cap, gen)
    slot_of = real[torch.randperm(real.numel(), generator=gen,
                                  device=dev)].to(torch.int32)
    cids = torch.randint(0, real.numel(), (q, n_probe), generator=gen,
                         device=dev)
    qp = torch.rand((q, 2), generator=gen, device=dev) * 1.4 - 0.2
    tau = torch.rand((q, n_probe, s), generator=gen, device=dev) * 0.02
    scalars = (torch.tensor(0.4, device=dev), torch.tensor(-0.01, device=dev))
    return _probe_row((qp[:, 0], qp[:, 1], tau[:, 0], cids, slot_of, c0, c1,
                       reach, *scalars), scale, grid="synthetic")


def check_sphere_probe_on_grid(name: str, index, grid, queries, metric: str,
                               n_probe: int, q: int = 128) -> dict:
    """The probe entry as the search calls it on the index's own grid: a
    batch of real queries at ``rt_scale`` 1, τ over every probe as stage B
    has it; also the search's whole ``_rt_probe`` (the projection GEMM and
    the probe kernel, which both rt paths run) held to two kernels a call
    by capture, and its time."""
    qb = torch.from_numpy(queries[:q]).to(index.ivf.centroids.device)
    _, cids = filter_clusters(qb, index.ivf, nprobe=n_probe, metric=metric)
    m = index.codebook.sub_dim
    res = (qb[:, None, :] - index.ivf.centroids[cids] if metric == "l2"
           else qb[:, None, :].expand(q, n_probe, -1))
    tau = density_lib.predict_threshold(
        index.density, res.reshape(q, n_probe, -1, m))       # (Q, np, S)
    qp = qb @ grid.proj
    row = _probe_row((qp[:, 0], qp[:, 1], tau[:, 0], cids, grid.slot_of,
                      grid.cell_c0, grid.cell_c1, grid.slot_reach,
                      grid.radius_scale, grid.radius_bias), 1.0,
                     grid=f"{name} index")
    nodes = captured_kernels(lambda: _rt_probe_mask(grid, qb, tau, cids, 1.0))
    if len(nodes) != 2 or nodes[0] in ("MEMCPY", "MEMSET") or \
            "sphere_probe_kernel" not in nodes[1]:
        raise AssertionError(f"{name} _rt_probe_mask: {nodes}, not the GEMM "
                             f"and the probe kernel")
    return {**row, "mask_kernels_a_call": len(nodes),
            "mask_nodes": [n[:60] for n in nodes],
            "mask_ms": time_ms(lambda: _rt_probe_mask(grid, qb, tau, cids,
                                                      1.0))}


def check_fused_three_stage(q: int, n_probe: int, p: int, s: int, e: int,
                            n_clusters: int, cap_c: int, metric: str,
                            coverage: str, gen, distinct: bool = False,
                            packed: bool = False) -> dict:
    """The three-stage kernel at the fused shapes with a 256-cell grid:
    ``coverage`` "half" sets each query's radius to the median of its
    probes' disc gaps (about half survive), "probe0" to -1e6 (only the
    forced probe 0), "full" to 1e6 (every probe; then the outputs must be
    the two-stage kernel's). ``distinct``: no cluster probed twice in the
    batch (``n_clusters`` >= Q·np); ``packed``: the valid slots at the
    front of each cluster (``_scan_index``). q0 and q1 are the columns of a (Q, 2)
    tensor, as the engine passes them; through ``ops`` the call must be
    two kernels."""
    dev = torch.device("cuda")
    lut = _lut(q, n_probe, s, e, metric, gen)
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                          device=dev, dtype=torch.int8)
    codes, valid, cids, _ = _scan_index(q, n_probe, p, s, e, n_clusters, gen,
                                        distinct, packed)
    c0, c1, reach, real = _grid(16, 64, gen)
    slot_idx = real[torch.randint(0, real.numel(), (q, n_probe),
                                  generator=gen, device=dev)].to(torch.int32)
    qp2 = torch.rand((q, 2), generator=gen, device=dev)
    q0, q1 = qp2[:, 0], qp2[:, 1]
    gap = _slot_gap(q0, q1, c0, c1, reach, slot_idx.long())
    radius = {"half": torch.median(gap, dim=1).values.float(),
              "probe0": torch.full((q,), -FULL, device=dev),
              "full": torch.full((q,), FULL, device=dev)}[coverage]
    sphere = (q0, q1, radius, c0, c1, reach, slot_idx)
    kw = dict(cap_c=cap_c, metric=metric)
    got = f3s.fused_three_stage(lut, table, codes, valid, cids, *sphere, **kw)
    want = f3s.fused_three_stage_plain(lut, table, codes[cids], valid[cids],
                                       *sphere, **kw)
    scale = f3s.fused_three_stage_plain(lut.abs(), table, codes[cids],
                                        valid[cids], *sphere, **kw)
    torch.cuda.synchronize()
    what = (f"fused_three_stage {metric} Q={q} S={s} C={cap_c} {coverage}"
            f"{' packed' if packed else ''}")
    if not all(torch.equal(got[i], want[i]) for i in (0, 2, 4)):
        raise AssertionError(f"{what}: counts, cand or probe_ok differ")
    err = _assert_sums_close(got[3], want[3], scale[3], what + " cand_dist")
    _assert_sums_close(got[1], want[1], scale[1], what + " dist")
    if coverage == "full":
        two = fts.fused_two_stage(lut, table, codes, valid, cids, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got[:4], two)):
            raise AssertionError(f"{what}: != fused_two_stage at full coverage")
    probe_ok = got[4]
    # bytes the work needs: the kept probes' distinct clusters' valid rows
    # and valid points' codes, their int8 tables, each probe's slot planes,
    # the LUT at the C candidates, the outputs once
    kept_rows = torch.unique(cids[probe_ok])
    kept_valid = valid[cids] & probe_ok[..., None]
    n_kept = int(kept_valid.sum())
    w = n_probe * p
    n_bytes = (kept_rows.numel() * p + int(valid[kept_rows].sum()) * s
               + int(probe_ok.sum()) * s * e + q * n_probe * (8 + 4 + 12)
               + 12 * q + q * cap_c * s * 4 + q * w * 8 + q * cap_c * 8
               + q * n_probe)
    bnd, by = bound_ms(n_bytes, n_kept * s + q * cap_c * s)

    def call():
        return f3s.fused_three_stage(lut, table, codes, valid, cids, *sphere,
                                     **kw)

    return {"metric": metric, "coverage": coverage,
            "cids": "distinct" if distinct else "repeated",
            "valid": "packed" if packed else "random", "Q": q,
            "np": n_probe, "P": p, "S": s, "E": e, "C": cap_c,
            "max_abs_err": err,
            "probes_kept": float(probe_ok.float().mean()),
            "ms": time_ms(call),
            "plain_ms": time_ms(lambda: f3s.fused_three_stage_plain(
                lut, table, codes[cids], valid[cids], *sphere, **kw)),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "bytes": n_bytes, "kept_valid_points": n_kept,
            **_scan_split(call, q, w),
            "kernels_a_call": _two_kernels(
                lambda: ops.fused_three_stage_scan(lut, table, codes, valid,
                                                   cids, *sphere, **kw),
                what)}


def check_ivf_filter(q: int, c: int, d: int, metric: str, gen) -> dict:
    """The ``ivf_filter`` kernel against its plain version: every score
    within 1e-5 of ``Σ_d |q_d c_d|`` (twice that for l2) plus the csq
    term's ulp, and the top-16 ids equal except where the 16th and 17th
    scores lie within that bound. Timed beside ``torch.addmm`` (l2) or
    ``torch.mm`` (ip), which compute the same matrix."""
    dev = torch.device("cuda")
    qs = torch.randn((q, d), generator=gen, device=dev)
    cent = torch.randn((c, d), generator=gen, device=dev)
    csq = torch.sum(cent * cent, dim=-1)
    got = ivff.ivf_filter(qs, cent, csq, metric=metric)
    want = ivff.ivf_filter_plain(qs, cent, csq, metric=metric)
    torch.cuda.synchronize()
    bound = _matrix_bound(qs, cent, csq, metric)
    err = (got - want).abs()
    what = f"ivf_filter {metric} Q={q} C={c} D={d}"
    if (err > bound).any():
        raise AssertionError(f"{what}: {int((err > bound).sum())} scores "
                             f"beyond their bound")
    key, key_p = (-got, -want) if metric == "l2" else (got, want)
    ids = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :16]
    srt, ids_p = torch.sort(key_p, dim=1, descending=True, stable=True)
    tie = (srt[:, 15] - srt[:, 16]).abs() <= bound.max(dim=1).values
    same = (torch.sort(ids, dim=1).values
            == torch.sort(ids_p[:, :16], dim=1).values).all(dim=1)
    if not (same | tie).all():
        raise AssertionError(f"{what}: top-16 ids differ away from a tie")

    def library():
        if metric == "l2":
            return torch.addmm(csq[None, :], qs, cent.T, alpha=-2.0)
        return torch.mm(qs, cent.T)

    n_bytes = 4 * (q * d + c * d + c + q * c)
    bnd, by = bound_ms(n_bytes, 2 * q * c * d)
    return {"metric": metric, "Q": q, "C": c, "D": d,
            "max_abs_err": float(err.max()),
            "top16_rows_tied": int((~same).sum()),
            "ms": time_ms(lambda: ivff.ivf_filter(qs, cent, csq,
                                                  metric=metric)),
            "plain_ms": time_ms(lambda: ivff.ivf_filter_plain(
                qs, cent, csq, metric=metric)),
            "library_ms": time_ms(library),
            "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}


def _matrix_bound(qs, cent, csq, metric: str) -> torch.Tensor:
    """``check_ivf_filter``'s per-score bound of the kernel against the
    plain matrix."""
    bound = (2.0 if metric == "l2" else 1.0) * RTOL * (qs.abs() @ cent.abs().T)
    if metric == "l2":
        bound = bound + torch.finfo(torch.float32).eps * csq.abs()[None]
    return bound


def check_ivf_filter_topk(q: int, c: int, d: int, nprobe: int, metric: str,
                          gen, *, dup: bool = False) -> dict:
    """The ``ivf_filter`` kernel's top-nprobe epilogue against its plain
    version (the plain matrix, a stable sort, a slice): each returned score
    within the matrix rows' bound of the plain score at its id; ids equal
    except in rows where the nprobe-th and (nprobe+1)-th plain scores lie
    within that bound; with repeated centroids (``dup``: exact ties) ids
    equal, index-ascending. Timed beside the plain version, the library's
    two calls (``addmm``/``mm``, then ``torch.sort(stable=True)`` and the
    slice; at nprobe 1 ``addmm``/``mm``, then ``min``/``max`` along the
    row, which keeps the first extremum) and this tree's matrix kernel
    followed by the same sort and slice (``matrix_sort_ms``, the route
    stage A took before the epilogue)."""
    dev = torch.device("cuda")
    qs = torch.randn((q, d), generator=gen, device=dev)
    cent = torch.randn((c, d), generator=gen, device=dev)
    if dup:
        cent = cent[torch.randint(0, c // 3, (c,), generator=gen, device=dev)]
    csq = torch.sum(cent * cent, dim=-1)
    got_s, got_i = ivff.ivf_filter_topk(qs, cent, csq, nprobe=nprobe,
                                        metric=metric)
    want_s, want_i = ivff.ivf_filter_topk_plain(qs, cent, csq, nprobe=nprobe,
                                                metric=metric)
    torch.cuda.synchronize()
    plain = ivff.ivf_filter_plain(qs, cent, csq, metric=metric)
    bound = _matrix_bound(qs, cent, csq, metric)
    err = (got_s - plain.gather(1, got_i)).abs()
    what = (f"ivf_filter_topk {metric} Q={q} C={c} D={d} nprobe={nprobe}"
            + (" (repeated centroids)" if dup else ""))
    beyond = err > bound.gather(1, got_i)
    if beyond.any():
        raise AssertionError(f"{what}: {int(beyond.sum())} scores beyond "
                             f"their bound")
    key = -plain if metric == "l2" else plain
    srt = torch.sort(key, dim=1, descending=True, stable=True).values
    tie = (srt[:, nprobe - 1] - srt[:, nprobe]).abs() <= bound.max(dim=1).values
    same = (got_i == want_i).all(dim=1)
    same_set = (torch.sort(got_i, dim=1).values
                == torch.sort(want_i, dim=1).values).all(dim=1)
    if dup:
        if not same.all():
            raise AssertionError(f"{what}: ids differ from the plain version's")
        run = got_s[:, 1:] == got_s[:, :-1]
        if not run.any() or (got_i[:, 1:][run] <= got_i[:, :-1][run]).any():
            raise AssertionError(f"{what}: tied ids not index-ascending")
    elif not (same_set | tie).all():
        raise AssertionError(f"{what}: ids differ away from a tie")

    def library():
        m = (torch.addmm(csq[None, :], qs, cent.T, alpha=-2.0)
             if metric == "l2" else torch.mm(qs, cent.T))
        if nprobe == 1:
            return (torch.min if metric == "l2" else torch.max)(m, dim=1)
        key = -m if metric == "l2" else m
        v, i = torch.sort(key, dim=1, descending=True, stable=True)
        return v[:, :nprobe], i[:, :nprobe]

    def matrix_sort():
        m = ivff.ivf_filter(qs, cent, csq, metric=metric)
        key = -m if metric == "l2" else m
        v, i = torch.sort(key, dim=1, descending=True, stable=True)
        return v[:, :nprobe], i[:, :nprobe]

    n_bytes = 4 * (q * d + c * d + c) + 12 * q * nprobe
    bnd, by = bound_ms(n_bytes, 2 * q * c * d)
    return {"epilogue": "top-nprobe", "metric": metric, "Q": q, "C": c,
            "D": d, "nprobe": nprobe, "repeated_centroids": dup,
            "max_abs_err": float(err.max()),
            "rows_not_identical": int((~same).sum()),
            "rows_other_set_tied_at_nprobe": int((~same_set).sum()),
            "ms": time_ms(lambda: ivff.ivf_filter_topk(
                qs, cent, csq, nprobe=nprobe, metric=metric)),
            "plain_ms": time_ms(lambda: ivff.ivf_filter_topk_plain(
                qs, cent, csq, nprobe=nprobe, metric=metric)),
            "library_ms": time_ms(library),
            "library": ("addmm" if metric == "l2" else "mm")
            + (" + min/max along the row" if nprobe == 1 else
               " + sort(stable) + slice") + ": two library calls",
            "matrix_sort_ms": time_ms(matrix_sort),
            "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}


def phase_kernels(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # stage B: the three shapes of earlier runs (l2 first: the line's
    # head), the engines' batch sizes (Q bucket x nprobe), and the ip route
    rows = {"selective_lut": [
        check_selective_lut(metric, b, s, 256, gen)
        for metric, b, s in (("l2", 2048, 48), ("ip", 2048, 48),
                             ("ip", 2048, 100), ("l2", 128, 48),
                             ("ip", 512, 100), ("ip", 4096, 100))]}
    rows["selective_lut"].append(check_stage_b_route(128, 16, 100, 256, gen))
    torch.cuda.empty_cache()
    # stage C: the Q = 128 rows of earlier runs first (l2 C = 320 heads the
    # line), then the engine's smaller batch buckets, Q = 32 and 8, at C = 320
    rows["fused_two_stage"] = [
        check_fused_two_stage(q, 16, 3912, s, 256, 1024, c, metric, gen)
        for q, cs in ((128, (320, 3200)), (32, (320,)), (8, (320,)))
        for metric, s in (("l2", 48), ("ip", 100)) for c in cs]
    # tier H: the top-k route the engines run (l2 k = 100 heads the line),
    # at k 10 and 100, ip with stage A's offset, smaller batches, packed
    # and few valid slots, an integer LUT (exact ties across probes) and
    # every probe but 0 pruned; then the scores-only kernel at the two
    # shapes of earlier runs
    rows["pq_scan"] = [
        check_pq_scan_topk(q, 16, 3912, s, 256, 1024, k, metric, gen,
                           layout=layout, lut_kind=lut, pruned=pruned)
        for q, metric, s, k, layout, lut, pruned in (
            (128, "l2", 48, 100, "random", "random", False),
            (128, "l2", 48, 10, "random", "random", False),
            (128, "ip", 100, 100, "random", "random", False),
            (128, "ip", 100, 10, "random", "random", False),
            (32, "l2", 48, 100, "random", "random", False),
            (8, "l2", 48, 100, "random", "random", False),
            (32, "ip", 100, 100, "random", "random", False),
            (8, "ip", 100, 100, "random", "random", False),
            (128, "l2", 48, 100, "packed", "random", False),
            (128, "ip", 100, 100, "packed", "random", False),
            (128, "l2", 48, 100, "few", "random", False),
            (128, "l2", 48, 100, "random", "integer", False),
            (128, "ip", 100, 100, "random", "integer", False),
            (128, "l2", 48, 100, "random", "random", True),
            (128, "ip", 100, 10, "packed", "random", True))]
    torch.cuda.empty_cache()
    rows["pq_scan"] += [check_pq_scan(128, 16, 3912, s, 256, 1024, metric,
                                      gen)
                        for metric, s in (("l2", 48), ("ip", 100))]
    torch.cuda.empty_cache()
    # tiers M, L and composed H2: the top-k route the engines run (M/L l2,
    # k = 100, heads the line), at the engines' k and C, smaller batches,
    # packed valid slots and sentinel ties; then the counts-only kernel
    rows["hit_count"] = [
        check_hit_count_topk(q, n_probe, 3912, s, 256, 1024, k, label, gen,
                             packed=packed, few=few)
        for q, n_probe, s, k, label, packed, few in (
            (128, 8, 48, 100, "M/L l2", False, False),
            (128, 8, 48, 10, "M/L l2", False, False),
            (128, 8, 100, 100, "M/L ip", False, False),
            (128, 8, 100, 10, "M/L ip", False, False),
            (128, 16, 48, 40, "composed H2 l2", False, False),
            (128, 16, 48, 400, "composed H2 l2", False, False),
            (32, 8, 48, 100, "M/L l2", False, False),
            (8, 8, 48, 100, "M/L l2", False, False),
            (32, 16, 48, 400, "composed H2 l2", False, False),
            (8, 16, 48, 400, "composed H2 l2", False, False),
            (128, 8, 48, 100, "M/L l2", True, False),
            (128, 8, 100, 100, "M/L ip", True, False),
            (128, 16, 48, 400, "composed H2 l2", True, False),
            (128, 8, 48, 100, "M/L l2", False, True))]
    torch.cuda.empty_cache()
    rows["hit_count"] += [
        dict(route="counts",
             **check_hit_count(128, n_probe, 3912, s, 256, 1024, label, gen))
        for label, n_probe, s in (("M/L l2", 8, 48), ("M/L ip", 8, 100),
                                  ("composed H2 l2", 16, 48))]
    torch.cuda.empty_cache()
    # the probe entry (the rt search's) at the engines' np 16 and 8, S 48
    # and 100, the grids' caps, Q 128, 32 and 8, scale 1, 0 and 1e6; then
    # the dense entry
    rows["sphere_hits"] = [
        check_sphere_probe(q, n_probe, s, 16, cap, scale, gen)
        for q, n_probe, s, cap, scale in (
            (128, 16, 48, 88, 1.0), (128, 8, 100, 176, 1.0),
            (32, 16, 48, 88, 1.0), (8, 16, 48, 88, 1.0),
            (128, 16, 48, 88, 0.0), (128, 16, 48, 88, FULL))]
    rows["sphere_hits"] += [check_sphere_hits(128, 16, 64, gen),
                            check_sphere_hits(128, 16, 32, gen)]
    rows["fused_three_stage"] = [
        check_fused_three_stage(128, 16, 3912, s, 256, 1024, c, metric, cov,
                                gen)
        for metric, s in (("l2", 48), ("ip", 100)) for c in (320, 3200)
        for cov in ("half", "probe0", "full")]
    torch.cuda.empty_cache()
    rows["fused_three_stage"] += [
        check_fused_three_stage(q, 16, 3912, s, 256, 1024, 320, metric,
                                "half", gen)
        for q in (32, 8) for metric, s in (("l2", 48), ("ip", 100))]
    # full coverage over 2048 distinct clusters: what re-reading a
    # cluster's codes costs against the rows above, where they repeat
    rows["fused_three_stage"] += [
        check_fused_three_stage(128, 16, 3912, s, 256, 2048, 320, metric,
                                "full", gen, distinct=True)
        for metric, s in (("l2", 48), ("ip", 100))]
    torch.cuda.empty_cache()
    # both scans with the valid slots at the front of each cluster, as the
    # engines' built indexes lay them out (the rows above scatter them)
    rows["fused_two_stage"] += [
        check_fused_two_stage(128, 16, 3912, s, 256, 1024, 320, metric, gen,
                              packed=True)
        for metric, s in (("l2", 48), ("ip", 100))]
    rows["fused_three_stage"] += [
        check_fused_three_stage(128, 16, 3912, s, 256, 1024, 320, metric,
                                "half", gen, packed=True)
        for metric, s in (("l2", 48), ("ip", 100))]
    torch.cuda.empty_cache()
    # stage A of a search batch (D = 96, 200) and of an insert batch: the
    # top-nprobe epilogue the main path runs (its search row first), then
    # the repeated-centroid case, then the matrix epilogue
    rows["ivf_filter"] = [
        check_ivf_filter_topk(128, 1024, d, nprobe, metric, gen)
        for d in (96, 200) for metric in ("l2", "ip")
        for nprobe in (16, 8, 32)]
    rows["ivf_filter"] += [
        check_ivf_filter_topk(1000, 1024, 96, 1, "l2", gen),
        check_ivf_filter_topk(128, 1024, 96, 16, "l2", gen, dup=True)]
    # the streaming build's assignment: one eval batch of 8192 rows at
    # nprobe 1, at the 1M (C 1024) and 10M (C 10240) builds' shapes
    rows["ivf_filter"] += [check_ivf_filter_topk(8192, c, d, 1, "l2", gen)
                           for c, d in ((1024, 96), (10240, 96), (1024, 200))]
    torch.cuda.empty_cache()
    rows["ivf_filter"] += [dict(epilogue="matrix",
                                **check_ivf_filter(q, 1024, d, metric, gen))
                           for q, d in ((128, 96), (128, 200), (1000, 96))
                           for metric in ("l2", "ip")]
    for name, rs in rows.items():
        for r in rs:
            log(f"kernel.{name}", **r)
    return {"kernels": rows}


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


def check_results(ids, scores, n_points: int, what: str, *,
                  rt: bool = False) -> int:
    """Hold one result block to the search's contract: ids lie in
    [0, N) with a finite score, except where the probed clusters held
    fewer than k valid points; such a pad result has id -1 and the
    invalid-slot score (-2^30 as a count, ±inf as a distance or
    similarity), as in the reference. Under the RT prefilter (``rt``) a
    result from a pruned probe carries that sentinel score beside the
    point's real id, as in the reference: there a sentinel score may carry
    -1 or a real id. Returns the number of sentinel results."""
    ids, scores = np.asarray(ids), np.asarray(scores)
    pad = ids < 0
    sentinel = ~np.isfinite(scores) | (scores == NEG)
    wrong = (pad & ~sentinel) if rt else (pad != sentinel)
    if (ids[pad] != -1).any() or (ids >= n_points).any() or wrong.any():
        raise AssertionError(
            f"{what}: {int((pad & ~sentinel).sum())} pad ids with a real "
            f"score, {int((sentinel & ~pad).sum())} real ids with a pad "
            f"score, {int((ids >= n_points).sum())} ids >= N")
    return int(sentinel.sum())


class StageACount:
    """Within ``with``: count the searches' stage-A calls
    (``filter_clusters``, as ``core/juno.py`` and the engines'
    ``serve/ann.py`` call it)."""

    MODULES = (juno_lib, ann_lib)

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        self._fn = juno_lib.filter_clusters

        def counted(*args, **kw):
            self.calls += 1
            return self._fn(*args, **kw)
        for m in self.MODULES:
            m.filter_clusters = counted
        return self

    def __exit__(self, *exc):
        for m in self.MODULES:
            m.filter_clusters = self._fn


def _clone(t):
    return None if t is None else t.clone()


def _hit_call(tables, table, codes, valid, cids, k, *, probe_ok=None):
    return dict(table=table.clone() if tables else None, codes=codes,
                valid=valid, cids=cids.clone(), k=k, S=table.shape[2],
                probe_ok=_clone(probe_ok))


def _pq_call(tables, mlut, codes, valid, cids, k, *, metric="l2",
             probe_ok=None, probe_base=None):
    return dict(lut=mlut.clone() if tables else None, codes=codes,
                valid=valid, cids=cids.clone(), k=k, S=mlut.shape[2],
                metric=metric, probe_ok=_clone(probe_ok),
                probe_base=_clone(probe_base))


class OpsCalls:
    """Within ``with``: record every call of ``ops.<name>`` the searches
    make (``core/juno.py`` calls the kernels through ``ops``):
    ``pick(tables, *args, **kw)`` keeps its probed cluster ids, k,
    ``probe_ok`` and the rest, the index's codes and valid mask it was
    given, and with ``tables`` a copy of its table (hit table or LUT), for
    a replay."""

    def __init__(self, name: str, pick, tables: bool = False):
        self.calls, self._name, self._pick = [], name, pick
        self._tables = tables

    def __enter__(self):
        self._fn = getattr(ops, self._name)

        def recorded(*args, **kw):
            self.calls.append(self._pick(self._tables, *args, **kw))
            return self._fn(*args, **kw)
        setattr(ops, self._name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(ops, self._name, self._fn)


def engine_calls(tables: bool = False) -> dict[str, OpsCalls]:
    """Recorders of the engines' top-k scans, by the key of their summary
    in ``serve_engine``'s line: tiers M, L and composed H2's
    ``hit_count_topk_scan`` calls and tier H's ``masked_adc_topk_scan``
    calls."""
    return {"hit_calls": OpsCalls("hit_count_topk_scan", _hit_call, tables),
            "pq_calls": OpsCalls("masked_adc_topk_scan", _pq_call, tables)}


def _spread(x: torch.Tensor) -> dict:
    x = x.float()
    qs = torch.quantile(x, torch.tensor([0.1, 0.5, 0.9], device=x.device))
    return {"min": float(x.min()), "p10": float(qs[0]), "p50": float(qs[1]),
            "p90": float(qs[2]), "max": float(x.max()), "mean": float(x.mean())}


def hit_call_summary(calls: list[dict]) -> dict:
    """The shapes of recorded ``hit_count_topk_scan`` (or
    ``masked_adc_topk_scan``) calls and the spread of the valid slots in
    the clusters they probed (each probe once), beside that of every
    cluster of the index, by np (8: tiers M and L, 16: composed H2, or
    tier H)."""
    out = {}
    for n_probe in sorted({c["cids"].shape[1] for c in calls}):
        cs = [c for c in calls if c["cids"].shape[1] == n_probe]
        fill = cs[0]["valid"].sum(1)
        out[f"np{n_probe}"] = {
            "calls": len(cs), "rows": sum(c["cids"].shape[0] for c in cs),
            "Q": dict(sorted(collections.Counter(
                c["cids"].shape[0] for c in cs).items())),
            "k": sorted({c["k"] for c in cs}), "S": cs[0]["S"],
            "P": int(cs[0]["valid"].shape[1]),
            "distinct_clusters_a_call": statistics.mean(
                int(torch.unique(c["cids"]).numel()) for c in cs),
            "probed_fill": _spread(torch.cat([fill[c["cids"]].reshape(-1)
                                              for c in cs])),
            "index_fill": _spread(fill)}
    return out


def serve_engine(index, queries, stream, *, metric: str, fused: bool,
                 n_points: int, trace_path: str, rt_grid=None,
                 records: dict[str, OpsCalls] | None = None) -> dict:
    """Warm-up, one pass with the launch counts read, four more timed
    passes and one profiled pass of one engine configuration (with
    ``rt_grid``: ``prefilter="rt"``) over ``index``, a
    ``MutableJunoIndex`` the engines share (its bookkeeping is built
    once). The warm-up, the same stream as every pass, records the
    engine's ``hit_count_topk_scan`` and ``masked_adc_topk_scan`` calls
    (into ``records``, :func:`engine_calls`, if given). The profiled pass must
    run no sort but stage A's and the small final ones
    (``radixSortKVInPlace``): "other sorts" under 1 ms."""
    prefilter = "scan" if rt_grid is None else "rt"

    def serve() -> tuple[AnnServeEngine, list, float]:
        eng = AnnServeEngine(index, metric=metric, fused=fused,
                             prefilter=prefilter, rt_grid=rt_grid)
        reqs = [eng.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                           recall_target=r["recall_target"]) for r in stream]
        t = time.perf_counter()
        eng.run()
        return eng, reqs, time.perf_counter() - t

    records = records or engine_calls()
    with contextlib.ExitStack() as stack:
        for r in records.values():
            stack.enter_context(r)
        serve()                                # warm-up: cuBLAS, allocator
    stage_a = StageACount()
    _build.reset_launches()
    with stage_a:
        eng, reqs, t_serve = serve()
    launches = dict(_build.LAUNCHES)
    if launches["ivf_filter"] != stage_a.calls:
        raise AssertionError(
            f"{prefilter} fused={fused}: {launches['ivf_filter']} ivf_filter "
            f"launches for {stage_a.calls} stage-A calls")
    sentinels = 0
    for r in reqs:
        if not r.done or r.ids.shape != (r.queries.shape[0], r.k):
            raise AssertionError(f"request {r.rid} not served")
        sentinels += check_results(r.ids, r.scores, n_points,
                                   f"request {r.rid}", rt=rt_grid is not None)
    must = ENGINE_KERNELS[(prefilter, fused)]
    if any(launches[n] <= 0 for n in must) or \
            any(launches[n] != 0 for n in set(launches) - must):
        raise AssertionError(f"{prefilter} fused={fused}: launches "
                             f"{launches}, expected exactly {sorted(must)}")
    t_repeats = [t_serve] + [serve()[2] for _ in range(4)]
    prof = profile_window(serve, trace_path)
    if prof["other_sorts_ms"] >= 1.0:
        raise AssertionError(f"{prefilter} fused={fused}: "
                             f"{prof['other_sorts_ms']:.2f} ms of sorts over "
                             f"the scans' outputs in a pass")
    rows = eng.stats["queries"]
    return {"prefilter": prefilter, "fused": fused, "requests": len(reqs),
            "rows": rows, "ticks": eng.stats["ticks"],
            "qps": rows / statistics.median(t_repeats),
            "qps_repeats": [rows / t for t in t_repeats],
            "latency": eng.latency_stats(), "profile": prof,
            "signatures": {str(k): v
                           for k, v in eng.stats["signatures"].items()},
            "tiers": sorted({eng.route(r)[1] for r in reqs}),
            "sentinel_results": sentinels, "launches": launches,
            "stage_a_calls": stage_a.calls,
            **{key: hit_call_summary(r.calls)
               for key, r in records.items()}}


def _ids_equal_up_to_ties(ids, ref_ids, scores, ref_scores, what: str,
                          rtol: float = 1e-5, atol: float = 1e-6, *,
                          compare: int | None = None) -> None:
    """Scores within tolerance; ids equal except inside runs of tied
    reference scores (the rule of the CPU tests' parity helper). With
    ``compare``, the inputs hold more columns than are compared: ids are
    compared in the first ``compare`` only, and a tie with the next score
    counts, so two sides may return different ids at the last compared
    place when its score ties with the first one left out."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    scores, ref_scores = np.asarray(scores), np.asarray(ref_scores)

    def close(a, b):
        with np.errstate(invalid="ignore"):      # inf - inf where a == b
            return (a == b) | (np.abs(a - b) <= atol + rtol * np.abs(b))
    if not close(scores, ref_scores).all():
        raise AssertionError(f"{what}: scores differ beyond rtol {rtol}")
    tie_prev = np.zeros(ref_scores.shape, bool)
    tie_prev[:, 1:] = close(ref_scores[:, 1:], ref_scores[:, :-1])
    tie_next = np.zeros(ref_scores.shape, bool)
    tie_next[:, :-1] = tie_prev[:, 1:]
    bad = ((ids != ref_ids) & ~(tie_prev | tie_next))[:, :compare]
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(
            f"{what}: {int(bad.sum())} ids differ outside score ties, first "
            f"at row {r} place {c}: ids {ids[r, c]} vs {ref_ids[r, c]}, "
            f"reference scores {ref_scores[r, max(c - 1, 0):c + 2].tolist()}")


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


def tier_table(index, cpu_index, queries, pts, metric: str,
               grid=None) -> dict:
    """Per tier: recall@10-in-100 on 256 queries, QPS of ``search`` over
    1024 (median of three, after a warm-up), and the same 32 queries on
    the CPU (plain versions); composed H2 against fused H2 at one rerank.
    With ``grid`` every search runs ``prefilter="rt"``, and each tier
    must also return the scan path's ids and scores at full coverage;
    fused H2 (the three-stage kernel) must equal ``fused3=False``."""
    dev = index.ivf.centroids.device
    q_eval = torch.from_numpy(queries[:1024]).to(dev)
    pts_dev = torch.from_numpy(pts).to(dev)
    _, gt = exact_topk(q_eval[:256], pts_dev, k=10, metric=metric)
    del pts_dev
    rt_kw, cpu_kw = {}, {}
    if grid is not None:
        rt_kw = dict(prefilter="rt", rt_grid=grid)
        cpu_kw = dict(prefilter="rt", rt_grid=rt.grid_to(grid, "cpu"))
    out = {}
    for tier, kw in TIERS.items():
        kw = dict(kw, k=100, metric=metric)
        search(index, q_eval, batch=128, **kw, **rt_kw)
        times = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            scores, ids = search(index, q_eval, batch=128, **kw, **rt_kw)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        sentinels = check_results(ids.cpu(), scores.cpu(), pts.shape[0], tier,
                                  rt=grid is not None)
        ids = ids[:256]
        recall = recall_n_at_k(ids.long(), gt)
        if tier in ("H", "H2_fused", "H2_composed") and recall < 0.2:
            raise AssertionError(f"{tier}: recall@10-in-100 {recall:.4f}")
        _, ids_cpu = search(cpu_index, q_eval[:32].cpu(), batch=8, **kw,
                            **cpu_kw)
        ids_gpu = ids[:32].cpu()
        same = shared_ids(ids_gpu, ids_cpu)
        r_gpu = recall_n_at_k(ids_gpu.long(), gt[:32].cpu())
        r_cpu = recall_n_at_k(ids_cpu.long(), gt[:32].cpu())
        if same < 0.99 or abs(r_gpu - r_cpu) > 0.01:
            raise AssertionError(f"{tier} GPU vs CPU: {same:.4f} ids shared, "
                                 f"recall {r_gpu:.4f} vs {r_cpu:.4f}")
        out[tier] = {"recall10_at_100": recall,
                     "qps": q_eval.shape[0] / statistics.median(times),
                     "sentinel_results": sentinels,
                     "cpu_ids_shared": same, "recall_gpu32": r_gpu,
                     "recall_cpu32": r_cpu, **{k: v for k, v in kw.items()
                                               if k != "metric"}}
        if grid is not None:
            s_scan, i_scan = search(index, q_eval[:256], batch=128, **kw)
            s_full, i_full = search(index, q_eval[:256], batch=128,
                                    rt_scale=FULL, **kw, **rt_kw)
            if not (torch.equal(i_full, i_scan) and torch.equal(s_full, s_scan)):
                raise AssertionError(f"rt {tier} at full coverage != scan")
            out[tier]["full_coverage_equals_scan"] = True
    # composed against fused H2 at the fused engine's rerank budget; one
    # result more than compared, for a tie across the 100th place
    kw = dict(TIERS["H2_fused"], k=101, metric=metric, **rt_kw)
    s_f, i_f = search(index, q_eval[:256], batch=128, **kw)
    s_c, i_c = search(index, q_eval[:256], batch=128, **dict(kw, fused=False))
    _ids_equal_up_to_ties(i_c.cpu(), i_f.cpu(), s_c.cpu(), s_f.cpu(),
                          "composed vs fused H2", compare=100)
    out["composed_equals_fused_at_rerank"] = kw["rerank"]
    if grid is not None:
        s_2, i_2 = search(index, q_eval[:256], batch=128, fused3=False, **kw)
        if not (torch.equal(i_f, i_2) and torch.equal(s_f, s_2)):
            raise AssertionError("three-stage H2 != fused3=False")
        out["fused3_equals_composed"] = True
    return out


def _probe_tau(index, q: torch.Tensor, metric: str, nprobe: int):
    """Stage A's probed cluster ids and τ (Q, 1, S) at probe 0, as the
    search computes them."""
    _, cids = filter_clusters(q, index.ivf, nprobe=nprobe, metric=metric)
    res = q - index.ivf.centroids[cids[:, 0]] if metric == "l2" else q
    tau = density_lib.predict_threshold(
        index.density, res.reshape(q.shape[0], -1, index.codebook.sub_dim))
    return cids, tau[:, None]


def probe_survival(index, grid, queries, metric: str, nprobe: int = 16
                   ) -> float:
    """Mean share of the nprobe probes that survive the sphere test at
    ``rt_scale`` 1 (probe 0 counted as kept), over 1024 queries."""
    q = torch.from_numpy(queries[:1024]).to(index.ivf.centroids.device)
    cids, tau = _probe_tau(index, q, metric, nprobe)
    return float(_rt_probe_mask(grid, q, tau, cids, 1.0).float().mean())


def router_seconds(index, grid, queries, stream, metric: str) -> float:
    """Host seconds the rt engine's router spends on one pass of the
    stream: ``route`` of each request, which runs ``rt.probe_budget``
    (host numpy) once a request."""
    eng = AnnServeEngine(index, metric=metric, fused=True, prefilter="rt",
                         rt_grid=grid)
    reqs = [eng.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                       recall_target=r["recall_target"]) for r in stream]
    t0 = time.perf_counter()
    for r in reqs:
        eng.route(r)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# mutate phase
# ---------------------------------------------------------------------------
def fresh_points(pts: np.ndarray, n: int, rng, sigma: float,
                 metric: str) -> np.ndarray:
    """``n`` new points in the index's distribution: random points of the
    build moved by N(0, (0.1·σ)²) noise in every coordinate, rescaled to
    their base point's norm for ip (as the generator normalises)."""
    base = pts[rng.integers(0, len(pts), n)]
    out = base + np.float32(0.1 * sigma) * rng.standard_normal(
        base.shape, dtype=np.float32)
    if metric == "ip":
        out *= (np.linalg.norm(base, axis=1, keepdims=True)
                / np.linalg.norm(out, axis=1, keepdims=True))
    return out.astype(np.float32)


def spill_points(mut, c: int, n: int, rng, sigma: float) -> np.ndarray:
    """``n`` points whose owning cluster is ``c``: its centroid moved by
    N(0, (0.05·σ)²) noise, kept where ``_label_encode`` (the ``ivf_filter``
    kernel, through the index's own ``_labels_codes``) assigns them to
    ``c``."""
    cents = mut._rt_centroids()
    cent = cents[c].cpu().numpy()
    out = np.empty((0, cent.shape[0]), np.float32)
    while len(out) < n:
        cand = (cent + np.float32(0.05 * sigma) * rng.standard_normal(
            (2 * n, cent.shape[0]), dtype=np.float32)).astype(np.float32)
        lab, _ = mut._labels_codes(torch.from_numpy(cand).to(cents.device))
        out = np.concatenate([out, cand[lab.cpu().numpy() == c]])
    return out[:n]


def fullest(mut) -> int:
    return int(np.argmin([mut.free_slots(c)
                          for c in range(mut.data.ivf.n_clusters)]))


def serve_pass(eng, queries, stream, deleted: np.ndarray, n_ids: int
               ) -> tuple[float, int, int]:
    """One pass of the stream through ``eng``: every request served, no
    deleted id among the results, every id below the id watermark. A
    tombstoned slot keeps its id, as in the reference, so where the probed
    clusters hold fewer than k live points a pad result (the invalid-slot
    score) may carry a deleted id; those are counted, not results.
    Returns (seconds, rows, deleted ids on pads)."""
    reqs = [eng.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                       recall_target=r["recall_target"]) for r in stream]
    t0 = time.perf_counter()
    rows = eng.run()
    secs = time.perf_counter() - t0
    pads = 0
    for r in reqs:
        if not r.done or r.ids.shape != (r.queries.shape[0], r.k):
            raise AssertionError(f"request {r.rid} not served")
        dead = np.isin(r.ids, deleted)
        sentinel = ~np.isfinite(r.scores) | (r.scores == NEG)
        if (dead & ~sentinel).any():
            raise AssertionError(f"request {r.rid} returned a deleted id")
        pads += int(dead.sum())
        if (r.ids >= n_ids).any():
            raise AssertionError(f"request {r.rid}: id >= {n_ids}")
    return secs, rows, pads


def own_id_found(mut, points: np.ndarray, ids: np.ndarray,
                 live: torch.Tensor, live_ids: np.ndarray, metric: str
                 ) -> dict:
    """Each point asked for itself: whether its id is among the exact
    top-10 of the live set (``live``, ids ``live_ids``), and whether tier H
    (nprobe 16) returns it in its top-10. ``rate`` is the share found among
    those the exact top-10 holds: an insert that is never found gives 0
    there at either metric (at ip a point's own top-10 often does not hold
    it, so the share of all points found cannot tell). ``se`` is its
    standard error (Agresti–Coull, so that it is not 0 at a rate of 1)."""
    q = torch.from_numpy(np.ascontiguousarray(points)).to(live.device)
    _, gt = exact_topk(q, live, k=10, metric=metric)
    _, got = mut.search(q, metric=metric, mode="H", k=10, nprobe=16,
                        batch=128)
    in_gt = (live_ids[gt.cpu().numpy()] == ids[:, None]).any(axis=1)
    found = (got.cpu().numpy() == ids[:, None]).any(axis=1)
    n, x = int(in_gt.sum()), int((found & in_gt).sum())
    p = (x + 2) / (n + 4)
    return {"n": len(ids), "in_exact": n, "found": x,
            "found_any": float(found.mean()), "rate": x / max(n, 1),
            "se": float(np.sqrt(p * (1 - p) / (n + 4)))}


def tier_results(mut, q: torch.Tensor, metric: str, **kw) -> dict:
    """Each tier's (scores, ids) on the current state (side included), at
    k = 101: :func:`compare_tiers` compares the first 100."""
    return {t: mut.search(q, batch=128, **dict(TIERS[t], k=101, metric=metric,
                                               **kw))
            for t in TIERS}


def compare_tiers(a: dict, b: dict, what: str) -> dict:
    """Tiers H, M and L: counts exactly, distances or similarities within
    the tolerance the composed-vs-fused check uses; ids up to score ties.
    Tier H2: the number of rows whose ids changed (printed, not gated: side
    points bypass the count prefilter, in-cluster points do not)."""
    out = {}
    for t in TIERS:
        (s0, i0), (s1, i1) = a[t], b[t]
        if t in ("H", "M", "L"):
            if t != "H" and not torch.equal(s0, s1):
                raise AssertionError(f"{what} {t}: counts changed")
            _ids_equal_up_to_ties(i1.cpu(), i0.cpu(), s1.cpu(), s0.cpu(),
                                  f"{what} {t}", compare=100)
        else:
            out[f"{t}_rows_changed"] = int(
                (i0[:, :100] != i1[:, :100]).any(dim=1).sum())
    return out


def phase_mutate(name: str, metric: str, mut, grid, pts: np.ndarray,
                 queries: np.ndarray, stream, seed: int) -> dict:
    """The mutable index at 1M points, on the index the serve phase used:
    a default engine (fused=False, scan) and an rt fused engine over it.
    Raises on the first failed check; see the module docstring."""
    dev = mut.data.ivf.centroids.device
    rng = np.random.default_rng(seed + 101)
    sigma = float(pts[::16].std())
    eng = AnnServeEngine(mut, metric=metric)
    reng = AnnServeEngine(mut, metric=metric, fused=True, prefilter="rt",
                          rt_grid=grid)
    deleted: list[int] = []
    inserted: dict[int, np.ndarray] = {}
    ins_s, ins_launch, states, side_fills = [], [], [], []
    compactions = dead_pads = 0

    # stream: insert, delete, serve both engines
    _build.reset_launches()
    for _ in range(ROUNDS):
        new = fresh_points(pts, INSERT_BATCH, rng, sigma, metric)
        muts = mut.rt_mutations
        n0 = _build.LAUNCHES["ivf_filter"]
        _sync(dev)
        t0 = time.perf_counter()
        ids = eng.insert(new)
        _sync(dev)
        ins_s.append(time.perf_counter() - t0)
        ins_launch.append(_build.LAUNCHES["ivf_filter"] - n0)
        if mut.rt_mutations != muts + 1:
            raise AssertionError("an insert batch did not bump rt_mutations")
        inserted.update(zip(ids, new))
        cand = rng.choice(mut._next_id, 4 * DELETE_BATCH, replace=False)
        victims = [int(i) for i in cand if int(i) in mut._loc][:DELETE_BATCH]
        eng.delete(victims)
        deleted += victims
        for i in victims:
            inserted.pop(i, None)
        dead = np.asarray(deleted)
        for e in (eng, reng):
            dead_pads += serve_pass(e, queries, stream, dead,
                                    mut._next_id)[2]
        if reng._rt_state[0] is not mut.rt_grid or \
                reng._rt_state[2] != mut.rt_mutations:
            raise AssertionError("the rt router kept a pre-insert state")
        states.append(reng._rt_state)      # kept alive: ids stay distinct
        side_fills.append(mut.side_fill)
        if mut.side_fill > SIDE // 2:
            # the stream's own spills (inserts into full clusters): fold
            # them into slots the deletes freed, rebuilding if some stick
            eng.compact()
            compactions += 1
    stream_launches = dict(_build.LAUNCHES)
    if any(n != 1 for n in ins_launch):
        raise AssertionError(f"ivf_filter launches per insert {ins_launch}")
    if len({id(st[1]) for st in states}) != ROUNDS:
        raise AssertionError("the rt router did not recompute its state "
                             "after every insert batch")
    del states
    dead = np.asarray(deleted)
    # inserted and build points asked for themselves, on the live set
    new_ids = np.asarray(sorted(inserted))
    old_ids = np.setdiff1d(np.arange(len(pts)), dead)
    live_ids = np.concatenate([old_ids, new_ids])
    live = torch.cat([torch.from_numpy(pts[old_ids]).to(dev),
                      torch.from_numpy(np.stack([inserted[i] for i in
                                                 new_ids])).to(dev)])
    pick = rng.choice(new_ids, OWN_QUERIES, replace=False)
    own_new = own_id_found(mut, np.stack([inserted[i] for i in pick]), pick,
                           live, live_ids, metric)
    pick = rng.choice(old_ids, OWN_QUERIES, replace=False)
    own_old = own_id_found(mut, pts[pick], pick, live, live_ids, metric)
    del live
    own_margin = OWN_SIGMAS * float(np.hypot(own_new["se"], own_old["se"]))
    if (own_new["in_exact"] < OWN_QUERIES // 10
            or own_new["rate"] < own_old["rate"] - own_margin):
        raise AssertionError(f"inserted points found as themselves "
                             f"{own_new}, build points {own_old}, margin "
                             f"{own_margin:.4f}")
    launches_pass = {}
    for label, e in (("scan", eng), ("rt_fused", reng)):
        _build.reset_launches()
        serve_pass(e, queries, stream, dead, mut._next_id)
        launches_pass[label] = _build.LAUNCHES["ivf_filter"]

    # a forced spill: SPILL points live in the side buffer
    eng.compact()
    swaps_before = eng.generation
    c = fullest(mut)
    spill = spill_points(mut, c, mut.free_slots(c) + SPILL, rng, sigma)
    eng.insert(spill)
    if mut.side_fill != SPILL:
        raise AssertionError(f"side fill {mut.side_fill}, expected {SPILL}")
    qps_live = statistics.median(
        rows / t for t, rows, _ in (serve_pass(eng, queries, stream, dead,
                                               mut._next_id)
                                    for _ in range(5)))
    q = torch.from_numpy(np.concatenate([queries[:64], spill[-64:]])).to(dev)

    # card vs CPU on the same state, side buffer live
    cpu_data = index_to(mut.data, "cpu")
    cpu_side = SideBuffer(*(t.cpu() for t in mut.delta_view()))
    cpu_grid = rt.grid_to(mut.ensure_rt_grid(metric=metric), "cpu")
    cpu_shared = {}
    qc = torch.cat([q[:16], q[-16:]])       # 16 of them near the side points
    for pf in ("scan", "rt"):
        for t in TIERS:
            kw = dict(TIERS[t], k=100, metric=metric, prefilter=pf, batch=8)
            _, i_gpu = mut.search(qc, **kw)
            _, i_cpu = search(cpu_data, qc.cpu(), side=cpu_side,
                              rt_grid=cpu_grid if pf == "rt" else None, **kw)
            cpu_shared[f"{pf}.{t}"] = shared_ids(i_gpu.cpu(), i_cpu)
    del cpu_data, cpu_side, cpu_grid
    if min(cpu_shared.values()) < 0.99:
        raise AssertionError(f"card vs CPU with the side buffer live: "
                             f"{cpu_shared}")

    # rt at full coverage = scan, side buffer live
    for t in TIERS:
        kw = dict(TIERS[t], k=100, metric=metric, batch=128)
        s_scan, i_scan = mut.search(q, **kw)
        s_full, i_full = mut.search(q, prefilter="rt", rt_scale=FULL, **kw)
        if not (torch.equal(i_full, i_scan) and torch.equal(s_full, s_scan)):
            raise AssertionError(f"{t}: rt at full coverage != scan with the "
                                 f"side buffer live")

    # compact(): free slots in the spill cluster, then fold the side points
    in_c = mut.data.ivf.point_ids[c][mut.data.ivf.valid[c]].tolist()
    keep = set(int(i) for i in mut.side.ids[mut.side.valid].tolist())
    victims = [i for i in in_c if i not in keep][:SPILL + 50]
    eng.delete(victims)
    dead = np.concatenate([dead, victims])
    before = tier_results(mut, q, metric)
    moved = eng.compact(rebuild=False)
    if mut.side_fill != 0 or moved != SPILL:
        raise AssertionError(f"compact moved {moved}, {mut.side_fill} left")
    compact = compare_tiers(before, tier_results(mut, q, metric), "compact")
    qps_empty = statistics.median(
        rows / t for t, rows, _ in (serve_pass(eng, queries, stream, dead,
                                               mut._next_id)
                                    for _ in range(5)))

    # swap_index(): the online rebuild, installed between ticks
    before = tier_results(mut, q, metric)
    p_old = mut.data.cluster_codes.shape[1]
    gen0 = eng.generation
    _sync(dev)
    t0 = time.perf_counter()
    gen = eng.swap_index()
    _sync(dev)
    swap_s = time.perf_counter() - t0
    if gen != gen0 + 1 or mut.rt_grid is not None:
        raise AssertionError("swap_index: generation or rt grid not reset")
    swap = compare_tiers(before, tier_results(mut, q, metric), "swap_index")
    serve_pass(reng, queries, stream, dead, mut._next_id)   # grid rebuilt
    if mut.rt_grid is None:
        raise AssertionError("the rt grid was not rebuilt after the swap")

    # the freshness tiers: 3 × SIDE forced spills with max_minors=2; the
    # engine's obs bundle gives its MergeScheduler a registry
    teng = AnnServeEngine(mut, metric=metric, max_minors=2,
                          obs=Observability())
    c = fullest(mut)
    caps = []
    for i in range(3):
        extra = mut.free_slots(c) + SIDE if i == 0 else SIDE
        teng.insert(spill_points(mut, c, extra, rng, sigma))
        caps.append(mut.delta_view().capacity)
        serve_pass(teng, queries, stream, dead, mut._next_id)
    if caps != [SIDE * 3] * 3 or len(mut._minors) != 2:
        raise AssertionError(f"delta capacities {caps}, "
                             f"{len(mut._minors)} minors")
    in_c = mut.data.ivf.point_ids[c][mut.data.ivf.valid[c]].tolist()
    victims = in_c[:3 * SIDE + 32]
    teng.delete(victims)
    dead = np.concatenate([dead, victims])
    tiered = tier_results(mut, q, metric)
    rebuilt = MutableJunoIndex(rebuild_index(mut), side_capacity=SIDE)
    want = tier_results(rebuilt, q, metric)
    compare_tiers(tiered, want, "tiers vs rebuild")
    pending = mut.delta_fill
    moved_tiers = teng.compact()
    if mut.delta_fill != 0 or mut._minors or teng.generation != 0:
        raise AssertionError(f"the scheduler left {mut.delta_fill} delta "
                             f"points, {len(mut._minors)} minors")
    compare_tiers(tier_results(mut, q, metric), want, "drained vs rebuild")
    del rebuilt, want
    merge_series = merge_series_check(teng)
    out = {"rounds": ROUNDS, "inserted": ROUNDS * INSERT_BATCH,
           "deleted": len(deleted), "stream_compactions": compactions,
           "deleted_ids_on_pads": dead_pads, "side_fill_per_round": side_fills,
           "swaps_before_spill": swaps_before,
           "own_id_build": own_old, "own_id_inserted": own_new,
           "own_id_margin": own_margin,
           "insert_points_per_s": INSERT_BATCH / statistics.median(ins_s),
           "insert_s": ins_s, "ivf_filter_per_insert": ins_launch[0],
           "ivf_filter_per_pass": launches_pass,
           "side_live": SPILL, "qps_side_live": qps_live,
           "qps_side_empty": qps_empty, "cpu_ids_shared": cpu_shared,
           "compact_moved": moved, "compact": compact,
           "swap_s": swap_s, "swap_capacity_kept":
               mut.data.cluster_codes.shape[1] == p_old, "swap": swap,
           "tiers_delta_capacity": caps, "tiers_pending": pending,
           "tiers_moved": moved_tiers,
           "scheduler": teng.scheduler.stats,
           "merge_series": merge_series,
           "engine_stats": {k: eng.stats[k] for k in
                            ("inserts", "deletes", "swaps", "ticks")},
           "launches": stream_launches}
    log(f"mutate.{name}", **out)
    return out


def merge_series_check(eng) -> dict:
    """The engine's ``MergeScheduler`` registry series against its own
    ``stats``: steps, folds and drains counted alike, a step-seconds
    observation a step and a drain-seconds one a drain."""
    st, snap = eng.scheduler.stats, eng.obs.registry.snapshot()
    got = {"steps": snap.get("juno_merge_steps_total", 0),
           "folded": snap.get("juno_merge_folded_total", 0),
           "drains": snap.get("juno_merge_drains_total", 0),
           "step_seconds_n": snap.get("juno_merge_step_seconds",
                                      {"n": 0})["n"],
           "drain_seconds_n": snap.get("juno_merge_drain_seconds",
                                       {"n": 0})["n"]}
    want = {"steps": st["steps"], "folded": st["folded"],
            "drains": st["drains"], "step_seconds_n": st["steps"],
            "drain_seconds_n": st["drains"]}
    if got != want or st["steps"] <= 0:
        raise AssertionError(f"juno_merge_* {got} != scheduler {want}")
    return got


# ---------------------------------------------------------------------------
# paged phase
# ---------------------------------------------------------------------------
class GatherClock:
    """Host seconds and calls of one ``PagedIndexData``'s ``gather``."""

    def __init__(self, paged):
        self.s, self.calls = 0.0, 0
        fn = paged.gather

        def timed(cids):
            t0 = time.perf_counter()
            out = fn(cids)
            self.s += time.perf_counter() - t0
            self.calls += 1
            return out
        paged.gather = timed


def run_stream(eng, queries, stream) -> tuple[list, float]:
    """One pass of the stream through ``eng``: (requests, seconds)."""
    reqs = [eng.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                       recall_target=r["recall_target"]) for r in stream]
    t0 = time.perf_counter()
    eng.run()
    return reqs, time.perf_counter() - t0


def same_requests(got: list, want: list, what: str) -> None:
    """Ids and scores bit-equal, request by request."""
    for a, b in zip(got, want, strict=True):
        if not (a.done and np.array_equal(a.ids, b.ids)
                and np.array_equal(a.scores, b.scores)):
            raise AssertionError(f"{what}: request {a.rid} differs from its "
                                 f"counterpart's")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


# timed turns of (resident pass, paged pass) a paged engine (one leaves
# the script's 1200 s room for train.phi4_mini and shard.phi4_mini)
PAGED_TURNS = 1


def paged_engine(path: str, cache_bytes: int, resident, queries, stream, *,
                 metric: str, fused: bool, grid, n_points: int) -> dict:
    """One paged engine configuration beside the resident engine of the same
    configuration (over ``resident``, a ``MutableJunoIndex``): a first pass
    with the launches counted, every request bit-equal to the resident
    engine's, then ``PAGED_TURNS`` turns of (resident pass, paged pass)."""
    prefilter = "scan" if grid is None else "rt"
    dev = resident.data.ivf.centroids.device
    pdata = PagedIndexData(path, cache_bytes=cache_bytes, device=dev)
    clock = GatherClock(pdata)
    peng = PagedAnnServeEngine(pdata, metric=metric, fused=fused,
                               prefilter=prefilter)
    reng = AnnServeEngine(resident, metric=metric, fused=fused,
                          prefilter=prefilter, rt_grid=grid)
    _build.reset_launches()
    got, t_first = run_stream(peng, queries, stream)
    launches = dict(_build.LAUNCHES)
    first_verified = pdata.verified_rows
    want, _ = run_stream(reng, queries, stream)
    same_requests(got, want, f"paged {prefilter} fused={fused}")
    for r in got:
        check_results(r.ids, r.scores, n_points, f"paged request {r.rid}",
                      rt=grid is not None)
    must = ENGINE_KERNELS[(prefilter, fused)]
    if any(launches[n] <= 0 for n in must) or \
            any(launches[n] != 0 for n in set(launches) - must):
        raise AssertionError(f"paged {prefilter} fused={fused}: launches "
                             f"{launches}, expected exactly {sorted(must)}")
    t_res, t_pag, g_s = [], [], []
    for _ in range(PAGED_TURNS):
        t_res.append(run_stream(reng, queries, stream)[1])
        g0 = clock.s
        got, t = run_stream(peng, queries, stream)
        t_pag.append(t)
        g_s.append(clock.s - g0)
    same_requests(got, want, f"paged {prefilter} fused={fused}, last turn")
    st = peng.cache_stats()
    if st["evictions"] <= 0:
        raise AssertionError(f"paged {prefilter} fused={fused}: no eviction "
                             f"with a cache of {cache_bytes} bytes")
    rows = peng.stats["queries"] // (PAGED_TURNS + 1)
    qps, qps_res = rows / statistics.median(t_pag), \
        rows / statistics.median(t_res)
    return {"prefilter": prefilter, "fused": fused, "rows": rows,
            "qps": qps, "qps_resident": qps_res, "paged_over_resident":
                qps / qps_res, "qps_turns": [rows / t for t in t_pag],
            "qps_resident_turns": [rows / t for t in t_res],
            "first_pass_s": t_first, "gather_s_per_pass": g_s,
            "gather_calls_per_pass": clock.calls // (PAGED_TURNS + 1),
            "verified_rows_first_pass": first_verified,
            "hits": st["hits"], "misses": st["misses"],
            "evictions": st["evictions"], "verified_rows":
                st["verified_rows"], "cache_rows": st["rows"],
            "launches": launches}


def gather_breakdown(path: str, index, queries, metric: str) -> dict:
    """Where one gather's host seconds go, at the engines' largest batch
    (Q 128, np 16; its U distinct clusters, the rows already in the page
    cache): copying the U rows out of the memory map, their sha256, the
    U pageable host→device copies and the stack on the card, beside a
    whole ``gather`` with a cold cache and, as a yardstick the port does
    not use, one copy of the U rows from pinned memory."""
    dev = index.ivf.centroids.device
    pdata = PagedIndexData(path, cache_bytes=0, device=dev)
    q = torch.from_numpy(queries[:128]).to(dev)
    _, cids = filter_clusters(q, index.ivf, nprobe=16, metric=metric)
    uniq = np.unique(cids.cpu().numpy()).tolist()
    mm = load_index(path, mmap_mode="r").data.cluster_codes
    out = {"U": len(uniq), "row_bytes": int(mm[0].nbytes)}

    def clock(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        return got
    clock("gather_s", lambda: pdata.gather(cids))
    host = clock("copy_s", lambda: [np.array(mm[c], copy=True)
                                    for c in uniq])
    clock("sha256_s", lambda: [hashlib.sha256(h.tobytes()).hexdigest()
                               for h in host])
    rows = clock("h2d_s", lambda: [torch.from_numpy(h).to(dev)
                                   for h in host])
    clock("stack_s", lambda: torch.stack(rows))
    pinned = torch.from_numpy(np.stack(host)).pin_memory()
    clock("pinned_h2d_s", lambda: pinned.to(dev, non_blocking=True))
    return out


def flip_byte(path: str, cid: int) -> int:
    """Flip the first byte of ``cluster_codes[cid]`` in the artifact at
    ``path`` (in place); returns its offset in ``arrays.npz``."""
    mm = load_index(path, mmap_mode="r").data.cluster_codes
    off = mm.offset + cid * mm.shape[1] * mm.shape[2]
    with open(os.path.join(path, "arrays.npz"), "r+b") as fh:
        fh.seek(off)
        b = fh.read(1)[0]
        fh.seek(off)
        fh.write(bytes([b ^ 1]))
    return off


def phase_paged(name: str, metric: str, cfg, index, grid, pts: np.ndarray,
                queries: np.ndarray, stream, seed: int, root: str) -> dict:
    """The paged tier at 1M points, on the index and stream of the serve
    phase: the index and its grid committed to an ``ArtifactStore`` in
    ``root`` (generation 1 of "main", which the fleet phase serves again),
    four paged engines with a cache of a quarter of the code
    bytes, each bit-equal to the resident engine; the exact rerank; a
    flipped byte failing closed; inserts, deletes, a swap to generation 2
    and a minor committed to the store. Raises on the first failed
    check; the caller deletes ``root``."""
    dev = index.ivf.centroids.device
    n = index.codes.shape[0]
    store = ArtifactStore(os.path.join(root, "store"))
    t0 = time.perf_counter()
    v1 = store.put("main", index, cfg, rt_grid=grid)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.verify("main", v1)
    verify_s = time.perf_counter() - t0
    path = store.path("main", v1)
    vec_path = os.path.join(root, "vectors.npy")
    np.save(vec_path, pts)
    cache_bytes = index.cluster_codes.numel() // 4
    out = {"artifact_bytes": _dir_bytes(path), "put_s": put_s,
           "verify_s": verify_s, "cache_bytes": cache_bytes,
           "cluster_bytes": index.cluster_codes.numel(), "engines": {}}
    resident = MutableJunoIndex(index, side_capacity=SIDE)
    for label, fused, g in (("fused", True, None),
                            ("unfused", False, None),
                            ("rt_fused", True, grid),
                            ("rt_unfused", False, grid)):
        out["engines"][label] = paged_engine(
            path, cache_bytes, resident, queries, stream, metric=metric,
            fused=fused, grid=g, n_points=n)
    out["launches"] = {k: sum(e["launches"][k]
                              for e in out["engines"].values())
                       for k in _build.LAUNCHES}
    out["gather_breakdown"] = gather_breakdown(path, index, queries,
                                               metric)

    # the exact rerank of C = 40 candidates from the raw vectors
    pvec = PagedIndexData(path, cache_bytes=cache_bytes, device=dev,
                          vectors=vec_path)
    q = queries[:256]
    qt = torch.from_numpy(q).to(dev)
    live = torch.from_numpy(pts).to(dev)
    _, gt = exact_topk(qt, live, k=10, metric=metric)
    recall = {}
    for label, c in (("paged", 0), ("exact_rerank", 40)):
        eng = PagedAnnServeEngine(pvec, metric=metric, exact_rerank=c)
        req = eng.submit(q, k=10, mode="H2", nprobe=16)
        eng.run()
        ids = torch.from_numpy(req.ids).to(dev)
        recall[label] = float(recall_n_at_k(ids, gt))
    v = live[ids.long()]
    exact = (((v - qt[:, None]) ** 2).sum(-1) if metric == "l2"
             else torch.einsum("qcd,qd->qc", v, qt))
    if not torch.allclose(torch.from_numpy(req.scores).to(dev), exact,
                          rtol=RTOL, atol=1e-6):
        raise AssertionError("exact rerank: scores are not the raw "
                             "vectors' of the returned ids")
    out["recall10_at_10"] = recall
    del live, v, exact, pvec

    # fail-closed: one flipped byte in a row the first query probes
    _, cids = filter_clusters(qt[:1], index.ivf, nprobe=16, metric=metric)
    cid = int(cids[0, 0])
    flip_byte(path, cid)
    try:
        bad = PagedAnnServeEngine(PagedIndexData(
            path, cache_bytes=cache_bytes, device=dev), metric=metric)
        req = bad.submit(q[:1], k=10, mode="H", nprobe=16)
        try:
            bad.run()
        except ArtifactError as e:
            fail_closed = str(e)
        else:
            raise AssertionError("a flipped byte was served")
        if req.done or req.ids is not None:
            raise AssertionError("a request over a flipped byte returned")
        try:
            store.verify("main", v1)
        except ArtifactError:
            pass
        else:
            raise AssertionError("verify passed a flipped byte")
    finally:
        flip_byte(path, cid)                   # restore it
    store.verify("main", v1)
    out["fail_closed"] = {"cluster": cid, "error": fail_closed}

    # mutation: the same inserts and deletes on a paged engine and a
    # resident one; then generation 2 (the resident state rebuilt)
    rng = np.random.default_rng(seed + 202)
    sigma = float(pts[::16].std())
    meng = PagedAnnServeEngine(PagedIndexData(
        path, cache_bytes=cache_bytes, device=dev), metric=metric,
        side_capacity=SIDE)
    rmut = MutableJunoIndex(index, side_capacity=SIDE)
    reng = AnnServeEngine(rmut, metric=metric)
    new = fresh_points(pts, SPILL, rng, sigma, metric)
    ids = meng.insert(new)
    if ids != reng.insert(new) or meng.index.side_fill != SPILL:
        raise AssertionError(f"paged inserts: ids or side fill "
                             f"{meng.index.side_fill}")
    own = {}
    for label, e in (("paged", meng), ("resident", reng)):
        r = e.submit(new, k=10, mode="H", nprobe=16)
        e.run()
        own[label] = r
    _ids_equal_up_to_ties(own["paged"].ids, own["resident"].ids,
                          own["paged"].scores, own["resident"].scores,
                          "paged inserts vs resident")
    found = {k: float((r.ids == np.asarray(ids)[:, None]).any(1).mean())
             for k, r in own.items()}
    if found["paged"] <= 0:
        raise AssertionError("no inserted point found as itself")
    cand = rng.choice(n, 2 * DELETE_BATCH, replace=False).tolist()
    victims = [i for i in cand if i in meng.index._loc][:DELETE_BATCH]
    victims += ids[:SPILL // 4]
    if meng.delete(victims) != reng.delete(victims):
        raise AssertionError("paged deletes")
    dead = np.asarray(victims)
    serve_pass(meng, queries, stream, dead, meng.index._next_id)
    rebuilt = rebuild_index(rmut)
    v2 = store.put("main", rebuilt, cfg)
    before = meng.cache_stats()
    meng.swap_index(PagedIndexData(store.path("main", v2),
                                   cache_bytes=cache_bytes, device=dev))
    after = meng.cache_stats()
    if after["rows"] != 0 or any(after[k] != before[k] for k in
                                 ("hits", "misses", "evictions")):
        raise AssertionError(f"swap: cache {before} -> {after}")
    got, _ = run_stream(meng, queries, stream)
    want, _ = run_stream(AnnServeEngine(rebuilt, metric=metric),
                         queries, stream)
    same_requests(got, want, "paged generation 2")
    serve_pass(meng, queries, stream, dead, meng.index._next_id)
    out["mutate"] = {"inserted": SPILL, "side_fill": SPILL,
                     "own_found": found, "deleted": len(victims),
                     "generation_2": v2, "cache_after_swap": after}

    # a full L0 commits a minor artifact, faulted in on first search
    teng = PagedAnnServeEngine(PagedIndexData(
        store.path("main", v2), cache_bytes=cache_bytes, device=dev),
        metric=metric, side_capacity=SIDE, max_minors=2,
        minor_store=store)
    tres = AnnServeEngine(MutableJunoIndex(rebuilt, side_capacity=SIDE),
                          metric=metric, max_minors=2)
    new = fresh_points(pts, SIDE + 16, rng, sigma, metric)
    for part in (new[:SIDE], new[SIDE:]):
        tids = teng.insert(part)
        if tids != tres.index.insert(part):
            raise AssertionError("minor inserts: ids")
    minors = teng.index._minors
    if len(minors) != 1 or minors[0].codes is not None or \
            store.latest("minors") != 1:
        raise AssertionError("a full L0 did not commit a minor artifact")
    mine = minors[0].ids[minors[0].valid]
    got = teng.submit(new[:SIDE], k=10, mode="H", nprobe=16)
    teng.run()
    if minors[0].codes is None:
        raise AssertionError("the minor was not faulted in")
    want = teng.index.search(new[:SIDE], k=10, mode="H", nprobe=16,
                             metric=metric, batch=128)
    ref = tres.index.search(new[:SIDE], k=10, mode="H", nprobe=16,
                            metric=metric, batch=128)
    _ids_equal_up_to_ties(want[1].cpu(), ref[1].cpu(), want[0].cpu(),
                          ref[0].cpu(), "paged minors vs resident")
    found_minor = float(np.isin(mine, got.ids).mean())
    if found_minor <= 0:
        raise AssertionError("no id of the minor was found")
    out["minors"] = {"committed": store.latest("minors"),
                     "path_is_artifact": os.path.exists(
                         os.path.join(minors[0].path, "manifest.json")),
                     "minor_ids_found": found_minor}
    log(f"paged.{name}", **out)
    return out

# ---------------------------------------------------------------------------
# obs phase
# ---------------------------------------------------------------------------
def engine_series(eng, reqs: list) -> dict:
    """An obs-on engine's ``juno_engine_*`` counters against its own
    counts: ticks, rows served and, by mode, the requests routed to that
    tier (``reqs``: every request it served)."""
    snap = eng.obs.registry.snapshot()
    routed = collections.Counter(eng.route(r)[1] for r in reqs)
    by_mode = {k.split('"')[1]: v for k, v in snap.items()
               if k.startswith("juno_engine_requests_total")}
    got = {"ticks": snap["juno_engine_ticks_total"],
           "queries": snap["juno_engine_queries_total"], "requests": by_mode}
    want = {"ticks": eng.stats["ticks"], "queries": eng.stats["queries"],
            "requests": dict(routed)}
    if got != want:
        raise AssertionError(f"juno_engine_* {got} != the engine's {want}")
    return got


def phase_obs(name: str, metric: str, cfg, index, grid, pts: np.ndarray,
              queries: np.ndarray, stream, tiers: dict, out_dir: str) -> dict:
    """Observability at 1M points on the serve phase's index and stream:
    the four resident engines with obs on and off in turns (ids and scores
    bit-equal, QPS of each, the series against the engines' counts, every
    dispatch span under a tick span), a recall probe on the fused engine,
    a fused paged engine with its fetch plane bound, an ``ArtifactStore``
    with a registry; the bundle's JSONL to ``out_dir``."""
    dev = index.ivf.centroids.device
    mut = MutableJunoIndex(index, side_capacity=SIDE)
    root = Observability(tracer=Tracer(max_spans=1 << 21))
    regs, out = [], {"engines": {}}
    _build.reset_launches()
    for label, fused, g in (("fused", True, None), ("unfused", False, None),
                            ("rt_fused", True, grid),
                            ("rt_unfused", False, grid)):
        pf = "scan" if g is None else "rt"
        kw = dict(metric=metric, fused=fused, prefilter=pf, rt_grid=g)
        child = root.child()
        off, on = AnnServeEngine(mut, **kw), AnnServeEngine(mut, obs=child,
                                                            **kw)
        run_stream(off, queries, stream)               # warm-up, both
        run_stream(on, queries, stream)
        t_off, t_on = [], []
        for _ in range(3):
            want, t = run_stream(off, queries, stream)
            t_off.append(t)
            got, t = run_stream(on, queries, stream)
            t_on.append(t)
            same_requests(got, want, f"obs.{name} {label} on vs off")
        rows = on.stats["queries"] // 4
        series = engine_series(on, on.completed)
        regs.append(child.registry)
        q_on, q_off = rows / statistics.median(t_on), \
            rows / statistics.median(t_off)
        out["engines"][label] = {"qps_on": q_on, "qps_off": q_off,
                                 "on_over_off": q_on / q_off,
                                 "qps_on_turns": [rows / t for t in t_on],
                                 "qps_off_turns": [rows / t for t in t_off],
                                 "series": series}
    spans = root.tracer.spans()
    by_id = {sp.span_id: sp for sp in spans}
    orphans = sum(sp.name == "engine.dispatch"
                  and by_id.get(sp.parent_id, sp).name != "engine.tick"
                  for sp in spans)
    if orphans or root.tracer.dropped:
        raise AssertionError(f"{orphans} dispatch spans outside a tick, "
                             f"{root.tracer.dropped} spans dropped")
    out["spans"] = dict(collections.Counter(sp.name for sp in spans))

    # the recall probe on the fused engine: one request in 8 a tier
    probe = RecallProbe(torch.from_numpy(pts).to(dev), k=10, every=8,
                        metric=metric)
    rbundle = Observability(tracer=root.tracer, recall=probe)
    reng = AnnServeEngine(mut, metric=metric, fused=True, obs=rbundle)
    got, _ = run_stream(reng, queries, stream)
    want, _ = run_stream(AnnServeEngine(mut, metric=metric, fused=True),
                         queries, stream)
    same_requests(got, want, f"obs.{name} fused with the recall probe")
    regs.append(rbundle.registry)
    snap = rbundle.registry.snapshot()
    out["recall_probe"] = {
        "online_recall_at_10": {k.split('mode="')[1][:-2]: v
                                for k, v in snap.items()
                                if k.startswith("juno_recall_online_at_k")},
        "samples": {k.split('"')[1]: v for k, v in snap.items()
                    if k.startswith("juno_recall_samples_total")},
        "tiers_recall10_at_100": {t: tiers[t]["recall10_at_100"]
                                  for t in TIERS}}
    del probe, rbundle, reng

    # the store's series, then a fused paged engine with its fetch plane
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"obs_{name}_",
                           dir=os.path.join(REPO, "build"))
    try:
        store_reg = MetricsRegistry()
        store = ArtifactStore(os.path.join(tmp, "store"), registry=store_reg)
        v = store.put("main", index, cfg)
        store.get("main", v, device=dev)
        store.verify("main", v)
        ops_seen = {k.split('"')[1]: v for k, v in store_reg.snapshot().items()
                    if k.startswith("juno_store_ops_total")}
        if ops_seen != {"put": 1, "load": 1, "verify": 1}:
            raise AssertionError(f"juno_store_ops_total {ops_seen}")
        regs.append(store_reg)
        out["store_ops"] = ops_seen
        cache = index.cluster_codes.numel() // 4
        pchild = root.child()
        faults0 = sum(sp.name == "paged.fault" for sp in root.tracer.spans())
        pon = PagedAnnServeEngine(PagedIndexData(
            store.path("main", v), cache_bytes=cache, device=dev),
            metric=metric, fused=True, obs=pchild)
        poff = PagedAnnServeEngine(PagedIndexData(
            store.path("main", v), cache_bytes=cache, device=dev),
            metric=metric, fused=True)
        want, t_poff = run_stream(poff, queries, stream)   # off first
        got, t_pon = run_stream(pon, queries, stream)
        same_requests(got, want, f"obs.{name} paged on vs off")
        st = pon.cache_stats()
        psnap = pchild.registry.snapshot()
        faults = sum(sp.name == "paged.fault"
                     for sp in root.tracer.spans()) - faults0
        cache_series = {k: psnap[f"juno_cache_{k}_total"]
                        for k in ("hits", "misses", "evictions")}
        cache_series.update(bytes=psnap["juno_cache_bytes"],
                            rows=psnap["juno_cache_rows"])
        if (faults != st["misses"] or psnap["juno_paged_faults_total"]
                != st["misses"] or any(cache_series[k] != st[k]
                                       for k in cache_series)):
            raise AssertionError(f"paged obs: {faults} fault spans, series "
                                 f"{cache_series}, cache {st}")
        regs.append(pchild.registry)
        out["paged"] = {"fault_spans": faults, "cache_series": cache_series,
                        "verify_seconds_n": psnap[
                            "juno_paged_verify_seconds"]["n"],
                        "verified_rows": st["verified_rows"],
                        "pass_s_off_first": t_poff, "pass_s_on_second": t_pon}
        del pon, poff
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    merged = MetricsRegistry()
    for reg in regs:
        merged.merge(reg)
    events = to_events(merged, root.tracer, extra_meta={"index": name,
                                                        "card": torch.cuda.get_device_name(0)})
    problems = validate_events(events)
    if problems:
        raise AssertionError(f"obs.{name} dump: {problems[:5]}")
    path = os.path.join(out_dir, f"obs_{name}.jsonl")
    write_jsonl(path, events)
    out["jsonl"] = {"path": os.path.relpath(path, REPO),
                    "events": len(events), "bytes": os.path.getsize(path)}
    out["launches"] = {"obs": dict(_build.LAUNCHES)}
    log(f"obs.{name}", **out)
    return out


# ---------------------------------------------------------------------------
# dist and fleet phases
# ---------------------------------------------------------------------------
SHARDS = 4                     # dist phase: 4 shards of 256 clusters
DIST_ROUNDS = 5                # dist phase: insert/delete rounds


class ShardEngine(AnnServeEngine):
    """This script's own engine (the port ships ``serve.fleet``'s
    ``_ShardedAnnServeEngine``, which serves the composed scan path only):
    its batches run through a ``DistributedMutableIndex``'s searcher in
    each engine configuration (fused or not, scan or rt), with
    ``ceil(nprobe / n_shards)`` probes a shard and the unsharded engine's
    rerank, so that the searcher meets the unsharded engines bit for bit
    in all four."""

    def _dispatch(self, qb, k, mode, nprobe, side):
        idx = self.index
        fused = self.fused and mode == "H2"
        fn = idx.searcher(math.ceil(nprobe / idx.n_shards), k, mode=mode,
                          metric=self.metric, thres_scale=self.thres_scale,
                          fused=fused, fused3=self.fused3,
                          rerank=self.FUSED_RERANK_MULT * k if fused else 0,
                          prefilter=self.prefilter, rt_scale=self.rt_scale)
        grid = ((idx.ensure_rt_grid(metric=self.metric),)
                if self.prefilter == "rt" else ())
        return fn(idx.shards, qb, side, *grid)


def _same_above_last(ids, ref_ids, scores, ref_scores, what: str) -> None:
    """Counts bit-equal; each row's ids counted above its last count equal
    as sets (equal counts may be ordered either way)."""
    if not torch.equal(scores, ref_scores):
        raise AssertionError(f"{what}: counts differ")
    for i, r, s in zip(ids.cpu(), ref_ids.cpu(), ref_scores.cpu()):
        inner = s != s[-1]
        if set(i[inner].tolist()) != set(r[inner].tolist()):
            raise AssertionError(f"{what}: ids above the last count differ")


def _same_but_moved(before, after, moved: np.ndarray, what: str) -> int:
    """Tier H results before and after delta points moved into cluster
    slots: scores within ``RTOL`` and ids up to ties; the score of every id
    that did not move bit-equal (a moved point's was the side gather's sum,
    in torch's order, and is now the scan kernel's). Returns how many
    moved points' scores changed."""
    (s0, i0), (s1, i1) = ((s.cpu().numpy(), i.cpu().numpy())
                          for s, i in (before, after))
    _ids_equal_up_to_ties(i1, i0, s1, s0, what, rtol=RTOL)
    changed = 0
    for r0, v0, r1, v1 in zip(i0, s0, i1, s1):
        old = dict(zip(r0.tolist(), v0.tolist()))
        for pid, v in zip(r1.tolist(), v1.tolist()):
            if pid in old and old[pid] != v:
                if pid not in moved:
                    raise AssertionError(f"{what}: id {pid} not moved, "
                                         f"score {old[pid]} -> {v}")
                changed += 1
    return changed


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _shard_spill(dmi, n_per: int, rng, sigma: float
                 ) -> tuple[list, np.ndarray]:
    """Insert into each shard's fullest cluster its free slots plus
    ``n_per`` points, so ``n_per`` a shard spill into the side buffer.
    Returns (clusters, the spilled points)."""
    n_local = dmi.n_clusters // dmi.n_shards
    clusters, spilled = [], []
    for s in range(dmi.n_shards):
        free = [dmi.free_slots(c) for c in range(s * n_local,
                                                  (s + 1) * n_local)]
        c = s * n_local + int(np.argmin(free))
        pts_c = spill_points(dmi, c, min(free) + n_per, rng, sigma)
        dmi.insert(pts_c)
        clusters.append(c)
        spilled.append(pts_c[-n_per:])
    return clusters, np.concatenate(spilled)


def _free_in(dmi, clusters: list, n_per: int) -> list[int]:
    """Delete ``n_per`` live in-cluster points of each cluster."""
    victims = []
    n_local = dmi.n_clusters // dmi.n_shards
    for c in clusters:
        s, lc = divmod(c, n_local)
        ivf = dmi.shards[s].ivf
        victims += ivf.point_ids[lc][ivf.valid[lc]][:n_per].cpu().tolist()
    dmi.delete(victims)
    return victims


def phase_dist(name: str, metric: str, index, grid, pts: np.ndarray,
               queries: np.ndarray, stream, tiers: dict, seed: int) -> dict:
    """The cluster-sharded index at 1M points on the serve phase's index
    (C = 1024: 4 shards of 256 clusters, all on this card): one shard
    against the unsharded engines in their four configurations, request
    by request bit-equal; 4 shards at full coverage against the unsharded
    search; recall at the engines' budgets and a sharded engine's QPS;
    rt at full-coverage radii against scan; the card against the CPU;
    mutations, ``rebuild_shard`` and a lane-scheduled drain. Raises on the
    first failed check."""
    dev = index.ivf.centroids.device
    n = index.codes.shape[0]
    devs = [dev] * SHARDS
    out, secs = {}, {}
    t_phase = time.perf_counter()
    _build.reset_launches()

    mut = MutableJunoIndex(index, side_capacity=SIDE)
    one = DistributedMutableIndex(index, [dev], side_capacity=SIDE)
    for label, fused, g in (("fused", True, None), ("unfused", False, None),
                            ("rt_fused", True, grid),
                            ("rt_unfused", False, grid)):
        kw = dict(metric=metric, fused=fused, rt_grid=g,
                  prefilter="scan" if g is None else "rt")
        want, _ = run_stream(AnnServeEngine(mut, **kw), queries, stream)
        got, _ = run_stream(ShardEngine(one, **kw), queries, stream)
        same_requests(got, want, f"dist.{name} one shard {label}")
        if label == "unfused":
            scan_want = want
    out["one_shard_bit_equal"] = ["fused", "unfused", "rt_fused",
                                  "rt_unfused"]
    del mut, one

    # the fleet's sharded engine itself at 1 shard: its H/M/L requests
    # bit-equal to the unsharded scan engine's; its H2 requests (it
    # reranks FUSED_RERANK_MULT·k, the unfused engine none) held against
    # the unsharded search() at the request's signature, ids up to ties
    ship = _ShardedAnnServeEngine(index, [dev], side_capacity=SIDE,
                                  metric=metric)
    got, _ = run_stream(ship, queries, stream)
    n_h2 = 0
    for a, b in zip(got, scan_want, strict=True):
        kb, mode, nprobe = ship.route(a)
        what = f"dist.{name} shipped engine, 1 shard, request {a.rid}"
        if mode != "H2":
            same_requests([a], [b], what)
            continue
        s_r, i_r = search(index, torch.from_numpy(a.queries).to(dev),
                          nprobe=nprobe, k=kb, mode="H2", metric=metric,
                          rerank=ship.FUSED_RERANK_MULT * kb)
        _ids_equal_up_to_ties(a.ids, i_r[:, :a.k].cpu().numpy(), a.scores,
                              s_r[:, :a.k].cpu().numpy(), what, rtol=RTOL)
        n_h2 += 1
    out["shipped_one_shard"] = {"requests": len(got),
                                "bit_equal_to_scan_engine": len(got) - n_h2,
                                "h2_against_search": n_h2}
    del ship
    secs["one_shard"] = time.perf_counter() - t_phase

    four = shard_index(index, devs)
    n_local = index.ivf.n_clusters // SHARDS
    q128 = torch.from_numpy(queries[:128]).to(dev)
    full = {}
    for mode in ("H", "M", "L"):
        # H fetches one result more than it compares, so that two points
        # of bit-equal score at the 100th place, the one kept by each
        # side, count as the tie they are (equal PQ codes score equal)
        k = 101 if mode == "H" else 100
        fn = make_distributed_search(devs, n_local, k, mode=mode,
                                     metric=metric)
        (s4, i4), t4 = _timed(dev, lambda: fn(four, q128))
        (s1, i1), t1 = _timed(dev, lambda: search(
            index, q128, nprobe=index.ivf.n_clusters, k=k, mode=mode,
            metric=metric, batch=32))
        what = f"dist.{name} full coverage {mode}"
        if mode == "H":
            if not torch.equal(s4, s1):
                raise AssertionError(f"{what}: scores differ")
            _ids_equal_up_to_ties(i4.cpu(), i1.cpu(), s4.cpu(), s1.cpu(),
                                  what, rtol=0.0, atol=0.0, compare=100)
            i4, i1 = i4[:, :100], i1[:, :100]
        else:
            _same_above_last(i4, i1, s4, s1, what)
        full[mode] = {"k": k, "local_nprobe": n_local, "sharded_s": t4,
                      "unsharded_s": t1,
                      "ids_in_other_order": int((i4 != i1).sum())}
    out["full_coverage"] = full
    secs["full_coverage"] = time.perf_counter() - t_phase - sum(secs.values())

    pts_dev = torch.from_numpy(pts).to(dev)
    q256 = torch.from_numpy(queries[:256]).to(dev)
    _, gt = exact_topk(q256, pts_dev, k=10, metric=metric)
    del pts_dev
    budget = {}
    for tier in ("H", "H2_fused", "M", "L"):
        kw = dict(TIERS[tier])
        local_np = math.ceil(kw.pop("nprobe") / SHARDS)
        fn = make_distributed_search(devs, local_np, 100, metric=metric, **kw)
        s, ids = fn(four, q256)
        check_results(ids.cpu(), s.cpu(), n, f"dist.{name} {tier}")
        budget[tier] = {"local_nprobe": local_np,
                        "recall10_at_100": recall_n_at_k(ids.long(), gt),
                        "unsharded_recall10_at_100":
                            tiers[tier]["recall10_at_100"],
                        "unsharded_nprobe": TIERS[tier]["nprobe"]}
    out["budgets"] = budget

    # rt at rt_scale 1: each shard's probe mask, as the sharded search
    # computes it (the probe entry's calls recorded), looked up at the
    # shard's probes + lo and equal to the plain mask at those global ids
    rt_off = {}
    real_mask = ops.rt_probe_mask
    for label, kw in (("H", dict(mode="H")),
                      ("H2_fused3", dict(mode="H2", fused=True,
                                         rerank=TIERS["H2_fused"]["rerank"]))):
        calls = []

        def rec(*a, **k):
            res = real_mask(*a, **k)
            calls.append((a, k, res))
            return res
        rtf = make_distributed_search(devs, 4, 100, metric=metric,
                                      prefilter="rt", rt_scale=1.0, **kw)
        ops.rt_probe_mask = rec
        try:
            s_r, i_r = rtf(four, q128, grid)
        finally:
            ops.rt_probe_mask = real_mask
        check_results(i_r.cpu(), s_r.cpu(), n, f"dist.{name} rt {label}",
                      rt=True)
        if len(calls) != SHARDS:
            raise AssertionError(f"dist.{name} rt {label}: {len(calls)} "
                                 f"probe calls for {SHARDS} shards")
        kept, moved = [], []
        for sh, (a, k, res) in enumerate(calls):
            what = f"dist.{name} rt {label} shard {sh}"
            _, cids = filter_clusters(q128, four[sh].ivf, nprobe=4,
                                      metric=metric)
            if not torch.equal(a[3].long(), cids.long() + sh * n_local):
                raise AssertionError(f"{what}: probes not at cids + lo")
            host = [x.cpu() if torch.is_tensor(x) else x for x in a]
            plain = real_mask(*host, **k)
            if not all(torch.equal(g.cpu(), p) for g, p in zip(res, plain)):
                raise AssertionError(f"{what}: mask != plain at global ids")
            local = real_mask(*host[:3], host[3] - sh * n_local, *host[4:],
                              **k)
            moved.append(int((local[2] != plain[2]).sum()))
            if sh and not moved[-1]:
                raise AssertionError(f"{what}: local ids hit the same slots")
            kept.append(float(res[0].float().mean()))
        rt_off[label] = {"probes_kept": kept,
                         "slots_moved_by_offset": moved}
    out["rt_offset_masks"] = rt_off

    # rt at full-coverage radii against scan: with every probe kept, the
    # rt and three-stage branches of every shard equal its scan
    rt_full = {}
    for label, kw in (("H", dict(mode="H")),
                      ("H2_fused3", dict(mode="H2", fused=True,
                                         rerank=TIERS["H2_fused"]["rerank"]))):
        scan = make_distributed_search(devs, 4, 100, metric=metric, **kw)
        rtf = make_distributed_search(devs, 4, 100, metric=metric,
                                      prefilter="rt", rt_scale=FULL, **kw)
        s_s, i_s = scan(four, q128)
        s_r, i_r = rtf(four, q128, grid)
        if not (torch.equal(i_r, i_s) and torch.equal(s_r, s_s)):
            raise AssertionError(f"dist.{name} rt {label} at full radii "
                                 f"!= scan")
        rt_full[label] = True
    out["rt_full_radii_equals_scan"] = rt_full

    # the card against the port's CPU path, 4 shards, tier H
    fn_gpu = make_distributed_search(devs, 4, 100, mode="H", metric=metric)
    fn_cpu = make_distributed_search(["cpu"] * SHARDS, 4, 100, mode="H",
                                     metric=metric)
    _, i_g = fn_gpu(four, q128[:32])
    _, i_c = fn_cpu(shard_index(index_to(index, "cpu"), ["cpu"] * SHARDS),
                    queries[:32])
    same = shared_ids(i_g.cpu(), i_c)
    if same < 0.99:
        raise AssertionError(f"dist.{name} card vs CPU: {same:.4f} shared")
    out["cpu_ids_shared"] = same
    del four
    secs["budgets_rt_cpu"] = time.perf_counter() - t_phase - sum(
        secs.values())

    # a 4-shard engine (it also serves the mutations below) beside the
    # unsharded one, in turns; on l2 only, since the run passes 720 s
    seng = _ShardedAnnServeEngine(index, devs, side_capacity=SIDE,
                                  metric=metric)
    got, _ = run_stream(seng, queries, stream)
    for r in got:
        check_results(r.ids, r.scores, n, f"dist.{name} sharded engine")
    if name == "l2":
        ueng = AnnServeEngine(index, side_capacity=SIDE, metric=metric)
        run_stream(ueng, queries, stream)              # warm-up
        t_s, t_u = [], []
        for _ in range(3):
            t_u.append(run_stream(ueng, queries, stream)[1])
            t_s.append(run_stream(seng, queries, stream)[1])
        rows = seng.stats["queries"] // 4
        out["engine"] = {"shards": SHARDS, "rows": rows,
                         "qps": rows / statistics.median(t_s),
                         "qps_unsharded": rows / statistics.median(t_u),
                         "qps_turns": [rows / t for t in t_s],
                         "qps_unsharded_turns": [rows / t for t in t_u]}
        del ueng
    secs["engine_qps"] = time.perf_counter() - t_phase - sum(secs.values())

    # mutations through the sharded engine, then rebuild_shard
    dmi = seng.index
    rng = np.random.default_rng(seed + 202)
    sigma = float(pts[::16].std())
    victims = rng.permutation(n)[:DIST_ROUNDS * DELETE_BATCH]
    deleted: list[int] = []
    ins_s = []
    for r in range(DIST_ROUNDS):
        new = fresh_points(pts, INSERT_BATCH, rng, sigma, metric)
        _, t = _timed(dev, lambda: seng.insert(new))
        ins_s.append(t)
        batch = victims[r * DELETE_BATCH:(r + 1) * DELETE_BATCH].tolist()
        seng.delete(batch)
        deleted += batch
        serve_pass(seng, queries, stream, np.asarray(deleted), dmi._next_id)
    spill_cl, spilled = _shard_spill(dmi, SPILL // SHARDS, rng, sigma)
    owners = set((dmi.side.cluster[dmi.side.valid].cpu().numpy()
                  // n_local).tolist())
    if dmi.side_fill < SPILL or owners != set(range(SHARDS)):
        raise AssertionError(f"dist.{name}: {dmi.side_fill} side points "
                             f"owned by shards {sorted(owners)}")
    deleted += _free_in(dmi, spill_cl, SPILL // SHARDS + 10)
    side_before = dmi.side_fill
    moved_ids = set(dmi.side.ids[dmi.side.valid].cpu().tolist())
    # 96 stream queries and 32 spilled points: every shard's side points
    # are probed
    q_mut = torch.cat([q128[:96], torch.from_numpy(
        spilled[::len(spilled) // 32][:32]).to(dev)])
    fn = dmi.searcher(4, 100, mode="H", metric=metric)
    s0, i0 = fn(dmi.shards, q_mut, dmi.delta_view())
    drained, t_rb = [], []
    for s in range(SHARDS):
        d, t = _timed(dev, lambda: dmi.rebuild_shard(s))
        drained.append(d)
        t_rb.append(t)
    s1, i1 = fn(dmi.shards, q_mut, dmi.delta_view())
    rb_changed = _same_but_moved((s0, i0), (s1, i1), moved_ids,
                                 f"dist.{name} rebuild_shard")
    serve_pass(seng, queries, stream, np.asarray(deleted), dmi._next_id)
    out["mutate"] = {"rounds": DIST_ROUNDS, "insert_s": ins_s,
                     "inserted": DIST_ROUNDS * INSERT_BATCH,
                     "deleted": len(deleted), "side_before": side_before,
                     "drained": drained, "side_after": dmi.side_fill,
                     "rebuild_shard_s": t_rb,
                     "ids_in_other_order": int((i1 != i0).sum()),
                     "moved_scores_changed": rb_changed}

    # the spills of the rounds whose clusters stayed full: rebuild()
    # escalates them to rebuild_index + swap_data, growing the capacity
    stuck, cap = dmi.side_fill, dmi.shards[0].cluster_codes.shape[1]
    moved_ids = set(dmi.side.ids[dmi.side.valid].cpu().tolist())
    before = fn(dmi.shards, q_mut, dmi.delta_view())
    drained_all, t_full = _timed(dev, dmi.rebuild)
    if dmi.delta_fill or drained_all != stuck:
        raise AssertionError(f"dist.{name}: rebuild drained {drained_all} "
                             f"of {stuck}, {dmi.delta_fill} left")
    full_changed = _same_but_moved(
        before, fn(dmi.shards, q_mut, dmi.delta_view()), moved_ids,
        f"dist.{name} rebuild")
    out["rebuild"] = {"stuck": stuck, "drained": drained_all,
                      "capacity": [cap, dmi.shards[0].cluster_codes.shape[1]],
                      "rebuild_s": t_full,
                      "moved_scores_changed": full_changed}
    serve_pass(seng, queries, stream, np.asarray(deleted), dmi._next_id)

    # one lane-scheduled drain with the tiers on
    dmi.enable_tiers(2)
    sch = MergeScheduler(dmi, clusters_per_step=32)
    if sch._lanes != dmi.merge_lanes() or len(sch._lanes) != SHARDS:
        raise AssertionError(f"dist.{name}: lanes {sch._lanes}")
    lane_cl, _ = _shard_spill(dmi, SIDE // SHARDS, rng, sigma)
    promote_l0(dmi)
    deleted += _free_in(dmi, lane_cl, SIDE // SHARDS + 10)
    s0, i0 = fn(dmi.shards, q_mut, dmi.delta_view())
    pending = dmi.delta_fill
    moved_ids = set(dmi._minors[0].ids[dmi._minors[0].valid].tolist())
    moved, t_drain = _timed(dev, sch.drain)
    s1, i1 = fn(dmi.shards, q_mut, dmi.delta_view())
    if dmi.delta_fill or moved < pending:
        raise AssertionError(f"dist.{name}: drain moved {moved} of "
                             f"{pending}, {dmi.delta_fill} left")
    drain_changed = _same_but_moved((s0, i0), (s1, i1), moved_ids,
                                    f"dist.{name} lane drain")
    serve_pass(seng, queries, stream, np.asarray(deleted), dmi._next_id)
    out["lane_drain"] = {"lanes": len(sch._lanes), "moved": moved,
                         "steps": sch.stats["steps"], "drain_s": t_drain,
                         "ids_in_other_order": int((i1 != i0).sum()),
                         "moved_scores_changed": drain_changed}
    secs["mutate"] = time.perf_counter() - t_phase - sum(secs.values())
    out["seconds"] = secs
    out["launches"] = {"dist": dict(_build.LAUNCHES)}
    log(f"dist.{name}", **out)
    return out


def _fleet_pass(fleet, queries, stream, **kw) -> tuple[list, float]:
    """Submit the stream to ``fleet`` and run it: (requests, seconds)."""
    t0 = time.perf_counter()
    reqs = [fleet.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                         recall_target=r["recall_target"], **kw)
            for r in stream]
    fleet.run()
    return reqs, time.perf_counter() - t0


def _fleet_summary(fleet, rows: int, secs: float) -> dict:
    lat = fleet.latency_summary()
    return {"qps": rows / secs, "p50_s": lat["p50"], "p99_s": lat["p99"],
            **{k: lat[k] for k in ("served", "shed", "expired", "rerouted")}}


def phase_fleet(name: str, metric: str, index, pts: np.ndarray,
                queries: np.ndarray, stream, seed: int, store_root: str
                ) -> dict:
    """The replica fleet at 1M points on the serve phase's index and
    stream: 2- and 1-replica fleets bit-equal to one engine, request by
    request; a 2 × 2 sharded fleet (4 shards on this card) serving the
    stream, shedding with typed rejections under ``policy="shed"``,
    unchanged by a ``fail_replica`` mid-stream, and fanning inserts out
    with identical ids; 2 paged replicas over the paged phase's artifact
    sharing one cluster cache, bit-equal to the resident engine. Prints
    QPS, p50/p99 and the admission counters. Raises on the first failed
    check."""
    dev = index.ivf.centroids.device
    n = index.codes.shape[0]
    rows = sum(r["rows"][1] - r["rows"][0] for r in stream)
    out = {}
    _build.reset_launches()

    want, _ = run_stream(AnnServeEngine(index, side_capacity=SIDE,
                                        metric=metric), queries, stream)
    for n_rep in (2, 1):
        fleet = AnnServeFleet(index, n_replicas=n_rep, side_capacity=SIDE,
                              metric=metric)
        _fleet_pass(fleet, queries, stream)             # warm-up
        fleet.reset_metrics()
        got, t = _fleet_pass(fleet, queries, stream)
        same_requests([r.inner for r in got], want,
                      f"fleet.{name} {n_rep} replicas")
        out[f"replicas_{n_rep}"] = _fleet_summary(fleet, rows, t)
    del fleet

    # 2 replicas x 2 shards on this card
    sharded = dict(n_replicas=2, shards_per_replica=2, devices=[dev] * 4,
                   side_capacity=SIDE, metric=metric)
    f22 = AnnServeFleet(index, **sharded)
    _fleet_pass(f22, queries, stream)                   # warm-up
    f22.reset_metrics()
    base, t = _fleet_pass(f22, queries, stream)
    for r in base:
        check_results(r.ids, r.scores, n, f"fleet.{name} 2x2 {r.rid}")
    out["sharded_2x2"] = _fleet_summary(f22, rows, t)

    # a replica fails mid-stream: its queued requests move, results hold
    f22.reset_metrics()
    reqs = [f22.submit(queries[r["rows"][0]:r["rows"][1]], k=r["k"],
                       recall_target=r["recall_target"]) for r in stream]
    for _ in range(3):
        f22.step()
    moved = f22.fail_replica(0)
    f22.run()
    f22.restore_replica(0)
    same_requests([r.inner for r in reqs], [r.inner for r in base],
                  f"fleet.{name} 2x2 failover")
    if moved <= 0 or not all(r.done for r in reqs):
        raise AssertionError(f"fleet.{name}: failover moved {moved}")
    out["failover"] = {"rerouted": f22.stats["rerouted"],
                       "served": f22.stats["served"]}

    # fan-out inserts: identical ids on every replica (checked inside)
    new = fresh_points(pts, INSERT_BATCH, np.random.default_rng(seed + 303),
                       float(pts[::16].std()), metric)
    ids = f22.insert(new)
    if not (len(ids) == INSERT_BATCH and len({e.index._next_id
                                              for e in f22.engines}) == 1):
        raise AssertionError(f"fleet.{name}: fan-out insert")
    out["fan_out_inserts"] = len(ids)
    del f22

    # policy="shed": typed rejections, no exception
    fshed = AnnServeFleet(index, policy="shed", max_queue=256, **sharded)
    reqs, t = _fleet_pass(fshed, queries, stream)
    shed = [r for r in reqs if r.status == "shed"]
    if not shed or any(r.rejection.reason != "queue_full" for r in shed) \
            or len(shed) + fshed.stats["served"] != len(stream):
        raise AssertionError(f"fleet.{name}: shed {len(shed)}")
    same_requests([r.inner for r in reqs if r.done],
                  [b.inner for r, b in zip(reqs, base) if r.done],
                  f"fleet.{name} shed fleet")
    served_rows = sum(r.queries.shape[0] for r in reqs if r.done)
    out["shed_policy"] = {"max_queue": 256,
                          **_fleet_summary(fshed, served_rows, t)}
    del fshed

    # paged replicas over the paged phase's artifact: one shared cache
    path = ArtifactStore(os.path.join(store_root, "store")).path("main", 1)
    pdata = PagedIndexData(path, cache_bytes=index.cluster_codes.numel() // 4,
                           device=dev)
    fpaged = AnnServeFleet(pdata, n_replicas=2, side_capacity=SIDE,
                           metric=metric)
    if not all(e.index.paged.cache is pdata.cache for e in fpaged.engines):
        raise AssertionError(f"fleet.{name}: paged replicas' caches differ")
    got, t = _fleet_pass(fpaged, queries, stream)
    same_requests([r.inner for r in got], want, f"fleet.{name} paged")
    st = pdata.stats()
    out["paged_2"] = {**_fleet_summary(fpaged, rows, t),
                      **{k: st[k] for k in ("hits", "misses", "evictions")}}
    del fpaged, pdata
    out["launches"] = {"fleet": dict(_build.LAUNCHES)}
    log(f"fleet.{name}", **out)
    return out


# ---------------------------------------------------------------------------
# autotune and JUNO-attention phases
# ---------------------------------------------------------------------------
TUNE_Q = (128, 32, 8)          # the engine's batch buckets
TUNE_SHAPES = (("l2", 48), ("ip", 100))   # the two indexes' S
TUNE_REPEATS = 20


def phase_autotune(seed: int) -> dict:
    """``autotune.lattice`` rows: the two fused scans' launch lattice at
    the indexes' shapes (np 16, P 3912, E 256, C 320, 1024 clusters with
    their valid slots at the front: ``autotune.synthetic_problem``), l2 S 48
    and ip S 100, Q 128, 32 and 8: each shape's outputs bit-equal to the
    default launch's, its median ms (``autotune.measure``: CUDA events, the
    stream asleep before each call, a warm-up and 20 calls), its ratio to
    the default's and the winner. Then ``autotune.cache``: ``ensure_tuned``
    on the card on its own problem (the engines' shape at P 1024) writes
    the cache, a second call installs it without measuring, and the cache
    with its kernels' tag changed is refused, then retuned and rewritten.
    Returns the rows and the tuned configs, which the engines' check
    installs."""
    dev = torch.device("cuda")
    backend = autotune.backend_name(dev)
    shapes = autotune.candidates(backend)
    rows = []
    for kernel in autotune.KERNELS:
        for metric, s in TUNE_SHAPES:
            for q in TUNE_Q:
                prob = autotune.synthetic_problem(
                    kernel, q=q, p=3912, s=s, signed=metric == "ip",
                    device=dev, seed=seed)
                what = f"autotune {kernel} {metric} S={s} Q={q}"
                base = autotune.run_fn(kernel, shapes[0], prob,
                                       metric=metric)()
                for cfg in shapes[1:]:
                    got = autotune.run_fn(kernel, cfg, prob, metric=metric)()
                    if not all(torch.equal(a, b) for a, b in zip(got, base)):
                        raise AssertionError(f"{what}: {cfg.launch()} "
                                             f"differs from the default")
                timed = autotune.measure(kernel, repeats=TUNE_REPEATS,
                                         problem=prob, metric=metric)
                win = autotune.winner(timed)
                default_ms = timed[0][1]
                row = {"kernel": kernel, "metric": metric, "S": s, "Q": q,
                       "np": 16, "P": 3912, "E": 256, "C": 320,
                       "bit_equal_shapes": len(shapes) - 1,
                       "default_ms": default_ms, "winner": win.launch(),
                       "winner_ms": dict(timed)[win],
                       "winner_over_default": dict(timed)[win] / default_ms,
                       "candidates": [dict(**cfg.launch(), ms=ms,
                                           ratio=ms / default_ms)
                                      for cfg, ms in timed]}
                log("autotune.lattice", **row)
                rows.append(row)
                del prob, base
    torch.cuda.empty_cache()

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="autotune_", dir=os.path.join(REPO, "build"))
    real_tune = autotune.tune
    try:
        path = os.path.join(tmp, "autotune.json")
        autotune.reset()
        t0 = time.perf_counter()
        tuned = autotune.ensure_tuned(path, repeats=TUNE_REPEATS, device=dev)
        tune_s = time.perf_counter() - t0
        if autotune.load_cache(path, backend=backend) != tuned:
            raise AssertionError("autotune: the cache does not read back")

        def no_tune(*a, **kw):
            raise AssertionError("ensure_tuned measured despite a valid cache")
        autotune.tune = no_tune
        t0 = time.perf_counter()
        again = autotune.ensure_tuned(path, device=dev)
        hit_s = time.perf_counter() - t0
        autotune.tune = real_tune
        if again != tuned:
            raise AssertionError("autotune: the cache hit installed another "
                                 "config")
        with open(path) as fh:
            doc = json.load(fh)
        doc["kernels"] += "-changed"
        with open(path, "w") as fh:
            json.dump(doc, fh)
        if autotune.load_cache(path, backend=backend) is not None:
            raise AssertionError("autotune: a cache of another build loaded")
        retuned = autotune.ensure_tuned(path, repeats=TUNE_REPEATS,
                                        device=dev)
        if autotune.load_cache(path, backend=backend) != retuned:
            raise AssertionError("autotune: the retuned cache does not read "
                                 "back")
    finally:
        autotune.tune = real_tune
        autotune.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    cache = {"backend": backend, "kernels_tag": autotune.kernels_tag(),
             "tuned": {k: v.launch() for k, v in tuned.items()},
             "ensure_tuned_s": tune_s, "cache_hit_s": hit_s,
             "changed_tag_refused": True,
             "retuned": {k: v.launch() for k, v in retuned.items()}}
    log("autotune.cache", **cache)
    return {"rows": rows, "cache": cache, "tuned": tuned}


class LatticeReplay:
    """Within ``with``: every ``ops.<kernel>_scan`` call the searches make
    runs again at each other launch shape of the lattice (installed with
    ``autotune.set_config``, so through ``ops``' own dispatch), each held
    bit-equal to the default launch's outputs (counts, dist, cand,
    cand_dist, and ``probe_ok`` for the three-stage scan)."""

    def __init__(self, kernel: str, shapes: list):
        self.kernel, self.shapes, self.calls = kernel, shapes, 0
        self._name = f"{kernel}_scan"

    def __enter__(self):
        self._fn = getattr(ops, self._name)

        def replayed(*args, **kw):
            want = self._fn(*args, **kw)
            for cfg in self.shapes[1:]:
                autotune.set_config(self.kernel, cfg)
                try:
                    got = self._fn(*args, **kw)
                finally:
                    autotune.reset()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{self._name}: {cfg.launch()} "
                                         f"differs from the default launch")
            self.calls += 1
            return want
        setattr(ops, self._name, replayed)
        return self

    def __exit__(self, *exc):
        setattr(ops, self._name, self._fn)


def autotune_engines(name: str, metric: str, mut, grid, queries, stream,
                     tuned: dict) -> dict:
    """``autotune.<index>``: (1) one pass of the fused and of the rt fused
    engine on the 1M index with every fused scan call replayed at each
    other launch shape (``LatticeReplay``: bit-equal to the default's);
    (2) the four engines (fused or not, scan or rt) served untuned, with
    the tuned configs installed, and with the lattice's last shape
    installed for both kernels (so a non-default launch runs even where
    the default won): each configured pass's ids and scores bit-equal to
    the untuned pass's, request by request, its signatures equal, and its
    launches (counts set to 0 just before it) exactly its configuration's
    kernels."""
    dev = torch.device("cuda")
    shapes = autotune.candidates(autotune.backend_name(dev))
    installs = {"tuned": tuned,
                "last_shape": {k: shapes[-1] for k in autotune.KERNELS}}
    out = {"replayed_calls": {}, "engines": {}, "launches": {},
           "installs": {k: {kk: c.launch() for kk, c in v.items()}
                        for k, v in installs.items()}}
    for label, g, kernel in (("fused", None, "fused_two_stage"),
                             ("rt_fused", grid, "fused_three_stage")):
        eng = AnnServeEngine(mut, metric=metric, fused=True,
                             prefilter="scan" if g is None else "rt",
                             rt_grid=g)
        with LatticeReplay(kernel, shapes) as rep:
            run_stream(eng, queries, stream)
        if rep.calls == 0:
            raise AssertionError(f"autotune.{name} {label}: no {kernel} call")
        out["replayed_calls"][label] = rep.calls
    for label, fused, g in (("fused", True, None), ("unfused", False, None),
                            ("rt_fused", True, grid),
                            ("rt_unfused", False, grid)):
        pf = "scan" if g is None else "rt"
        kw = dict(metric=metric, fused=fused, prefilter=pf, rt_grid=g)
        autotune.reset()
        base_eng = AnnServeEngine(mut, **kw)
        want, t_base = run_stream(base_eng, queries, stream)
        row = {"untuned_s": t_base}
        for install, configs in installs.items():
            for kernel, cfg in configs.items():
                autotune.set_config(kernel, cfg)
            try:
                eng = AnnServeEngine(mut, **kw)
                _build.reset_launches()
                got, t = run_stream(eng, queries, stream)
                launches = dict(_build.LAUNCHES)
            finally:
                autotune.reset()
            what = f"autotune.{name} {label} {install}"
            same_requests(got, want, what)
            if eng.stats["signatures"] != base_eng.stats["signatures"]:
                raise AssertionError(f"{what}: signatures "
                                     f"{dict(eng.stats['signatures'])} vs "
                                     f"{dict(base_eng.stats['signatures'])}")
            must = ENGINE_KERNELS[(pf, fused)]
            if any(launches[n] <= 0 for n in must) or \
                    any(launches[n] != 0 for n in set(launches) - must):
                raise AssertionError(f"{what}: launches {launches}, expected "
                                     f"exactly {sorted(must)}")
            row[f"{install}_s"] = t
            out["launches"][f"{label}.{install}"] = launches
        row["signatures"] = len(base_eng.stats["signatures"])
        out["engines"][label] = row
    log(f"autotune.{name}", **out)
    return out


# phi4-mini-3.8b FULL's attention (configs/phi4_mini_3_8b.py: 24 query heads
# on 8 KV heads, head_dim 3072 / 24) at decode_32k (launch/shapes.py), B 4
ATTN = dict(batch=4, seq=32_768, heads=24, kv_heads=8, head_dim=128,
            entries=16)
ATTN_TOP_C = (256, 512, 1024)
ATTN_Q_SCALE = 4.0      # q ~ N(0, 16): a peaked softmax over 32k positions
ATTN_TOL = 2.0 ** -6    # 4 bf16 ulps at 1: two bf16 paths' outputs
# the 2-KV-head slice's k-means on the CPU against the card's, from the same
# init draws: f32 sums in another order (index_add_'s atomics on the card)
# move a codebook entry by ~1e-6 an iteration, and a key that changes sides
# at a near-tie moves two entries by |x - c| / n, up to ~1e-3 in an outer
# cluster of a few thousand keys (2.8e-4 measured on an H100); an init,
# subspace or head mix-up moves entries by 1e-1 and more
ATTN_KMEANS_TOL = 1e-2
ATTN_TIE_RTOL = 1e-5    # approximate scores this close count as a tie


def exact_attention(q, k, v, pos, dtype=None):
    """One decode step of plain softmax attention over every valid
    position (0..pos[b]), GQA, in the caches' layout: q (B, 1, H, hd),
    k/v (B, S, KVH, hd). In the caches' dtype with the q·k product cast to
    f32, as JUNO-attention computes it; with ``dtype`` every input is cast
    to it first (float32: the truth both bf16 paths are held to)."""
    if dtype is not None:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    b, _, hq, hd = q.shape
    s, h = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, h, hq // h, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k).float() / (hd ** 0.5)
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgs,bshd->bhgd", w, v).reshape(b, 1, hq, hd)


def sdpa_attention(q, k, v, pos):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    (GQA, a boolean mask of the valid positions) on the same inputs."""
    s = k.shape[1]
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True)
    return o.transpose(1, 2)


def _rel_err(a: torch.Tensor, truth: torch.Tensor) -> tuple[float, float]:
    """(||a - t|| / ||t||, cosine(a, t)) in f32."""
    a, t = a.float().reshape(-1), truth.float().reshape(-1)
    return (float(torch.linalg.norm(a - t) / torch.linalg.norm(t)),
            float(a @ t / (torch.linalg.norm(a) * torch.linalg.norm(t))))


def _attention_cpu_slice(q, index, k, v, pos, init, k_slice, k_new, got,
                         hs: int) -> dict:
    """The first ``hs`` KV heads of ``attn.phi4_mini`` redone on the CPU.

    The build: the CPU's k-means from the card's init draws over the same
    keys (``k_slice``, taken before the step's key was written), then
    ``encode_step`` of the same key. Its codebooks must lie within
    ``ATTN_KMEANS_TOL`` of the card's, and where a code differs the card's
    entry must be a near-tie under the CPU's codebooks: no farther from the
    key than the CPU's pick plus twice the largest entry shift (the
    triangle inequality's room) and 1e-5. The decode: stage 1 and the
    top-C on the CPU from the card's index carried across, at top_c
    ``ATTN_TOP_C[0]``: the positions equal the card's up to score ties,
    and the output equals the card's ``got`` within ``ATTN_TOL``."""
    t0 = time.perf_counter()
    mine = build_kv_index(k_slice, n_entries=index.entries.shape[2],
                          init_idx=init.cpu())
    encode_step(mine, k_new.cpu(), pos.cpu())
    out = {"heads": hs, "build_s": time.perf_counter() - t0}
    card_entries = index.entries[:hs].cpu()
    card_codes = index.codes[:, :hs].cpu()
    shift = float((mine.entries - card_entries).abs().max())
    out["entries_max_abs_diff"] = shift
    if shift > ATTN_KMEANS_TOL:
        raise AssertionError(f"attn: the CPU's k-means codebooks differ from "
                             f"the card's by {shift}")
    diff = card_codes != mine.codes                       # (B, H, S, S_sub)
    out["codes_differing"] = int(diff.sum())
    out["codes"] = diff.numel()
    out["codes_max_excess"] = 0.0
    if out["codes_differing"]:
        bi, hi, si, ui = diff.nonzero(as_tuple=True)
        key = k_slice.clone()
        key[torch.arange(key.shape[0]), pos.cpu()] = k_new[:, 0].cpu()
        x = key.float()[bi, si, hi].reshape(bi.numel(), -1, 2)[
            torch.arange(bi.numel()), ui]                 # (n, 2)

        def dist(codes):
            c = mine.entries[hi, ui, codes[bi, hi, si, ui].long()]
            return torch.linalg.norm(x - c, dim=-1)
        room = 2.0 * shift * 2 ** 0.5 + 1e-5
        out["codes_max_excess"] = float(
            (dist(card_codes) - dist(mine.codes)).max())
        if out["codes_max_excess"] > room:
            raise AssertionError(f"attn: a card code is "
                                 f"{out['codes_max_excess']} farther than "
                                 f"the CPU's (room {room})")
    b, _, hq, hd = q.shape
    qg = q[:, 0].reshape(b, hs, hq // hs, hd)
    carried = kv_index_from_arrays(card_entries.numpy(), card_codes.numpy(),
                                   "cpu")
    t0 = time.perf_counter()
    approx, _ = _approx_scores(qg.cpu(), carried, pos.cpu())
    want = _top_positions(approx, ATTN_TOP_C[0])
    cpu = juno_decode_attention(q.cpu(), carried, k[:, :, :hs].cpu(),
                                v[:, :, :hs].cpu(), pos.cpu(),
                                top_c=ATTN_TOP_C[0])
    out["decode_s"] = time.perf_counter() - t0
    card_approx, _ = _approx_scores(
        qg, type(index)(entries=index.entries[:hs],
                        codes=index.codes[:, :hs]), pos)
    top = _top_positions(card_approx, ATTN_TOP_C[0]).cpu()
    moved = top != want
    out["top_positions_moved"] = int(moved.sum())
    if out["top_positions_moved"]:
        a = torch.take_along_dim(approx, top, -1)[moved]
        w = torch.take_along_dim(approx, want, -1)[moved]
        if bool(((a - w).abs() > ATTN_TIE_RTOL
                 * w.abs().clamp(min=1.0)).any()):
            raise AssertionError("attn: the card's top-C positions differ "
                                 "from the CPU's beyond score ties")
    out["max_abs_err"] = float((cpu.float() - got.cpu().float()).abs().max())
    if out["max_abs_err"] > ATTN_TOL:
        raise AssertionError(f"attn: the CPU's {hs}-head slice differs by "
                             f"{out['max_abs_err']}")
    return out


def phase_attention(seed: int, card: str) -> dict:
    """``attn.phi4_mini``: JUNO-attention (``repro_torch.models``) at the
    attention shape of phi4-mini-3.8b FULL at decode_32k (B 4, S 32,768,
    24 query heads on 8 KV heads of 128 dims, 16 entries a subspace) over
    SYNTHETIC bf16 caches (K, V ~ N(0, 1), q ~ N(0, 16), from a seeded
    generator; no model is ported, so no model's caches): the index's
    build seconds, ``encode_step``'s ms (the step's key written at pos),
    the ms of a decode step at top_c 256, 512 and 1024 beside exact plain
    attention over all S positions and ``scaled_dot_product_attention``,
    each step's least time for the traffic model's bytes (``bound_ms``;
    exact attention's ``exact_bound_ms``),
    each output's rel_err and cosine against exact attention in f32, the
    output at top_c = S equal to exact attention within 4 bf16 ulps, a
    2-KV-head slice checked on the CPU (see :func:`_attention_cpu_slice`),
    and ``traffic_model``'s bytes a (head, step)."""
    dev = torch.device("cuda")
    b, s, hq, h, hd, e = (ATTN[k] for k in ("batch", "seq", "heads",
                                            "kv_heads", "head_dim",
                                            "entries"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    k = torch.randn((b, s, h, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((b, s, h, hd), generator=gen, device=dev).to(bf)
    q = (torch.randn((b, 1, hq, hd), generator=gen, device=dev)
         * ATTN_Q_SCALE).to(bf)
    k_new = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(bf)
    pos = torch.tensor([s - 1, s - 2, 3 * s // 4, s // 2], device=dev)[:b]
    init = draw_kv_init(h, hd // 2, b * s, e, seed=seed, device=dev)
    hs = 2                                # the KV heads checked on the CPU
    k_slice = k[:, :, :hs].cpu()          # before the step's key is written
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_kv_index(k, n_entries=e, init_idx=init)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k[torch.arange(b, device=dev), pos] = k_new[:, 0]
    encode_step(index, k_new, pos)
    out = {"shape": dict(ATTN), "pos": pos.tolist(), "card": card,
           "data": "synthetic: K, V ~ N(0, 1), q ~ N(0, 16), bf16, seeded",
           "cache_bytes": {"k": k.numel() * 2, "v": v.numel() * 2,
                           "codes": index.codes.numel()},
           "build_s": build_s,
           "encode_step_ms": time_ms(lambda: encode_step(index, k_new, pos))}
    truth = exact_attention(q, k, v, pos, torch.float32)
    exact = exact_attention(q, k, v, pos)
    lib = sdpa_attention(q, k, v, pos)
    out["exact_ms"] = time_ms(lambda: exact_attention(q, k, v, pos))
    out["library_ms"] = time_ms(lambda: sdpa_attention(q, k, v, pos))
    # the least time for exact attention's bytes: every K and V byte once
    out["exact_bound_ms"] = (b * h * traffic_model(s, hd, 0)["exact_bytes"]
                             / HBM_BYTES_PER_S * 1e3)
    out["exact_rel_err"], out["exact_cosine"] = _rel_err(exact, truth)
    out["library_rel_err"], out["library_cosine"] = _rel_err(lib, truth)
    rows, first = [], None
    for top_c in ATTN_TOP_C:
        got = juno_decode_attention(q, index, k, v, pos, top_c=top_c)
        if got.shape != q.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"attn top_c={top_c}: shape {got.shape} or "
                                 f"non-finite values")
        first = got if first is None else first
        err, cos = _rel_err(got, truth)
        traffic = traffic_model(s, hd, top_c)
        rows.append({"top_c": top_c, "ms": time_ms(
            lambda c=top_c: juno_decode_attention(q, index, k, v, pos,
                                                  top_c=c)),
            "rel_err": err, "cosine": cos,
            "traffic_per_head_step": traffic,
            # the traffic model's bytes (codes, then the top-C keys and
            # values) for every (batch row, KV head), once
            "bound_ms": b * h * traffic["juno_bytes"] / HBM_BYTES_PER_S
            * 1e3})
    out["decode"] = rows
    full = juno_decode_attention(q, index, k, v, pos, top_c=s)
    bound = ATTN_TOL * max(1.0, float(exact.float().abs().max()))
    out["full_top_c_max_abs_err"] = float((full.float() - exact.float())
                                          .abs().max())
    if out["full_top_c_max_abs_err"] > bound:
        raise AssertionError(f"attn top_c=S: {out['full_top_c_max_abs_err']}"
                             f" from exact attention (limit {bound})")
    out["cpu_slice"] = _attention_cpu_slice(
        q[:, :, :hs * (hq // h)], index, k, v, pos, init[:hs], k_slice,
        k_new[:, :, :hs], first[:, :, :hs * (hq // h)], hs)
    log("attn.phi4_mini", **out)
    del k, v, index, truth, exact, lib, full
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# LM phase
# ---------------------------------------------------------------------------
# phi4-mini-3.8b FULL (configs/phi4_mini_3_8b.py: 32 layers, d 3072, 24 query
# heads on 8 KV heads, d_ff 8192, vocab 200,064), bf16, random init
LM = dict(arch="phi4_mini_3_8b", n_slots=8, max_seq=4096, n_requests=16,
          prompt=(32, 1024), max_new=(16, 64), check_layers=4, batch=4,
          seq=4096, slice_layers=2, slice_batch=2, slice_tokens=64,
          entries=16, q_scale=0.5,
          # the plain replay checks the first 256 of the ~1,630 ticks (the
          # host-bound replay took 62-100 s whole; lm.families and
          # train.phi4_mini need the time under the script's 1200 s)
          replay_ticks=256)
LM_TOP_C = (256, 512, 1024)
LM_CONSISTENCY_TOL = 2e-2      # tests/test_arch_smoke.py:114, rtol = atol
# the card's 2-layer bf16 logits against the CPU's on the same weights and
# tokens: within 2^-5 of the largest magnitude, four bf16 ulps at the top
# (another accumulation order in every bf16 product; the tolerance the CPU
# tests hold the port to the reference with), written before the first run
LM_SLICE_TOL = 2.0 ** -5


class TickLogEngine(ServeEngine):
    """A :class:`ServeEngine` that records each tick's tokens, positions
    and the request id in each slot (-1 for a free one) as it hands them
    to its decode (a CUDA graph from the second tick on)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.ticks = []

    def _tick(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        self.ticks.append((tokens[:, 0].copy(), pos.copy(),
                           [-1 if r is None else r.rid
                            for r in self.slot_req]))
        return super()._tick(tokens, pos)


def lm_requests(rng, vocab: int, spec: dict = LM) -> list:
    """``spec["n_requests"]`` requests: prompt lengths and ``max_new`` drawn
    uniformly from the ``spec["prompt"]`` and ``spec["max_new"]`` ranges,
    prompt ids uniform over the vocabulary."""
    lens = rng.integers(spec["prompt"][0], spec["prompt"][1] + 1,
                        spec["n_requests"])
    new = rng.integers(spec["max_new"][0], spec["max_new"][1] + 1,
                       spec["n_requests"])
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)).tolist(),
                    max_new=int(m)) for i, (n, m) in enumerate(zip(lens, new))]


def replay_ticks(model, params, ticks: list, reqs: list, n_slots: int,
                 max_seq: int, dev, n_ticks: Optional[int] = None) -> dict:
    """The engine's tick schedule (:class:`TickLogEngine`'s), or its first
    ``n_ticks`` ticks, replayed through ``model.decode`` (plain PyTorch, no
    graph) on a fresh cache: every logit finite, each tick's fed tokens the
    prompt's or the replay's last pick, each request's ``out`` equal to the
    replay's picks (the same device and batch: bit-equal; past a prefix,
    the picks it made), no position past ``max_seq``."""
    ticks = ticks[:n_ticks]
    cache = init_params(model.cache_schema(n_slots, max_seq), device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    picks = []
    for token, pos, _ in ticks:
        logits, cache = model.decode(
            params, cache, torch.from_numpy(token[:, None]).to(dev),
            torch.from_numpy(pos).to(dev))
        finite &= torch.isfinite(logits).all()
        picks.append(torch.argmax(logits, dim=-1))
    if not bool(finite):
        raise AssertionError("lm: a non-finite logit in the replay")
    picks = torch.stack(picks).cpu().numpy()
    by_rid = {r.rid: r for r in reqs}
    want = {r.rid: [] for r in reqs}
    for t, (tokens, positions, rids) in enumerate(ticks):
        for s, rid in enumerate(rids):
            if rid < 0:
                continue
            prompt, p = by_rid[rid].prompt, int(positions[s])
            fed = prompt[p] if p < len(prompt) else want[rid][-1]
            if tokens[s] != fed:
                raise AssertionError(f"lm: tick {t} slot {s} fed "
                                     f"{tokens[s]}, not {fed}")
            if p >= len(prompt) - 1:
                want[rid].append(int(picks[t, s]))
    for r in reqs:
        if r.out[:len(want[r.rid])] != want[r.rid]:
            raise AssertionError(f"lm: request {r.rid}'s output differs from "
                                 f"the replay through decode")
    max_pos = max(int(p.max()) for _, p, _ in ticks)
    if max_pos >= max_seq:
        raise AssertionError(f"lm: position {max_pos} past max_seq {max_seq}")
    live = [sum(int(p[s]) + 1 for s, rid in enumerate(rids) if rid >= 0)
            for _, p, rids in ticks]
    return {"replayed_ticks": len(ticks), "max_pos": max_pos,
            "outputs_equal": sum(len(want[r.rid]) == len(r.out)
                                 for r in reqs),
            "tokens_checked": sum(len(w) for w in want.values()),
            "live_cache_share": statistics.mean(live) / (n_slots * max_seq)}


def lm_consistency(cfg, params, tokens: torch.Tensor, dev, **extra) -> dict:
    """``prefill`` of tokens[:, :-1] and one ``decode`` of the last token
    against ``forward`` at the same two positions: (the forward logits at
    T-2 and T-1, prefill's, decode's), (B, V) f32 each. ``extra``: a VLM's
    ``context`` or Whisper's ``frames`` (its forward is the decoder's over
    the encoded frames)."""
    model = get_model(cfg)
    b, t = tokens.shape
    with torch.inference_mode():
        if cfg.encoder_decoder:
            x = lm_whisper.decoder_forward(cfg, params, tokens,
                                           lm_whisper.encode(
                                               cfg, params, extra["frames"]))
        else:
            x = lm_transformer.forward(cfg, params, tokens,
                                       context=extra.get("context"))
        full = lm_transformer.lm_logits(cfg, params, x[:, -2:])
    del x
    cache = init_params(model.cache_schema(b, t), device=dev)
    pre, cache = model.prefill(params, {"tokens": tokens[:, :-1], **extra},
                               cache)
    dec, cache = model.decode(params, cache, tokens[:, -1:], t - 1)
    return {"forward": full, "prefill": pre, "decode": dec, "cache": cache}


def _logit_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    return {"max_abs_diff": float((got - want).abs().max()),
            "max_abs": float(want.abs().max()),
            "top1_agree": float((got.argmax(-1) == want.argmax(-1))
                                .float().mean())}


def _first_layers(params: dict, n: int, fn=lambda x: x) -> dict:
    """The first n stacked layers (a VLM's first n groups, Whisper's first
    n encoder and decoder layers) and every unstacked leaf, through fn."""
    return {k: (lm_params.tree_map(lambda x: fn(x[:n]), v)
                if k.endswith("blocks") else fn(v))
            for k, v in params.items()}


def phase_lm(seed: int, card: str) -> dict:
    """``lm.phi4_mini``: the dense LM serving path (``repro_torch.models``,
    ``serve/engine.py``; plain PyTorch, no kernel of the port) on
    phi4-mini-3.8b FULL in bf16 from a seeded random init.

    1. init: parameter count, bytes, seconds;
    2. serve: :class:`ServeEngine` with 8 slots of 4096 positions, 16
       requests (prompts 32-1024 tokens, ``max_new`` 16-64, from the seed)
       to the end; ms a tick (median, p99), tokens/s, the tick's byte
       bound, a CUDA-event time of one decode at the same batch and of the
       f32 upcast of the K cache it makes; every output produced in the
       first ``LM["replay_ticks"]`` ticks equal to a replay of those ticks
       through ``api.decode`` (:func:`replay_ticks`);
    3. consistency: prefill (B 4, T 4096, the flash path) and one decode
       against ``forward`` in f32 at 4 layers, within
       ``LM_CONSISTENCY_TOL``; then in bf16 at 32 layers, recorded;
    4. a CPU slice: the embedding, blocks 0-1, final norm and head copied
       to the CPU, 64 tokens a row through the CPU path, the logits within
       ``LM_SLICE_TOL`` of the card's 2-layer run;
    5. JUNO-attention on the model's keys (``examples/juno_attention_lm.py``
       on the port): layer 0's K cache from step 3's bf16 prefill indexed,
       ``juno_decode_attention`` at top_c 256/512/1024 against the port's
       exact ``layers.attention`` (rel_err, cosine, ms), top_c = S within
       ``ATTN_TOL`` of exact.
    """
    dev = resolve_device()
    cfg = get_lm_config(LM["arch"])
    out: dict = {"config": cfg.name, "dtype": cfg.dtype, "card": card,
                 "shape": dict(LM)}
    secs: dict = {}
    t_phase = time.perf_counter()
    _build.reset_launches()
    # 1. init
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(model.schema, gen, device=dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    leaves = lm_params.tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    if n_params != cfg.n_params() + cfg.d_model:     # + the final norm
        raise AssertionError(f"lm: {n_params} parameters for "
                             f"{cfg.n_params()} + {cfg.d_model}")
    out["init"] = {"n_params": n_params, "bytes": sum(
        x.numel() * x.element_size() for x in leaves),
        "seconds": time.perf_counter() - t0}
    secs["init"] = time.perf_counter() - t_phase

    # 2. serve
    rng = np.random.default_rng(seed)
    reqs = lm_requests(rng, cfg.vocab_size)
    eng = TickLogEngine(model, params, n_slots=LM["n_slots"],
                  max_seq=LM["max_seq"], device=dev)
    for r in reqs:
        eng.submit(r)
    tick_s = []
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        t1 = time.perf_counter()
        eng.step()
        tick_s.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    fed = sum(len(r.prompt) for r in reqs) + sum(len(r.out) for r in reqs)
    generated = sum(len(r.out) for r in reqs)
    ms = sorted(s * 1e3 for s in tick_s)
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in lm_params.tree_leaves(eng.cache))
    weight_bytes = out["init"]["bytes"] - params["embed"].numel() * 2
    # a tick reads every weight but the embedding table (B rows of it) and
    # the whole cache (the grouped decode masks it by position, unsliced)
    tick_bytes = (weight_bytes + cache_bytes
                  + LM["n_slots"] * cfg.d_model * 2)
    ticks = eng.ticks
    tok = torch.from_numpy(ticks[-1][0][:, None]).to(dev)
    pos = torch.from_numpy(ticks[-1][1]).to(dev)
    k0 = eng.cache["blocks"]["k"][0]
    serve = {
        "requests": len(reqs), "ticks": len(tick_s), "seconds": wall,
        "tick_ms_first": tick_s[0] * 1e3,
        "tick_ms_median": statistics.median(ms),
        "tick_ms_p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
        "tokens_fed": fed, "tokens_generated": generated,
        "tokens_per_s": fed / wall, "generated_per_s": generated / wall,
        "cache_bytes": cache_bytes, "tick_bytes": tick_bytes,
        "tick_bound_ms": tick_bytes / HBM_BYTES_PER_S * 1e3,
        # one decode at the same batch: plain (the host's launches in it)
        # and the engine's CUDA graph of it (the device's time)
        "decode_ms": time_ms(lambda: model.decode(params, eng.cache, tok,
                                                  pos), reps=10),
        "graph_ms": time_ms(eng._graph[0].replay, reps=10),
        # the grouped path's f32 copy of one layer's K cache, times layers
        "k_upcast_ms_per_tick": cfg.n_layers * time_ms(
            lambda: k0.transpose(1, 2).to(
                torch.float32, memory_format=torch.contiguous_format))}
    del eng
    torch.cuda.empty_cache()
    serve.update(replay_ticks(model, params, ticks, reqs, LM["n_slots"],
                              LM["max_seq"], dev, LM["replay_ticks"]))
    out["serve"] = serve
    secs["serve"] = time.perf_counter() - t_phase - sum(secs.values())
    del ticks
    torch.cuda.empty_cache()

    # 3. consistency: f32 at 4 layers (gated), bf16 at 32 (recorded)
    gen_t = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (LM["batch"], LM["seq"] + 1),
                           generator=gen_t, device=dev, dtype=torch.int32)
    cfg4 = dataclasses.replace(cfg, n_layers=LM["check_layers"],
                               dtype="float32")
    c4 = lm_consistency(cfg4, _first_layers(params, LM["check_layers"],
                                            lambda x: x.float()), tokens, dev)
    cons = {}
    for name, got, want in (("prefill", c4["prefill"], c4["forward"][:, 0]),
                            ("decode", c4["decode"], c4["forward"][:, 1])):
        cons[f"f32_{name}"] = _logit_diff(got, want)
        bad = (got - want).abs() > LM_CONSISTENCY_TOL * (1 + want.abs())
        if bool(bad.any()):
            raise AssertionError(f"lm f32 {LM['check_layers']} layers: "
                                 f"{name} differs from forward by "
                                 f"{cons[f'f32_{name}']['max_abs_diff']}")
    del c4
    torch.cuda.empty_cache()
    c32 = lm_consistency(cfg, params, tokens, dev)
    for name, got, want in (("prefill", c32["prefill"], c32["forward"][:, 0]),
                            ("decode", c32["decode"], c32["forward"][:, 1])):
        if got.shape != (LM["batch"], cfg.vocab_size) or not bool(
                torch.isfinite(got).all() & torch.isfinite(want).all()):
            raise AssertionError(f"lm bf16: {name} logits {tuple(got.shape)}"
                                 f" or non-finite")
        cons[f"bf16_{name}"] = _logit_diff(got, want)
    out["consistency"] = cons
    secs["consistency"] = time.perf_counter() - t_phase - sum(secs.values())

    # 4. the CPU slice: 2 layers, 64 tokens a row
    cfg2 = dataclasses.replace(cfg, n_layers=LM["slice_layers"])
    toks = tokens[:LM["slice_batch"], :LM["slice_tokens"]]
    p2 = _first_layers(params, LM["slice_layers"])
    card_logits = lm_transformer.lm_logits(
        cfg2, p2, lm_transformer.forward(cfg2, p2, toks)).cpu()
    p2_cpu = _first_layers(params, LM["slice_layers"], lambda x: x.cpu())
    t0 = time.perf_counter()
    cpu_logits = lm_transformer.lm_logits(
        cfg2, p2_cpu, lm_transformer.forward(cfg2, p2_cpu, toks.cpu()))
    sl = {"seconds_cpu": time.perf_counter() - t0,
          **_logit_diff(cpu_logits, card_logits), "tol": LM_SLICE_TOL}
    if sl["max_abs_diff"] > LM_SLICE_TOL * sl["max_abs"]:
        raise AssertionError(f"lm: the CPU's 2-layer logits differ from the "
                             f"card's by {sl['max_abs_diff']}")
    out["cpu_slice"] = sl
    del p2_cpu, cpu_logits, card_logits
    secs["cpu_slice"] = time.perf_counter() - t_phase - sum(secs.values())

    # 5. JUNO-attention on layer 0's keys of the bf16 prefill
    s = LM["seq"]
    k = c32["cache"]["blocks"]["k"][0][:, :s]            # the prompt's keys
    v = c32["cache"]["blocks"]["v"][0][:, :s]
    del c32
    b = LM["batch"]
    q = (torch.randn((b, 1, cfg.n_heads, cfg.head_dim), generator=gen_t,
                     device=dev) * LM["q_scale"]).to(k.dtype)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_kv_index(k, n_entries=LM["entries"], seed=seed)
    torch.cuda.synchronize()

    def exact_fn():
        return lm_layers.attention(q, k, v, causal=True, q_offset=pos,
                                   kv_len=pos + 1, chunk=cfg.attn_chunk)
    exact = exact_fn()
    juno = {"build_s": time.perf_counter() - t0, "exact_ms": time_ms(exact_fn),
            "data": f"layer 0's K/V of the bf16 prefill (B {b}, S {s}); "
                    f"q ~ N(0, 1) * {LM['q_scale']}", "decode": []}
    for top_c in LM_TOP_C:
        got = juno_decode_attention(q, index, k, v, pos, top_c=top_c)
        if got.shape != q.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"lm juno top_c={top_c}: shape or finite")
        err, cos = _rel_err(got, exact)
        juno["decode"].append({"top_c": top_c, "rel_err": err, "cosine": cos,
                               "ms": time_ms(lambda c=top_c:
                                             juno_decode_attention(
                                                 q, index, k, v, pos,
                                                 top_c=c))})
    full = juno_decode_attention(q, index, k, v, pos, top_c=s)
    bound = ATTN_TOL * max(1.0, float(exact.float().abs().max()))
    juno["full_top_c_max_abs_err"] = float((full.float() - exact.float())
                                           .abs().max())
    if juno["full_top_c_max_abs_err"] > bound:
        raise AssertionError(f"lm juno top_c=S: "
                             f"{juno['full_top_c_max_abs_err']} from exact "
                             f"attention (limit {bound})")
    out["juno_attention"] = juno
    secs["juno_attention"] = time.perf_counter() - t_phase - sum(
        secs.values())
    out["launches"] = dict(_build.LAUNCHES)
    if any(out["launches"].values()):
        raise AssertionError(f"lm: the LM path launched a kernel of the "
                             f"port: {out['launches']}")
    out["max_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["seconds"] = secs
    log("lm.phi4_mini", **out)
    del params, k, v, index, exact, full
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# LM families phase
# ---------------------------------------------------------------------------
# The six non-dense families at full width, one model at a time, from a
# seeded random init in bf16 (configs/<arch>.py). ``serve``: a ServeEngine
# checked against a plain replay of its ticks; ``check``: prefill/decode
# against forward in f32 at ``check_layers`` (gated, under the MoE capacity
# rule) and in bf16 at the model's depth (recorded). A model whose FULL
# depth does not fit one H100 runs at the ``layers`` depth given, the
# widths unchanged.
FAMILIES = {
    "deepseek_v2_lite_16b": dict(
        serve=dict(n_slots=8, max_seq=4096, n_requests=8, prompt=(32, 512),
                   max_new=(16, 32)),
        check_layers=4, check_t=1024, drop_batch=4, drop_seq=4096,
        mla_t=512),
    "mamba2_1_3b": dict(
        serve=dict(n_slots=4, max_seq=512, n_requests=8, prompt=(32, 256),
                   max_new=(16, 32)),
        check_layers=4, batch=4, seq=4096),
    "hymba_1_5b": dict(
        serve=dict(n_slots=4, max_seq=512, n_requests=8, prompt=(32, 256),
                   max_new=(16, 32)),
        check_layers=4, batch=4, seq=4096),
    "whisper_large_v3": dict(batch=4, prompt=32, steps=32, check_layers=4,
                             check_batch=2),
    "llama4_scout_17b_a16e": dict(
        layers=4, batch=2, seq=1024, steps=16, check_layers=2, check_t=1024,
        reason="FULL is 48 layers, 107.8 B parameters (216 GB in bf16): "
               "not one H100's 80 GB; 4 layers are 10.9 B"),
    "llama_3_2_vision_90b": dict(
        layers=10, batch=2, seq=256, steps=16, check_layers=5,
        reason="FULL is 100 layers, 87.7 B parameters (175 GB in bf16): "
               "not one H100's 80 GB; 10 layers (2 groups of 4 self blocks "
               "and 1 cross block) are 10.7 B"),
}
MLA_TOL = 1e-3        # absorbed vs decompressed MLA, f32, relative
# the plain replay checks each served family's first 256 ticks (of 301
# and 458; the host-bound replays took 127 s whole, and shard.phi4_mini
# needs the time under the script's 1200 s), as lm.phi4_mini's does
FAMILY_REPLAY_TICKS = 256


class MoEDrops:
    """Within the block, each ``moe.moe_ffn`` call's routing: its tokens,
    slots, capacity, dropped slots, and the dropped slots of each batch
    row's last token (the call's routing redone by ``moe.route`` on the
    same input; ``transformer`` reaches ``moe_ffn`` through the module)."""

    def __enter__(self):
        self.orig, self.calls = lm_moe.moe_ffn, []

        def moe_ffn(x, p, moe):
            b, t, d = x.shape
            *_, keep, cap = lm_moe.route(x.reshape(b * t, d), p["router"],
                                         moe)
            keep = keep.view(b, t, moe.top_k)
            self.calls.append({"tokens": b * t, "slots": keep.numel(),
                               "cap": cap,
                               "dropped": int((~keep).sum()),
                               "last_dropped": int((~keep[:, -1]).sum())})
            return self.orig(x, p, moe)
        lm_moe.moe_ffn = moe_ffn
        return self.calls

    def __exit__(self, *exc):
        lm_moe.moe_ffn = self.orig


def _family_init(cfg, seed: int, dev) -> tuple:
    """The model's API and its seeded bf16 parameters, with their count,
    bytes and seconds."""
    model = get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(model.schema, torch.Generator(device=dev)
                         .manual_seed(seed), device=dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    leaves = lm_params.tree_leaves(params)
    n = sum(x.numel() for x in leaves)
    if n != lm_params.n_params(model.schema):
        raise AssertionError(f"{cfg.name}: {n} parameters for its schema's "
                             f"{lm_params.n_params(model.schema)}")
    return model, params, {
        "n_params": n, "n_params_analytic": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "bytes": sum(x.numel() * x.element_size() for x in leaves),
        "seconds": time.perf_counter() - t0}


def _family_serve(cfg, model, params, spec: dict, seed: int, dev) -> dict:
    """A :class:`TickLogEngine` serving ``spec``'s requests to the end: ms
    a tick, tokens/s, the tick's byte bound, the graph's CUDA-event ms;
    every output equal to the plain replay of the first
    ``FAMILY_REPLAY_TICKS`` ticks (:func:`replay_ticks`: each request's
    prefix; whole where its last tick is replayed); the
    requests admitted to a slot an earlier request had used (whose SSM
    state they inherit: ROADMAP queue 3)."""
    reqs = lm_requests(np.random.default_rng(seed), cfg.vocab_size, spec)
    eng = TickLogEngine(model, params, n_slots=spec["n_slots"],
                        max_seq=spec["max_seq"], device=dev)
    for r in reqs:
        eng.submit(r)
    tick_s = []
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        t1 = time.perf_counter()
        eng.step()
        tick_s.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    ms = sorted(x * 1e3 for x in tick_s)
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in lm_params.tree_leaves(params)
                       ) - params["embed"].numel() * 2
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in lm_params.tree_leaves(eng.cache))
    # a tick reads every weight but the embedding table (B rows of it):
    # the dense capacity path runs every expert, and the whole cache (the
    # decode masks it by position, unsliced)
    tick_bytes = weight_bytes + cache_bytes
    fed = sum(len(r.prompt) + len(r.out) for r in reqs)
    seen, reused = set(), 0
    for _, _, rids in eng.ticks:
        for slot, rid in enumerate(rids):
            if rid >= 0 and (slot, rid) not in seen:
                reused += any(sl == slot for sl, _ in seen)
                seen.add((slot, rid))
    out = {"n_slots": spec["n_slots"], "max_seq": spec["max_seq"],
           "requests": len(reqs), "ticks": len(tick_s), "seconds": wall,
           "tick_ms_first": tick_s[0] * 1e3,
           "tick_ms_median": statistics.median(ms),
           "tick_ms_p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
           "tokens_per_s": fed / wall,
           "generated_per_s": sum(len(r.out) for r in reqs) / wall,
           "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
           "tick_bytes": tick_bytes,
           "tick_bound_ms": tick_bytes / HBM_BYTES_PER_S * 1e3,
           "graph_ms": time_ms(eng._graph[0].replay, reps=10),
           "requests_on_a_used_slot": reused}
    ticks = eng.ticks
    del eng
    torch.cuda.empty_cache()
    # a request is whole in the replay when its last tick is replayed
    last = {}
    for t, (_, _, rids) in enumerate(ticks):
        for rid in rids:
            if rid >= 0:
                last[int(rid)] = t
    out["outputs_whole_in_replay"] = sum(
        last[r.rid] < FAMILY_REPLAY_TICKS for r in reqs)
    t0 = time.perf_counter()
    out.update(replay_ticks(model, params, ticks, reqs, spec["n_slots"],
                            spec["max_seq"], dev, FAMILY_REPLAY_TICKS))
    out["replay_s"] = time.perf_counter() - t0
    if out["outputs_equal"] != out["outputs_whole_in_replay"]:
        raise AssertionError(f"{cfg.name}: {out['outputs_equal']} of "
                             f"{out['outputs_whole_in_replay']} outputs "
                             f"replayed whole")
    return out


def _gate(name: str, got: torch.Tensor, want: torch.Tensor, gate: bool
          ) -> dict:
    """``got`` against ``want`` (B, V): max |Δ|, top-1 agreement; with
    ``gate``, fail past ``LM_CONSISTENCY_TOL`` (rtol = atol)."""
    if not bool(torch.isfinite(got).all() & torch.isfinite(want).all()):
        raise AssertionError(f"{name}: a non-finite logit")
    d = _logit_diff(got, want)
    d["gated"] = gate
    if gate and bool(((got - want).abs() > LM_CONSISTENCY_TOL
                      * (1 + want.abs())).any()):
        raise AssertionError(f"{name} differs from forward by "
                             f"{d['max_abs_diff']}")
    return d


def _family_check(cfg, params, tokens, dev, tag: str, *, gate: bool,
                  gate_decode: Optional[bool] = None, drops: bool = False,
                  **extra) -> dict:
    """:func:`lm_consistency` of ``cfg`` (prefill and decode against
    forward), gated with ``gate`` (decode with ``gate_decode``, if given);
    with ``drops``, under :class:`MoEDrops`: decode is gated only where
    forward kept every slot of its last token (prefill's capacity equals
    forward's, so the prefix routes alike)."""
    t = tokens.shape[1]
    if drops:
        with MoEDrops() as calls:
            c = lm_consistency(cfg, params, tokens, dev, **extra)
        fwd = [x for x in calls if x["tokens"] == tokens.shape[0] * t]
        last = sum(x["last_dropped"] for x in fwd)
        out = {"forward_dropped": sum(x["dropped"] for x in fwd),
               "forward_last_token_dropped": last,
               "cap": [x["cap"] for x in fwd][:1]}
    else:
        c, last, out = lm_consistency(cfg, params, tokens, dev, **extra), 0, {}
    out["prefill"] = _gate(f"{tag} prefill", c["prefill"], c["forward"][:, 0],
                           gate)
    gate_decode = gate if gate_decode is None else gate_decode
    out["decode"] = _gate(f"{tag} decode", c["decode"], c["forward"][:, 1],
                          gate_decode and not last)
    return out


def _moe_check_t(cfg, params, toks: torch.Tensor, t0: int) -> tuple:
    """A prompt length T for the MoE f32 check (batch 1): T with cap(T) =
    cap(T + 1), so prefill routes the prefix as forward does, tried from
    t0 down by halves to 16 (each moved up to the next T that meets the
    rule), the first where forward over T + 1 tokens of ``toks`` keeps
    every slot of its last token, as decode (n = 1, cap 8) does; else t0's.
    Returns (T, each T tried with forward's dropped slots of its last
    token)."""
    tried, t = [], t0
    while t >= 16:
        u = t
        while lm_moe.capacity(u, cfg.moe) != lm_moe.capacity(u + 1, cfg.moe):
            u += 1
        with MoEDrops() as calls, torch.inference_mode():
            lm_transformer.forward(cfg, params, toks[:, :u + 1])
        tried.append([u, sum(c["last_dropped"] for c in calls)])
        if not tried[-1][1]:
            return u, tried
        t //= 2
    return tried[0][0], tried


def _mla_alone(cfg, params, t: int, dev, gen) -> dict:
    """Layer 0's MLA at full width: the absorbed decode of token t-1
    against the decompressed attention's output at the same position, in
    f32 (gated at ``MLA_TOL`` relative) and bf16 (recorded)."""
    out = {}
    x32 = torch.randn((1, t, cfg.d_model), generator=gen, device=dev)
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dt)
        p = lm_params.cast_floats(lm_transformer.layer(params["blocks"], 0)
                                  ["attn"], dt)
        x = x32.to(getattr(torch, dt))
        pos = torch.arange(t, device=dev)
        full = lm_mla.mla_attention(x, p, c, pos)[:, -1]
        ckv, kr = lm_mla._latent_kv(x[:, :-1], p, c, pos[:-1])
        m = cfg.mla
        ckv_c = torch.zeros((1, t, m.kv_lora_rank), dtype=x.dtype, device=dev)
        kr_c = torch.zeros((1, t, m.qk_rope_dim), dtype=x.dtype, device=dev)
        ckv_c[:, :t - 1], kr_c[:, :t - 1] = ckv, kr
        dec, _, _ = lm_mla.mla_decode(
            x[:, -1:], p, c, ckv_c, kr_c,
            torch.tensor([t - 1], dtype=torch.int32, device=dev))
        rel = float((dec[:, 0].float() - full.float()).abs().max()
                    / full.float().abs().max())
        out[dt] = {"rel_err": rel, "max_abs": float(full.float().abs().max())}
        if dt == "float32" and not rel <= MLA_TOL:
            raise AssertionError(f"mla: absorbed decode {rel} from the "
                                 f"decompressed path (limit {MLA_TOL})")
    return out


def _decode_steps(model, params, cache, logits, pos: int, steps: int,
                  dev) -> dict:
    """``steps`` greedy plain decodes from prefill's last logits at
    position ``pos``: ms a step (host clock around synchronised steps),
    every logit finite."""
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode(params, cache, tok, pos + i)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"decode step {i}: a non-finite logit")
    return {"steps": steps, "step_ms_median": statistics.median(times),
            "step_ms_max": max(times)}


def _family(name: str, seed: int, card: str, dev) -> dict:
    """One model of ``lm.families``; see :func:`phase_families`."""
    spec = FAMILIES[name]
    full = get_lm_config(name)
    cfg = (dataclasses.replace(full, n_layers=spec["layers"])
           if "layers" in spec else full)
    out: dict = {"model": name, "config": cfg.name, "dtype": cfg.dtype,
                 "n_layers": cfg.n_layers, "card": card}
    if "layers" in spec:
        out["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers],
                          "reason": spec["reason"]}
    torch.cuda.reset_peak_memory_stats()
    t_model = time.perf_counter()
    model, params, out["init"] = _family_init(cfg, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    fp32 = lambda x: x.float()  # noqa: E731
    cl = spec["check_layers"]
    cfg_c = dataclasses.replace(cfg, n_layers=cl, dtype="float32")
    if cfg.encoder_decoder:
        cfg_c = dataclasses.replace(cfg_c, n_encoder_layers=cl)
    if "serve" in spec:
        out["serve"] = _family_serve(cfg, model, params, spec["serve"], seed,
                                     dev)
    if cfg.moe:
        p32 = _first_layers(params, cl, fp32)
        toks = torch.randint(0, cfg.vocab_size, (1, 2 * spec["check_t"]),
                             generator=gen, device=dev, dtype=torch.int32)
        t, tried = _moe_check_t(cfg_c, p32, toks, spec["check_t"])
        out["check_f32"] = {"layers": cl, "batch": 1, "t": t,
                            "t_tried_last_dropped": tried, **_family_check(
                                cfg_c, p32, toks[:, :t + 1], dev,
                                f"{name} f32", gate=True, drops=True)}
        del p32
    if name == "deepseek_v2_lite_16b":
        toks = torch.randint(0, cfg.vocab_size,
                             (spec["drop_batch"], spec["drop_seq"]),
                             generator=gen, device=dev, dtype=torch.int32)
        with MoEDrops() as calls, torch.inference_mode():
            lm_transformer.forward(cfg, params, toks)
        out["drops_bf16"] = {
            "batch": spec["drop_batch"], "seq": spec["drop_seq"],
            "cap": calls[0]["cap"], "slots": sum(c["slots"] for c in calls),
            "dropped": sum(c["dropped"] for c in calls),
            "share": sum(c["dropped"] for c in calls)
            / sum(c["slots"] for c in calls),
            "share_by_layer": [c["dropped"] / c["slots"] for c in calls]}
        out["mla"] = _mla_alone(cfg, params, spec["mla_t"], dev, gen)
    if cfg.mixer_kind in ("ssm", "hybrid"):
        toks = torch.randint(0, cfg.vocab_size, (spec["batch"],
                                                 spec["seq"] + 1),
                             generator=gen, device=dev, dtype=torch.int32)
        out["check_f32"] = {"layers": cl, "batch": spec["batch"],
                            "t": spec["seq"], **_family_check(
                                cfg_c, _first_layers(params, cl, fp32), toks,
                                dev, f"{name} f32", gate=True)}
        out["check_bf16"] = {"layers": cfg.n_layers, **_family_check(
            cfg, params, toks, dev, f"{name} bf16", gate=False)}
    if cfg.encoder_decoder:
        b, tp = spec["batch"], spec["prompt"]
        frames = torch.randn((b, cfg.n_context_tokens, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
        toks = torch.randint(0, cfg.vocab_size, (b, tp + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        cache = init_params(model.cache_schema(b, tp + spec["steps"]),
                            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks[:, :tp],
                                               "frames": frames}, cache)
        torch.cuda.synchronize()
        out["generate"] = {"batch": b, "prompt": tp, "frames":
                           cfg.n_context_tokens,
                           "prefill_ms": (time.perf_counter() - t0) * 1e3,
                           **_decode_steps(model, params, cache, logits, tp,
                                           spec["steps"], dev)}
        del cache
        cb = spec["check_batch"]
        out["check_f32"] = {"layers": [cl, cl], "batch": cb, "t": tp,
                            **_family_check(
                                cfg_c, _first_layers(params, cl, fp32),
                                toks[:cb], dev, f"{name} f32", gate=True,
                                frames=frames[:cb].float())}
    if "steps" in spec and not cfg.encoder_decoder:
        b, t = spec["batch"], spec["seq"]
        toks = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                             device=dev, dtype=torch.int32)
        extra = {}
        if cfg.cross_attn_period:
            extra["context"] = torch.randn(
                (b, cfg.n_context_tokens, cfg.d_model), generator=gen,
                device=dev).to(torch.bfloat16)
        cache = init_params(model.cache_schema(b, t + spec["steps"]),
                            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks, **extra},
                                      cache)
        torch.cuda.synchronize()
        out["generate"] = {"batch": b, "prompt": t, **{
            k: list(v.shape) for k, v in extra.items()},
            "prefill_ms": (time.perf_counter() - t0) * 1e3,
            **_decode_steps(model, params, cache, logits, t, spec["steps"],
                            dev)}
        del cache
    if cfg.cross_attn_period:
        # prefill gated; decode recorded: the reference's cached context
        # K/V skip lnc (ROADMAP queue 3), so decode must miss forward
        t = 64
        toks = torch.randint(0, cfg.vocab_size, (1, t + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        ctx = torch.randn((1, cfg.n_context_tokens, cfg.d_model),
                          generator=gen, device=dev)
        c = _family_check(cfg_c, _first_layers(params, cl // cfg
                                               .cross_attn_period, fp32),
                          toks, dev, f"{name} f32", gate=True,
                          gate_decode=False, context=ctx)
        if not c["decode"]["max_abs_diff"] > 0:
            raise AssertionError(f"{name}: decode equals forward; the "
                                 f"reference's cross-cache miss is gone")
        out["check_f32"] = {"layers": cl, "batch": 1, "t": t, **c}
    out["max_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["seconds"] = time.perf_counter() - t_model
    del model, params
    torch.cuda.empty_cache()
    return out


def phase_families(seed: int, card: str) -> dict:
    """``lm.families``: the MoE, MLA, Mamba-2, hybrid, cross-attention and
    Whisper families (``repro_torch.models``; plain PyTorch, no kernel of
    the port) at full width in bf16 from a seeded random init, one model
    at a time, each freed before the next (its device peak recorded).

    1. deepseek-v2-lite-16b FULL (MoE + MLA): a ServeEngine of 8 slots ×
       4096 serving 8 requests, every output equal to a plain replay
       of the first ``FAMILY_REPLAY_TICKS`` ticks;
       f32 prefill/decode against forward at 4 layers, batch 1, T with
       cap(T) = cap(T + 1) (the first of T 1024, 512, ..., 16 where
       forward keeps its last token's slots), decode gated only if
       forward kept them; the share of dropped slots at B 4, T 4096 in bf16;
       layer 0's absorbed MLA decode against the decompressed path;
    2. mamba2-1.3b and 3. hymba-1.5b FULL: a ServeEngine of 4 slots
       serving 8 requests (slots re-admitted: the SSM state carries over,
       as the reference's), equal to the replay; prefill (B 4, T 4096) and
       decode against forward, f32 at 4 layers (gated), bf16 whole
       (recorded);
    4. whisper-large-v3 FULL: prefill (B 4, 1500 frames, 32 tokens) and 32
       greedy decode steps; f32 at 4 + 4 layers against the decoder's
       forward (gated);
    5. llama4-scout-17b-a16e at 4 layers: prefill (B 2, T 1024) and 16
       decode steps; f32 at 2 layers under the capacity rule;
    6. llama-3.2-vision-90b at 10 layers: prefill (B 2, T 256, a 6400 ×
       8192 context) and 16 decode steps; f32 at 5 layers: prefill gated,
       decode recorded and gated on missing forward (the reference's
       cross-cache fault, ROADMAP queue 3).
    """
    dev = resolve_device()
    t0 = time.perf_counter()
    _build.reset_launches()
    rows = []
    for name in FAMILIES:
        row = _family(name, seed, card, dev)
        row["launches"] = dict(_build.LAUNCHES)
        if any(row["launches"].values()):
            raise AssertionError(f"lm.families {name}: a kernel of the port "
                                 f"launched: {row['launches']}")
        log("lm.families", **row)
        rows.append(row)
    return {"models": rows, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

TRAIN = dict(arch="phi4_mini_3_8b", batch=2, seq=1024, steps=8, fresh=4,
             slice_layers=2, slice_seq=128, check_layers=4, variant_steps=2,
             restart_steps=10, fault_at=7, ckpt_every=5)
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
TRAIN_SLICE_RTOL = 1e-5        # the CPU slice's loss, relative
TRAIN_SLICE_GRAD_TOL = 1e-4    # its gradients, of the tree's largest
TRAIN_STATE_BYTES = 16         # f32 params, grads, m and v a parameter
# the depths tried, most first, if the FULL state does not fit
TRAIN_DEPTHS = (32, 28, 24, 16)


def _train_grads(model, params, batch):
    """(loss, gradients as a list in ``tree_leaves`` order) of one batch."""
    leaves = lm_params.tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    return loss.detach(), list(grads)


def _train_flops(cfg, tokens: int) -> float:
    """A step's matmul FLOP: every block weight 4 passes (forward, remat's
    recompute, the backward's two products), the head 3, causal attention
    (half the T × T scores and the PV product) 4 passes."""
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    per_layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * f
    attn = 2 * TRAIN["batch"] * h * TRAIN["seq"] ** 2 * hd   # causal half
    return (4 * (2 * tokens * per_layer + attn) * cfg.n_layers
            + 3 * 2 * tokens * d * cfg.vocab_size)


def _train_full(cfg, seed: int, dev) -> dict:
    """FULL training: ``TRAIN["steps"]`` steps on one fixed batch, then
    ``TRAIN["fresh"]`` on fresh batches; ms a step by CUDA events."""
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in lm_params.tree_leaves(state.params))
    out = {"n_layers": cfg.n_layers, "n_params": n,
           "init_s": time.perf_counter() - t0,
           "state_bytes": TRAIN_STATE_BYTES * n}
    step = make_train_step(model, TrainConfig(AdamWConfig(
        lr=1e-3, warmup_steps=10)))
    b, t = TRAIN["batch"], TRAIN["seq"]
    fixed = lm_batch(cfg, batch=b, seq=t, step=0, seed=seed, device=dev)
    out["state_nbytes"] = sum(x.numel() * x.element_size()
                              for x in ckpt_lib.tree_flatten(state))
    losses, gnorms, ms = [], [], []
    n_steps = TRAIN["steps"] + TRAIN["fresh"]
    for i in range(n_steps):
        batch = fixed if i < TRAIN["steps"] else lm_batch(
            cfg, batch=b, seq=t, step=i - TRAIN["steps"] + 1, seed=seed,
            device=dev)
        # the last step (a fresh batch, outside the median) under
        # FlopCounterMode: the count the dry run's fake pass is held to
        counter = (FlopCounterMode(display=False) if i == n_steps - 1
                   else contextlib.nullcontext())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with counter:
            state, met = step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train: a loss or grad norm is not finite: "
                             f"{losses} {gnorms}")
    fixed_losses = losses[:TRAIN["steps"]]
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"train: the loss did not fall on the fixed "
                             f"batch: {fixed_losses}")
    tokens = b * t
    step_ms = statistics.median(ms[1:TRAIN["steps"]])
    flops = _train_flops(cfg, tokens)
    opt_bytes = 28 * n          # read p, g, m, v; write p, m, v (f32)
    out.update({
        "losses": losses, "grad_norms": gnorms, "step_ms": ms,
        "ms_per_step": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
        "flops": flops, "flop_bound_ms": flops / BF16_OPS_PER_S * 1e3,
        "counted_flops": counter.get_total_flops(),
        "opt_bytes": opt_bytes,
        "opt_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3})
    out["bound_ms"] = out["flop_bound_ms"] + out["opt_bound_ms"]
    # the optimizer alone, on the trained state with zero gradients (its
    # time does not depend on the values)
    grads = lm_params.tree_map(torch.zeros_like, state.params)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    out["opt_ms"] = time_ms(lambda: adamw_update_(ocfg, state.params, grads,
                                                  state.opt), reps=3)
    del state, grads, step
    return out


def _train_slice(cfg, seed: int, dev) -> dict:
    """2 layers at full width in f32 (TF32 off), one loss and backward on
    the card and on the CPU from the card's init: the loss within
    ``TRAIN_SLICE_RTOL``, every gradient within ``TRAIN_SLICE_GRAD_TOL`` of
    the tree's largest. Then one AdamW step, plain and in place, from the
    same state and these gradients: params, m and v equal."""
    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN["slice_layers"],
                               dtype="float32")
    model = get_model(cfg2)
    params = init_params(model.schema, torch.Generator(device=dev)
                         .manual_seed(seed), device=dev)
    batch = lm_batch(cfg2, batch=1, seq=TRAIN["slice_seq"], step=0,
                     seed=seed, device=dev)
    t0 = time.perf_counter()
    loss, grads = _train_grads(model, params, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu_params = lm_params.tree_map(lambda x: x.cpu(), params)
    t0 = time.perf_counter()
    c_loss, c_grads = _train_grads(model, cpu_params, {
        k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    top = max(float(g.abs().max()) for g in c_grads)
    err = max(float((g.cpu() - c).abs().max())
              for g, c in zip(grads, c_grads))
    loss_rel = abs(float(loss) - float(c_loss)) / abs(float(c_loss))
    del cpu_params, c_grads
    out = {"layers": cfg2.n_layers, "seq": TRAIN["slice_seq"],
           "loss": float(loss), "cpu_loss": float(c_loss),
           "loss_rel": loss_rel, "grad_err": err, "grad_top": top,
           "card_s": card_s, "cpu_s": cpu_s}
    if loss_rel > TRAIN_SLICE_RTOL or err > TRAIN_SLICE_GRAD_TOL * top:
        raise AssertionError(f"train slice: card vs CPU {out}")
    # AdamW: the plain form first (it leaves its inputs), then in place
    g_tree = lm_params.tree_unflatten(params, grads)
    opt = init_opt_state(params)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    new_p, new_opt, met = adamw_update(ocfg, params, g_tree, opt)
    ip_met = adamw_update_(ocfg, params, g_tree, opt)
    equal = all(torch.equal(a, b) for x, y in (
        (new_p, params), (new_opt.m, opt.m), (new_opt.v, opt.v))
        for a, b in zip(lm_params.tree_leaves(x), lm_params.tree_leaves(y)))
    equal = equal and torch.equal(met["grad_norm"], ip_met["grad_norm"]) \
        and int(opt.step) == int(new_opt.step) == 1
    out["adamw_in_place_equal"] = equal
    if not equal:
        raise AssertionError("train: AdamW in place differs from plain")
    return out


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` (with the cuBLAS
    workspace setting it requires), the previous mode restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _train_remat(cfg, seed: int, dev) -> dict:
    """Remat on against off at 4 layers, full width, f32, one B 2 × T 1024
    batch: loss and gradients ``torch.equal`` (deterministic algorithms
    on); the largest difference with them off is recorded."""
    out = {"layers": TRAIN["check_layers"]}
    for det in (True, False):
        runs = []
        for on in (True, False):
            c = dataclasses.replace(cfg, n_layers=TRAIN["check_layers"],
                                    dtype="float32", remat=on)
            model = get_model(c)
            params = init_params(model.schema, torch.Generator(device=dev)
                                 .manual_seed(seed), device=dev)
            batch = lm_batch(c, batch=TRAIN["batch"], seq=TRAIN["seq"],
                             step=0, seed=seed, device=dev)
            torch.cuda.reset_peak_memory_stats()
            with deterministic() if det else contextlib.nullcontext():
                runs.append(_train_grads(model, params, batch))
            out[f"peak_bytes_remat_{'on' if on else 'off'}"] = \
                torch.cuda.max_memory_allocated()
            del params
        (l1, g1), (l2, g2) = runs
        diff = max(float((a - b).abs().max()) for a, b in zip(g1, g2))
        same = torch.equal(l1, l2) and all(
            torch.equal(a, b) for a, b in zip(g1, g2))
        key = "deterministic" if det else "default"
        out[key] = {"equal": same, "max_grad_diff": diff,
                    "loss_diff": float((l1 - l2).abs())}
        del runs, g1, g2
        if det and not same:
            raise AssertionError(f"train: remat on and off differ {out}")
    return out


def _train_variants(cfg, seed: int, dev) -> dict:
    """4 layers at full width (bf16 compute): ``TRAIN["variant_steps"]``
    steps of the plain step, of bf16 cast-through gradients and of 2
    micro-batches, each from the same init and batches; all finite."""
    c = dataclasses.replace(cfg, n_layers=TRAIN["check_layers"])
    model = get_model(c)
    out = {}
    for name, kw in (("plain", {}), ("bf16_grads", {"grad_dtype":
                                                    "bfloat16"}),
                     ("accum_2", {"accum_steps": 2})):
        state = init_train_state(model, torch.Generator(device=dev)
                                 .manual_seed(seed), device=dev)
        step = make_train_step(model, TrainConfig(AdamWConfig(
            lr=1e-3, warmup_steps=10), **kw))
        losses = []
        for s in range(TRAIN["variant_steps"]):
            batch = lm_batch(c, batch=TRAIN["batch"], seq=TRAIN["seq"],
                             step=s, seed=seed, device=dev)
            state, met = step(state, batch)
            losses += [float(met["loss"]), float(met["grad_norm"])]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train {name}: not finite: {losses}")
        out[name] = {"losses": losses[::2], "grad_norms": losses[1::2]}
        del state
    return out


def _train_restart(seed: int, dev) -> dict:
    """SMOKE width on the card: ``run_with_restart`` with a fault at step
    ``fault_at`` and a checkpoint every ``ckpt_every`` steps ends
    ``torch.equal`` to an uninterrupted run (deterministic algorithms on);
    then the trainer CLI in-process, 8 steps with a checkpoint every 3 and
    a resume to 12."""
    cfg = get_smoke_config(TRAIN["arch"])
    model = get_model(cfg)
    step = make_train_step(model, TrainConfig(AdamWConfig(
        lr=1e-3, warmup_steps=3)))

    def step_fn(state, s):
        return step(state, lm_batch(cfg, batch=2, seq=16, step=s, seed=seed,
                                    device=dev))

    def init():
        return init_train_state(model, torch.Generator(device=dev)
                                .manual_seed(seed), device=dev)
    out: dict = {}
    with deterministic(), tempfile.TemporaryDirectory() as tmp:
        ref = init()
        for s in range(TRAIN["restart_steps"]):
            ref, _ = step_fn(ref, s)
        crashed = []

        def injector(s):
            if s == TRAIN["fault_at"] and not crashed:
                crashed.append(s)
                raise RuntimeError("injected fault")
        like = init()
        cdir = os.path.join(tmp, "restart")
        final, n = run_with_restart(
            step_fn, init(), TRAIN["restart_steps"],
            save_fn=lambda st, s: ckpt_lib.save(cdir, s, st),
            restore_fn=lambda: (None, 0) if ckpt_lib.latest_step(cdir) is None
            else ckpt_lib.restore(cdir, like, device=dev),
            ckpt_every=TRAIN["ckpt_every"], fault_injector=injector)
        got = ckpt_lib.tree_flatten(final)
        want = ckpt_lib.tree_flatten(ref)
        out["restart_equal"] = bool(crashed) and n == TRAIN[
            "restart_steps"] and all(
            torch.equal(a, b) for a, b in zip(got, want))
        out["checkpoints"] = sorted(os.listdir(cdir))
        if not out["restart_equal"]:
            raise AssertionError(f"train: the restarted run differs {out}")
        ck = os.path.join(tmp, "cli")
        argv = ["--smoke", "--ckpt-dir", ck, "--device", dev.type]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            first = train_cli.main(argv + ["--steps", "8", "--ckpt-every",
                                           "3"])
            more = train_cli.main(argv + ["--steps", "12", "--resume"])
        text = buf.getvalue()
    out["cli"] = {"losses": first + more,
                  "resumed": "resumed from step 8" in text}
    if not out["cli"]["resumed"] or len(more) != 4:
        raise AssertionError(f"train CLI: no resume from step 8: {text}")
    return out


def phase_train(seed: int, card: str) -> dict:
    """``train.phi4_mini``: the training path (``repro_torch.train``,
    ``dist.checkpoint``/``fault_tolerance``, ``launch.train``; plain
    PyTorch and autograd, no kernel of the port).

    1. FULL: phi4-mini-3.8b at all 32 layers (fewer, with ``reduced``, if
       the state does not fit), f32 master weights from a seeded init,
       bf16 compute, remat on, ``AdamWConfig(lr=1e-3, warmup_steps=10)``;
       8 steps on one B 2 × T 1024 batch (the last loss below the first),
       4 on fresh batches; every loss and grad norm finite. ms a step
       (median of steps 2-8, CUDA events), tokens/s, the device peak
       beside the 16 B a parameter of state, the step's FLOP bound at the
       bf16 rate plus AdamW's byte bound (28 B a parameter), the
       optimizer's own ms;
    2. the CPU slice (2 layers, f32, B 1 × T 128), then AdamW in place
       against plain on its gradients;
    3. remat on against off (4 layers, f32);
    4. bf16 cast-through and 2 micro-batches (4 layers);
    5. crash-restart and the CLI's resume at SMOKE width;
    6. zero launches of the port's kernels.
    """
    dev = resolve_device()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held >= 1 << 30:
        raise AssertionError(f"train: {held} bytes still allocated at the "
                             f"phase's start")
    _build.reset_launches()
    t_phase = time.perf_counter()
    cfg = get_lm_config(TRAIN["arch"])
    out: dict = {"config": cfg.name, "dtype": cfg.dtype,
                 "param_dtype": cfg.param_dtype, "card": card,
                 "shape": dict(TRAIN), "held_bytes_at_start": held,
                 "reserved_bytes_at_start": torch.cuda.memory_reserved(),
                 "free_bytes_at_start": torch.cuda.mem_get_info()[0]}
    secs: dict = {}
    # the state fills the card: the allocator maps each segment's pages as
    # it grows, so that freed blocks of other sizes do not fragment it (the
    # FULL steps reserved up to 77.7 GiB of the card's 79.2 without it,
    # 75.9 with it, for a 69.4 GiB peak)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        failed = []
        for depth in TRAIN_DEPTHS:
            try:
                out["full"] = _train_full(dataclasses.replace(
                    cfg, n_layers=depth), seed, dev)
            except torch.cuda.OutOfMemoryError as e:
                failed.append(f"{depth} layers: {str(e)[:400]}")
            if "full" in out:
                break
            gc.collect()                    # the failed attempt's state
            torch.cuda.empty_cache()
            failed[-1] += (f" [{torch.cuda.memory_allocated()} bytes "
                           f"allocated after the cleanup]")
        else:
            raise AssertionError(f"train: no depth fits: {failed}")
        if failed:
            out["reduced"] = {"n_layers": out["full"]["n_layers"],
                              "reason": failed}
        gc.collect()
        torch.cuda.empty_cache()
        secs["full"] = time.perf_counter() - t_phase
        for name, fn in (("slice", _train_slice), ("remat", _train_remat),
                         ("variants", _train_variants)):
            out[name] = fn(cfg, seed, dev)
            gc.collect()
            torch.cuda.empty_cache()
            secs[name] = time.perf_counter() - t_phase - sum(secs.values())
        out["restart"] = _train_restart(seed, dev)
        secs["restart"] = time.perf_counter() - t_phase - sum(
            secs.values())
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
    out["launches"] = dict(_build.LAUNCHES)
    if any(out["launches"].values()):
        raise AssertionError(f"train: a kernel of the port launched: "
                             f"{out['launches']}")
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t_phase
    log("train.phi4_mini", **out)
    return out


# ---------------------------------------------------------------------------
# shard phase
# ---------------------------------------------------------------------------

SHARD = dict(steps=2, slice_layers=2, smoke_batch=2, smoke_seq=16)
SERVE_SHARD = dict(batch=8, prompt=512, max_seq=4096, ticks=64)
SERVE_SHARD_RTOL = 1e-3        # logits, of each step's largest
SHARD_LOSS_RTOL = 1e-4         # the reference SP test's own bounds: loss
SHARD_GNORM_RTOL = 1e-3        # and grad norm, relative
SHARD_SLICE_GRAD_TOL = 1e-5    # the slice's gradients, of the tree's largest


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL process group (its store a ``HashStore``: no
    address, no network) and its (1, 1) ("data", "model") ``DeviceMesh``,
    registered with SP (``sharding.enable(("data",), sp=True)``); the
    registry cleared and the group destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        shmod.enable(("data",), sp=True, mesh=mesh)
        yield mesh
    finally:
        shmod.disable()
        dist.destroy_process_group()


def device_busy(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (device activity only,
    no trace kept): its wall ms, the summed device time of its kernels and
    copies, and the idle share ``1 - busy / wall`` (the profiler's own
    host time included: an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall if busy else None}


def _grad_pspecs(model, mesh):
    return lm_params.tree_map(
        lambda s: normalize_pspec(s.pspec, mesh, s.shape), model.schema,
        lm_params.is_spec)


def _shard_steps(cfg, seed: int, dev, mesh) -> dict:
    """``SHARD["steps"]`` train steps from the train phase's seeded init on
    its fixed B 2 × T 1024 batch, then one under the profiler: through the
    sharded path (parameters placed on ``mesh``, ``grad_pspecs`` from the
    schema) or, with no mesh, the unsharded one. Losses, grad norms,
    CUDA-event and host ms a step, the profiled step's wall and device
    busy ms, the device peak."""
    model = get_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model.schema, torch.Generator(device=dev)
                         .manual_seed(seed), device=dev)
    gp = None
    if mesh is not None:
        # a one-rank mesh splits nothing: the DTensors hold these tensors
        params = lm_params.distribute(params, model.schema, mesh)
        gp = _grad_pspecs(model, mesh)
    state = TrainState(params, init_opt_state(params))
    del params
    step = make_train_step(model, TrainConfig(AdamWConfig(
        lr=1e-3, warmup_steps=10)), grad_pspecs=gp)
    batch = lm_batch(cfg, batch=TRAIN["batch"], seq=TRAIN["seq"], step=0,
                     seed=seed, device=dev)
    out: dict = {"n_layers": cfg.n_layers, "losses": [], "grad_norms": [],
                 "step_ms": [], "host_ms": []}
    for _ in range(SHARD["steps"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, met = step(state, batch)
        end.record()
        end.synchronize()
        out["host_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_ms"].append(start.elapsed_time(end))
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
    # one more step under the profiler: the device's busy time against the
    # step's wall time (the host's share: DTensor's dispatch)
    box: dict = {}

    def profiled():
        box["state"], box["met"] = step(state, batch)
    out["profiled_step"] = device_busy(profiled)
    state = box.pop("state")
    out["losses"].append(float(box["met"]["loss"]))
    out["grad_norms"].append(float(box["met"]["grad_norm"]))
    box.clear()
    if mesh is not None:
        leaves = lm_params.tree_leaves(state.params)
        out["dtensor_leaves"] = sum(shmod.is_dtensor(x) for x in leaves)
        out["n_leaves"] = len(leaves)
        out["moments_placed"] = all(
            tuple(m.placements) == tuple(p.placements)
            for p, m in zip(leaves, lm_params.tree_leaves(state.opt.m)))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    del state, step
    return out


def _shard_slice(cfg, seed: int, dev, mesh) -> dict:
    """2 layers at full width in f32 (TF32 off), one B 2 × T 1024 loss and
    backward unsharded and through the sharded path from the same
    parameters: gradients within ``SHARD_SLICE_GRAD_TOL`` of the tree's
    largest; a (1, 1) mesh should change no value, so the largest
    difference and ``torch.equal`` are recorded."""
    cfg2 = dataclasses.replace(cfg, n_layers=SHARD["slice_layers"],
                               dtype="float32")
    model = get_model(cfg2)
    params = init_params(model.schema, torch.Generator(device=dev)
                         .manual_seed(seed), device=dev)
    batch = lm_batch(cfg2, batch=TRAIN["batch"], seq=TRAIN["seq"], step=0,
                     seed=seed, device=dev)
    shmod.disable()
    try:
        loss, grads = _train_grads(model, params, batch)
    finally:
        shmod.enable(("data",), sp=True, mesh=mesh)
    dparams = lm_params.distribute(params, model.schema, mesh)
    d_loss, d_grads = _train_grads(model, dparams, batch)
    d_grads = [g.full_tensor() for g in d_grads]
    top = max(float(g.abs().max()) for g in grads)
    err = max(float((a - b).abs().max()) for a, b in zip(d_grads, grads))
    out = {"layers": cfg2.n_layers, "loss": float(loss),
           "sharded_loss": float(d_loss), "grad_err": err, "grad_top": top,
           "loss_equal": torch.equal(loss, d_loss),
           "grads_equal": all(torch.equal(a, b)
                              for a, b in zip(d_grads, grads))}
    if err > SHARD_SLICE_GRAD_TOL * top or not math.isfinite(err):
        raise AssertionError(f"shard slice: sharded vs unsharded {out}")
    return out


def _shard_checkpoint(seed: int, dev, mesh) -> dict:
    """SMOKE width: one sharded step, a save from the (1, 1) mesh, a
    restore onto it (``shardings=``) and onto no mesh, each leaf
    ``torch.equal`` to the saved state."""
    cfg = get_smoke_config(TRAIN["arch"])
    model = get_model(cfg)
    params = lm_params.distribute(init_params(
        model.schema, torch.Generator(device=dev).manual_seed(seed),
        device=dev), model.schema, mesh)
    state = TrainState(params, init_opt_state(params))
    step = make_train_step(model, TrainConfig(AdamWConfig(
        lr=1e-3, warmup_steps=3)), grad_pspecs=_grad_pspecs(model, mesh))
    state, _ = step(state, lm_batch(cfg, batch=SHARD["smoke_batch"],
                                    seq=SHARD["smoke_seq"], step=0,
                                    seed=seed, device=dev))
    lay = lm_params.shardings(model.schema, mesh)
    saved = [x.full_tensor() if shmod.is_dtensor(x) else x
             for x in ckpt_lib.tree_flatten(state)]
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_lib.save(tmp, 1, state)
        on_mesh, step_no = ckpt_lib.restore(
            tmp, state, shardings=TrainState(lay, OptState(lay, lay, None)),
            device=dev)
        plain, _ = ckpt_lib.restore(tmp, state, device=dev)
    got = ckpt_lib.tree_flatten(on_mesh)
    out["onto_mesh_equal"] = step_no == 1 and all(
        shmod.is_dtensor(a) == shmod.is_dtensor(b) and torch.equal(
            a.full_tensor() if shmod.is_dtensor(a) else a, s)
        for a, b, s in zip(got, ckpt_lib.tree_flatten(state), saved))
    out["onto_none_equal"] = all(
        not shmod.is_dtensor(a) and torch.equal(a, s)
        for a, s in zip(ckpt_lib.tree_flatten(plain), saved))
    if not (out["onto_mesh_equal"] and out["onto_none_equal"]):
        raise AssertionError(f"shard: checkpoint round trip {out}")
    return out


def _serve_ticks(model, params, cache, prompts) -> dict:
    """Prefill ``prompts`` into ``cache``, then ``SERVE_SHARD["ticks"]``
    greedy decode ticks: every step's logits (gathered), the tokens, ms a
    tick (CUDA events)."""
    def whole(t):
        return t.full_tensor() if shmod.is_dtensor(t) else t
    logits, cache = model.prefill(params, {"tokens": prompts}, cache)
    steps = [whole(logits)]
    tok = torch.argmax(steps[-1], -1, keepdim=True).to(torch.int32)
    toks, ms = [tok], []
    t0 = prompts.shape[1]
    for i in range(SERVE_SHARD["ticks"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = model.decode(params, cache, tok, t0 + i)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        steps.append(whole(logits))
        tok = torch.argmax(steps[-1], -1, keepdim=True).to(torch.int32)
        toks.append(tok)
    return {"logits": steps, "tokens": torch.cat(toks, 1), "ms": ms}


def _shard_serve(cfg, seed: int, dev, mesh, card: str) -> dict:
    """``shard.phi4_mini_serve``: phi4-mini FULL's prefill and decode
    through the sharded path on ``mesh`` and unsharded, from the same
    serving parameters (``launch.dryrun._serving_schema``: bf16) and
    prompts: ``SERVE_SHARD["batch"]`` prompts of ``SERVE_SHARD["prompt"]``
    tokens into a cache of ``SERVE_SHARD["max_seq"]``, then
    ``SERVE_SHARD["ticks"]`` greedy ticks. The greedy tokens must be equal
    and every step's logits within ``SERVE_SHARD_RTOL`` (of the largest);
    ms a tick both ways, the device peak of each."""
    model = get_model(cfg)
    sch = dryrun_lib._serving_schema(model)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(sch, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, t = SERVE_SHARD["batch"], SERVE_SHARD["prompt"]
    prompts = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                            device=dev, dtype=torch.int32)
    cache_sch = model.cache_schema(b, SERVE_SHARD["max_seq"])
    runs: dict = {}
    for name in ("sharded", "unsharded"):
        torch.cuda.reset_peak_memory_stats()
        cache = init_params(cache_sch, device=dev)
        if name == "sharded":
            runs[name] = _serve_ticks(
                model, lm_params.distribute(params, sch, mesh),
                lm_params.distribute(cache, cache_sch, mesh), prompts)
        else:
            shmod.disable()
            try:
                runs[name] = _serve_ticks(model, params, cache, prompts)
            finally:
                shmod.enable(("data",), sp=True, mesh=mesh)
        runs[name]["peak_bytes"] = torch.cuda.max_memory_allocated()
        del cache
    s, u = runs["sharded"], runs["unsharded"]
    rel = [float((a - w).abs().max() / w.abs().max())
           for a, w in zip(s["logits"], u["logits"])]
    out = {"n_layers": cfg.n_layers, "shape": dict(SERVE_SHARD),
           "tokens_equal": torch.equal(s["tokens"], u["tokens"]),
           "logits_rel_max": max(rel),
           "logits_bit_equal": all(torch.equal(a, w) for a, w in
                                   zip(s["logits"], u["logits"])),
           "ms_per_tick": {k: statistics.median(runs[k]["ms"][1:])
                           for k in runs},
           "peak_bytes": {k: runs[k]["peak_bytes"] for k in runs}}
    if not out["tokens_equal"] or not out["logits_rel_max"] <= \
            SERVE_SHARD_RTOL:
        raise AssertionError(f"shard serve: sharded vs unsharded {out}")
    out["launches"] = dict(_build.LAUNCHES)
    log("shard.phi4_mini_serve", card=card, **out)
    return out


def phase_shard(seed: int, card: str) -> dict:
    """``shard.phi4_mini``: the sharded train step (``repro_torch.dist.
    sharding`` on a ``DeviceMesh``: DTensor parameters, gradients and
    moments, the SP schedule's layout changes, ``grad_pspecs``; plain
    PyTorch and autograd, no kernel of the port) on a one-rank NCCL
    group's (1, 1) ("data", "model") mesh, SP on. Every path of the
    sharded step runs there but the expert-parallel MoE, which needs a
    "model" axis past 1 (the CPU tests hold it on a (2, 4) gloo mesh).

    1. FULL: phi4-mini-3.8b at 32 layers (fewer, with ``reduced``, if the
       state does not fit), the train phase's seed, config and fixed
       batch; ``SHARD["steps"]`` steps and a profiled one sharded, then as
       many unsharded at the same depth: losses within ``SHARD_LOSS_RTOL``
       and grad norms within ``SHARD_GNORM_RTOL`` (relative), ms a step
       (CUDA events and host), the profiled step's wall against its device
       busy time, and the device peak of each;
    2. a 2-layer f32 slice: sharded against unsharded gradients within
       ``SHARD_SLICE_GRAD_TOL`` of the tree's largest, the largest
       difference and ``torch.equal`` recorded;
    3. SMOKE width: a checkpoint saved from the mesh restores onto it and
       onto no mesh, ``torch.equal``;
    4. zero launches of the port's kernels.
    """
    dev = resolve_device()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held >= 1 << 30:
        raise AssertionError(f"shard: {held} bytes still allocated at the "
                             f"phase's start")
    _build.reset_launches()
    t_phase = time.perf_counter()
    cfg = get_lm_config(TRAIN["arch"])
    out: dict = {"config": cfg.name, "dtype": cfg.dtype, "card": card,
                 "mesh": {"shape": [1, 1], "names": ["data", "model"],
                          "backend": "nccl", "sp": True},
                 "shape": dict(SHARD, batch=TRAIN["batch"], seq=TRAIN["seq"]),
                 "held_bytes_at_start": held}
    secs: dict = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        with one_rank_mesh() as mesh:
            failed = []
            for depth in TRAIN_DEPTHS:
                try:
                    out["sharded"] = _shard_steps(dataclasses.replace(
                        cfg, n_layers=depth), seed, dev, mesh)
                except torch.cuda.OutOfMemoryError as e:
                    failed.append(f"{depth} layers: {str(e)[:400]}")
                if "sharded" in out:
                    break
                gc.collect()
                torch.cuda.empty_cache()
            else:
                raise AssertionError(f"shard: no depth fits: {failed}")
            depth = out["sharded"]["n_layers"]
            out["n_layers"] = depth
            if failed:
                out["reduced"] = {"n_layers": depth, "reason": failed}
            secs["sharded"] = time.perf_counter() - t_phase
            shmod.disable()
            try:
                out["unsharded"] = _shard_steps(dataclasses.replace(
                    cfg, n_layers=depth), seed, dev, None)
            finally:
                shmod.enable(("data",), sp=True, mesh=mesh)
            secs["unsharded"] = time.perf_counter() - t_phase - sum(
                secs.values())
            s, u = out["sharded"], out["unsharded"]
            out["loss_rel"] = [abs(a - b) / max(1.0, abs(b))
                               for a, b in zip(s["losses"], u["losses"])]
            out["grad_norm_rel"] = [abs(a - b) / max(1.0, abs(b)) for a, b
                                    in zip(s["grad_norms"], u["grad_norms"])]
            out["bit_equal_metrics"] = (s["losses"] == u["losses"] and
                                        s["grad_norms"] == u["grad_norms"])
            out["ms_per_step"] = {"sharded": s["step_ms"][-1],
                                  "unsharded": u["step_ms"][-1]}
            if max(out["loss_rel"]) > SHARD_LOSS_RTOL or max(
                    out["grad_norm_rel"]) > SHARD_GNORM_RTOL or not all(
                    math.isfinite(x) for x in s["losses"] + s["grad_norms"]):
                raise AssertionError(f"shard: sharded vs unsharded {out}")
            gc.collect()
            torch.cuda.empty_cache()
            out["slice"] = _shard_slice(cfg, seed, dev, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            secs["slice"] = time.perf_counter() - t_phase - sum(
                secs.values())
            out["checkpoint"] = _shard_checkpoint(seed, dev, mesh)
            secs["checkpoint"] = time.perf_counter() - t_phase - sum(
                secs.values())
            gc.collect()
            torch.cuda.empty_cache()
            out["serve"] = _shard_serve(cfg, seed, dev, mesh, card)
            secs["serve"] = time.perf_counter() - t_phase - sum(
                secs.values())
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
    out["launches"] = dict(_build.LAUNCHES)
    if any(out["launches"].values()):
        raise AssertionError(f"shard: a kernel of the port launched: "
                             f"{out['launches']}")
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t_phase
    log("shard.phi4_mini", **out)
    return out


# ---------------------------------------------------------------------------
# dry-run phase
# ---------------------------------------------------------------------------

# (arch, shape, mesh, --sp, the status each must have): the reference's
# dry-run test's four cells and phi4-mini's train_4k
DRYRUN_CELLS = [("hymba_1_5b", "long_500k", "multi", False, "ok"),
                ("mamba2_1_3b", "train_4k", "single", True, "ok"),
                ("phi4_mini_3_8b", "long_500k", "single", False, "skip"),
                ("juno_ann", "serve_q128", "single", False, "ok"),
                ("phi4_mini_3_8b", "train_4k", "single", False, "ok")]
DRYRUN_TIMEOUT = 600


def start_dryrun_cells(out_dir: str) -> list:
    """The dry-run CLI on each of ``DRYRUN_CELLS``, one subprocess a cell
    (each starts its own fake world of 256 or 512 ranks; ``--device
    cuda``), started here and read by :func:`phase_dryrun`: the fake
    passes are host work, and run while the card serves other phases."""
    d = os.path.join(out_dir, "dryrun")
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mesh, sp, want in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--mesh", mesh, "--device", "cuda",
               "--outdir", d, "--force"]
        if arch != "juno_ann":
            cmd += ["--shape", shape]
        if sp:
            cmd.append("--sp")
        log_path = os.path.join(d, f"{arch}_{shape}_{mesh}.log")
        with open(log_path, "w") as fh:
            procs.append({"cell": (arch, shape, mesh, sp, want),
                          "path": os.path.join(d, f"{arch}_{shape}_{mesh}"
                                               f".json"),
                          "log": log_path, "t0": time.perf_counter(),
                          "proc": subprocess.Popen(
                              cmd, cwd=REPO, env=env, stdout=fh,
                              stderr=subprocess.STDOUT)})
    return procs


def phase_dryrun(card: str, procs: list, train: dict) -> dict:
    """``dryrun``: (a) the dry-run CLI (``repro_torch.launch.dryrun``) over
    ``DRYRUN_CELLS`` on the fake world, each cell's status gated, one
    line a cell (the dominant roofline term, the compute, memory and
    collective seconds at the H100's data-sheet rates, counted over
    analytic FLOPs); (b) in process, the fake pass of the train phase's
    FULL step (B 2 × T 1024, no mesh, ``cuda``): its counted FLOPs equal
    to ``FlopCounterMode``'s count of a real step, its predicted state
    bytes to the real state's; MemTracker's peak beside the card's, the
    analytic compute bound beside the measured ms a step."""
    t_phase = time.perf_counter()
    out: dict = {"card": card, "cells": []}
    for p in procs:
        try:
            rc = p["proc"].wait(timeout=max(
                1.0, DRYRUN_TIMEOUT - (time.perf_counter() - p["t0"])))
        except subprocess.TimeoutExpired:
            p["proc"].kill()
            p["proc"].wait()
            raise AssertionError(f"dryrun: {p['cell']} ran past "
                                 f"{DRYRUN_TIMEOUT} s")
        arch, shape, mesh, sp, want = p["cell"]
        with open(p["log"]) as fh:
            tail = fh.read()[-2000:]
        if rc != 0 or not os.path.exists(p["path"]):
            raise AssertionError(f"dryrun: {p['cell']} exited {rc}: {tail}")
        with open(p["path"]) as fh:
            res = json.load(fh)
        row = {"arch": arch, "shape": shape, "mesh": mesh, "sp": sp,
               "status": res["status"],
               "s": time.perf_counter() - p["t0"]}
        if res["status"] != want:
            raise AssertionError(f"dryrun: {p['cell']} is "
                                 f"{res['status']}, want {want}: "
                                 f"{res.get('error', res.get('reason'))}")
        if res["status"] == "ok":
            r = res["roofline"]
            row.update({k: r[k] for k in ("dominant", "compute_s",
                                           "memory_s", "collective_s")})
            row["counted_over_analytic"] = res["counted_over_analytic"]
            row["link_bytes_per_chip"] = res["collectives"][
                "total_link_bytes_per_chip"]
            row["pass_s"] = res["pass_s"]
        log("dryrun.cell", card=card, **row)
        out["cells"].append(row)
    full = train["full"]
    cfg = dataclasses.replace(get_lm_config(TRAIN["arch"]),
                              n_layers=full["n_layers"])
    shape = ShapeSpec("card", "train", TRAIN["seq"], TRAIN["batch"])
    t0 = time.perf_counter()
    res = dryrun_lib.run_cell(cfg, shape, None, device="cuda")
    if res["status"] != "ok":
        raise AssertionError(f"dryrun: the FULL step's fake pass: "
                             f"{res.get('error')} {res.get('traceback')}")
    step = {"n_layers": cfg.n_layers, "fake_s": time.perf_counter() - t0,
            "counted_flops": res["counted_flops_per_chip"],
            "real_counted_flops": full["counted_flops"],
            "state_bytes": res["analytic_state_bytes_per_chip"],
            "real_state_bytes": full["state_nbytes"],
            "memtracker_peak_bytes": res["memory_analysis"][
                "memtracker_peak_bytes"],
            "real_peak_bytes": full["peak_bytes"],
            "analytic_flops": res["analytic_flops_per_chip"],
            "analytic_compute_ms": res["roofline"]["compute_s"] * 1e3,
            "analytic_memory_ms": res["roofline"]["memory_s"] * 1e3,
            "ms_per_step": full["ms_per_step"]}
    if step["counted_flops"] != step["real_counted_flops"] or \
            step["state_bytes"] != step["real_state_bytes"]:
        raise AssertionError(f"dryrun: the fake pass against the real "
                             f"step: {step}")
    out["full_step"] = step
    log("dryrun.full_step", card=card, **step)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# pipeline phase
# ---------------------------------------------------------------------------
N_STREAM = 10_000_000          # the DEEP10M subset's size
C_STREAM = 10_240              # its clusters: P = 3912, as at 1M
TRAIN_STREAM = 1_000_000       # its reservoir (max_train_points)
STREAM_CHUNK = 65_536          # rows a chunk of the streamed sources


class TimedSource:
    """A chunk source that records each pass: its start and end, the host
    seconds spent drawing chunks, and the device's peak allocation at the
    pass's end. ``watch(chunk)``, if given, sees every chunk of the first
    pass as it streams by (its seconds, ``watch_s``, are not the build's)."""

    def __init__(self, fn, watch=None):
        self.fn, self.watch, self.passes = fn, watch, []

    def __call__(self):
        rec = {"start": time.perf_counter(), "draw_s": 0.0, "watch_s": 0.0}
        watch = self.watch if not self.passes else None
        self.passes.append(rec)

        def it():
            chunks = iter(self.fn())
            while True:
                t0 = time.perf_counter()
                chunk = next(chunks, None)
                rec["draw_s"] += time.perf_counter() - t0
                if chunk is None:
                    break
                if watch is not None:
                    t0 = time.perf_counter()
                    watch(chunk)
                    rec["watch_s"] += time.perf_counter() - t0
                yield chunk
            rec["end"] = time.perf_counter()
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        return it()


def rechunk(fn, rows: int):
    """A chunk source of ``rows``-row chunks over another source."""
    def it():
        buf, have = [], 0
        for c in fn():
            buf.append(c)
            have += c.shape[0]
            while have >= rows:
                cat = np.concatenate(buf)
                yield cat[:rows]
                buf, have = [cat[rows:]], have - rows
        if have:
            yield np.concatenate(buf)
    return it


class StreamedTopk:
    """Exact l2 top-k ids of ``q`` over the rows fed to it in stream
    order, chunk by chunk on the card (each chunk's top-k, then a merge
    with the running best by a stable sort)."""

    def __init__(self, q: torch.Tensor, k: int):
        self.q, self.k, self.base = q, k, 0
        self.best_s = torch.full((q.shape[0], 0), float("-inf"),
                                 device=q.device)
        self.ids = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                               device=q.device)

    def __call__(self, chunk: np.ndarray) -> None:
        c = torch.from_numpy(chunk).to(self.q.device)
        s = -(torch.sum(c * c, dim=-1)[None] - 2.0 * (self.q @ c.T))
        v, i = torch.topk(s, min(self.k, c.shape[0]), dim=1)
        cat_s = torch.cat([self.best_s, v], dim=1)
        cat_i = torch.cat([self.ids, i + self.base], dim=1)
        srt, sel = torch.sort(cat_s, dim=1, descending=True, stable=True)
        self.best_s = srt[:, :self.k]
        self.ids = torch.gather(cat_i, 1, sel[:, :self.k])
        self.base += c.shape[0]


def _leaves(index) -> dict:
    out = {}
    for group in ("ivf", "codebook", "density"):
        obj = getattr(index, group)
        out.update({f"{group}.{f}": getattr(obj, f)
                    for f in type(obj)._fields})
    out.update({f: getattr(index, f)
                for f in ("codes", "cluster_codes", "points_sq")})
    return out


def host_copy_s(n_batches: int, row_bytes: int, dev) -> float:
    """Seconds of ``n_batches`` device→host copies of one eval batch's
    bytes (8192 rows × ``row_bytes``), each after a small kernel: what the
    streaming build's one copy a batch costs without the batch's work."""
    buf = torch.zeros((8192, row_bytes), dtype=torch.uint8, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        buf.add_(1)
        buf.cpu()
    return time.perf_counter() - t0


def phase_pipeline(cfg, index, pts: np.ndarray, queries: np.ndarray,
                   stream, seed: int) -> dict:
    """The streaming build on the card: (a) the l2 serve phase's points
    through ``array_source``, held to the in-memory index (probe counters,
    shapes, dtypes, recall of tiers H, M and L within 0.01); (b) 10M
    DEEP-like points streamed out of ``make_dataset``'s draws, never held
    whole: pass times, the device's peak over passes 1–2, serving through
    the fused and unfused engines, tier recall against a streamed exact
    top-100, the shard split/merge and the store round trip."""
    dev = index.ivf.centroids.device
    out = {"launches": {}}

    # (a) 1M: the serve phase's points and config, streamed
    n = pts.shape[0]
    probe = BuildProbe()
    _build.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    sidx = build_streaming(array_source(pts, STREAM_CHUNK), cfg, seed=seed,
                           probe=probe, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    out["launches"]["stream_1m"] = dict(_build.LAUNCHES)
    chunks = -(-n // STREAM_CHUNK)
    if (probe.passes not in (2, 3) or probe.chunks != probe.passes * chunks
            or probe.max_chunk_rows > STREAM_CHUNK
            or probe.train_rows != min(n, cfg.max_train_points)
            or probe.n_points != n):
        raise AssertionError(f"1M stream probe {vars(probe)}")
    for key, (a, b) in {k: (v, _leaves(index)[k])
                        for k, v in _leaves(sidx).items()}.items():
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"1M stream {key}: {a.shape} {a.dtype} vs "
                                 f"in-memory {b.shape} {b.dtype}")
    q = torch.from_numpy(queries).to(dev)
    _, gt = exact_topk(q, torch.from_numpy(pts).to(dev), k=10)
    recall = {}
    for tier in ("H", "M", "L"):
        kw = dict(TIERS[tier], k=100, metric="l2", batch=128)
        r = {tag: recall_n_at_k(search(ix, q, **kw)[1].long(), gt)
             for tag, ix in (("in_memory", index), ("streamed", sidx))}
        if r["streamed"] < r["in_memory"] - 0.01:
            raise AssertionError(f"1M stream tier {tier}: recall {r}")
        recall[tier] = r
    out["stream_1m"] = {"probe": vars(probe), "build_s": build_s,
                        "points_per_s": n / build_s,
                        "recall10_at_100": recall}
    del sidx
    torch.cuda.empty_cache()

    # (b) 10M, out of core
    cfg10 = JunoConfig(n_clusters=C_STREAM, n_entries=256, sub_dim=2,
                       metric="l2", max_train_points=TRAIN_STREAM)
    draws = point_chunks(DEEP_LIKE, N_STREAM, seed=seed)
    # the ground truth of 1024 of the l2 phase's queries (the same
    # mixture: its first draws), streamed over the build's first pass
    q = torch.from_numpy(queries[:1024]).to(dev)
    truth = StreamedTopk(q, 100)
    src = TimedSource(rechunk(draws, STREAM_CHUNK), watch=truth)
    probe = BuildProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    idx10 = build_streaming(src, cfg10, seed=seed, probe=probe, device=dev)
    _sync(dev)
    total_s = time.perf_counter() - t0
    out["launches"]["stream_10m"] = dict(_build.LAUNCHES)
    raw = N_STREAM * DEEP_LIKE.dim * 4
    peak12 = src.passes[1]["peak_bytes"]
    p = idx10.cluster_codes.shape[1]
    if (peak12 >= raw or probe.n_points != N_STREAM
            or probe.train_rows != TRAIN_STREAM
            or probe.max_chunk_rows > STREAM_CHUNK
            or p != cluster_capacity(N_STREAM, C_STREAM, cfg10.capacity_mult)):
        raise AssertionError(f"10M stream: peak {peak12} B of {raw}, probe "
                             f"{vars(probe)}, P {p}")
    passes = [{"s": r["end"] - r["start"] - r["watch_s"],
               "draw_s": r["draw_s"]} for r in src.passes]
    n_batches = -(-N_STREAM // 8192)
    build_s = total_s - src.passes[0]["watch_s"]
    ten = {"N": N_STREAM, "C": C_STREAM, "P": p, "probe": vars(probe),
           "passes": passes, "train_s": src.passes[1]["start"]
           - src.passes[0]["end"], "build_s": build_s,
           "points_per_s": N_STREAM / build_s,
           "device_peak_passes_1_2_bytes": peak12, "raw_points_bytes": raw,
           "device_peak_build_bytes": torch.cuda.max_memory_allocated(),
           "cluster_codes_bytes": idx10.cluster_codes.numel(),
           "eval_batches": n_batches,
           "host_copies_alone_s": host_copy_s(
               n_batches, 8 + idx10.codes.shape[1], dev)}
    if truth.base != N_STREAM:
        raise AssertionError(f"ground truth over {truth.base} rows")
    gt = truth.ids
    ten["ground_truth_s"] = src.passes[0]["watch_s"]

    # serving: the fused and unfused scan engines on the stream
    mut10 = MutableJunoIndex(idx10, side_capacity=SIDE)
    ten["engines"] = {}
    for label, fused in (("fused", True), ("unfused", False)):
        eng = AnnServeEngine(mut10, metric="l2", fused=fused)
        run_stream(eng, queries, stream)               # warm-up
        _build.reset_launches()
        reqs, t = run_stream(eng, queries, stream)
        launches = dict(_build.LAUNCHES)
        must = ENGINE_KERNELS[("scan", fused)]
        if any(launches[k] <= 0 for k in must) or \
                any(launches[k] != 0 for k in set(launches) - must):
            raise AssertionError(f"10M {label}: launches {launches}")
        for r in reqs:
            check_results(r.ids, r.scores, N_STREAM, f"10M request {r.rid}")
        times = [t] + [run_stream(eng, queries, stream)[1] for _ in range(2)]
        rows = eng.stats["queries"] // 4
        out["launches"][f"serve_10m_{label}"] = launches
        ten["engines"][label] = {"qps": rows / statistics.median(times),
                                 "qps_repeats": [rows / x for x in times],
                                 "rows": rows}
    ten["tiers"] = {}
    for tier in ("H", "H2_fused", "H2_composed", "M", "L"):
        kw = dict(TIERS[tier], k=100, metric="l2", batch=128)
        scores, ids = search(idx10, q, **kw)
        check_results(ids.cpu(), scores.cpu(), N_STREAM, f"10M {tier}")
        r = recall_n_at_k(ids.long(), gt[:, :10])
        if tier in ("H", "H2_fused", "H2_composed") and r < 0.2:
            raise AssertionError(f"10M {tier}: recall@10-in-100 {r:.4f}")
        ten["tiers"][tier] = {"recall10_at_100": r}
    del mut10
    torch.cuda.empty_cache()

    # the shard split and merge, bit for bit
    merged = merge_shards(split_shards(idx10, 4))
    bad = [k for k, v in _leaves(merged).items()
           if not torch.equal(v, _leaves(idx10)[k])]
    if bad:
        raise AssertionError(f"10M split/merge differs in {bad}")
    ten["shards_split_merge_equal"] = 4
    del merged
    torch.cuda.empty_cache()

    # the store round trip, served bit-equal through the fused engine
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="stream10m_",
                           dir=os.path.join(REPO, "build"))
    try:
        store = ArtifactStore(os.path.join(tmp, "store"))
        t0 = time.perf_counter()
        v = store.put("main", idx10, cfg10)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.verify("main", v)
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = store.get("main", v, device=dev, verify="manifest")
        get_s = time.perf_counter() - t0
        got, _ = run_stream(AnnServeEngine(loaded.data, metric="l2",
                                           fused=True), queries, stream)
        want, _ = run_stream(AnnServeEngine(idx10, metric="l2", fused=True),
                             queries, stream)
        same_requests(got, want, "10M stored vs in-memory")
        ten["store"] = {"bytes": _dir_bytes(store.path("main", v)),
                        "put_s": put_s, "verify_s": verify_s, "get_s": get_s,
                        "requests_bit_equal": len(got)}
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ten["rt_grid"] = "not built at 10M (ROADMAP.md)"
    out["stream_10m"] = ten
    del idx10
    torch.cuda.empty_cache()
    log("pipeline.l2", **out)
    return out


def phase_serve(name: str, spec, seed: int, n_points: int, card: str,
                out_dir: str, tuned: dict,
                hit_calls_dir: str | None = None) -> dict:
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
    t0 = time.perf_counter()
    grid = rt.build_grid(index, metric=spec.metric)   # as the engine would
    torch.cuda.synchronize()
    grid_info = {"build_s": time.perf_counter() - t0, "cells": grid.n_cells,
                 "cap": grid.capacity,
                 "radius_bias": float(grid.radius_bias),
                 "radius_scale": float(grid.radius_scale),
                 "probes_kept_at_scale_1": probe_survival(
                     index, grid, queries, spec.metric)}
    sphere_rows = [check_sphere_probe_on_grid(name, index, grid, queries,
                                              spec.metric, n_probe)
                   for n_probe in (16, 8)]
    sphere_rows.append(check_sphere_hits_on_grid(name, index, grid, queries,
                                                 spec.metric))
    for r in sphere_rows:
        log(f"kernel.sphere_hits.{name}", **r)

    stream = _requests(np.random.default_rng(seed), queries.shape[0])
    phase_s, t_phase = {}, time.perf_counter()

    def lap(key):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[key] = now - t_phase
        t_phase = now
    mut = MutableJunoIndex(index, side_capacity=SIDE)
    grid_info["router_s_per_pass"] = router_seconds(mut, grid, queries,
                                                    stream, spec.metric)
    log(f"grid.{name}", **grid_info)
    engines = {}
    # the unfused scan engine's calls (tiers M, L and composed H2; tier H),
    # tables kept, are replayed as hit_count and pq_scan rows below
    replay = engine_calls(tables=True)
    for label, fused, g in (("fused", True, None), ("unfused", False, None),
                            ("rt_fused", True, grid),
                            ("rt_unfused", False, grid)):
        engines[label] = serve_engine(
            mut, queries, stream, metric=spec.metric, fused=fused,
            n_points=n, rt_grid=g,
            trace_path=os.path.join(out_dir, f"trace_{name}_{label}.json"),
            records=replay if label == "unfused" else None)
        log(f"serve.{name}.{label}", **engines[label])
    hit_rows = check_hit_count_pass(name, replay["hit_calls"].calls)
    for r in hit_rows:
        log(f"kernel.hit_count.{name}", **r)
    pq_rows = check_pq_scan_pass(name, replay["pq_calls"].calls)
    for r in pq_rows:
        log(f"kernel.pq_scan.{name}", **r)
    if hit_calls_dir:
        os.makedirs(hit_calls_dir, exist_ok=True)
        for key, r in replay.items():
            save_calls(os.path.join(hit_calls_dir, f"{key}_{name}.pt"),
                       r.calls)
    del replay
    torch.cuda.empty_cache()
    lap("grid_and_engines")
    tuned_engines = autotune_engines(name, spec.metric, mut, grid, queries,
                                     stream, tuned)
    lap("autotune")

    cpu_index = index_to(index, "cpu")
    tiers = tier_table(index, cpu_index, queries, pts, spec.metric)
    log(f"tiers.{name}", **tiers)
    rt_tiers = tier_table(index, cpu_index, queries, pts, spec.metric, grid)
    log(f"tiers_rt.{name}", **rt_tiers)
    # rt beside scan from this call, for the record; no claim is attached
    log(f"rt_vs_scan.{name}",
        engine_qps={k: e["qps"] for k, e in engines.items()},
        tier_qps={t: {"scan": tiers[t]["qps"], "rt": rt_tiers[t]["qps"]}
                  for t in TIERS},
        tier_recall={t: {"scan": tiers[t]["recall10_at_100"],
                         "rt": rt_tiers[t]["recall10_at_100"]}
                     for t in TIERS})
    del cpu_index
    lap("tiers")
    mutate = phase_mutate(name, spec.metric, mut, grid, pts, queries, stream,
                          seed)
    lap("mutate")
    # the paged phase's artifact, served again by the fleet's paged replicas
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    store_root = tempfile.mkdtemp(prefix=f"paged_{name}_",
                                  dir=os.path.join(REPO, "build"))
    try:
        paged = phase_paged(name, spec.metric, cfg, index, grid, pts,
                            queries, stream, seed, store_root)
        lap("paged")
        obs = phase_obs(name, spec.metric, cfg, index, grid, pts, queries,
                        stream, tiers, out_dir)
        lap("obs")
        dist = phase_dist(name, spec.metric, index, grid, pts, queries,
                          stream, tiers, seed)
        lap("dist")
        fleet = phase_fleet(name, spec.metric, index, pts, queries, stream,
                            seed, store_root)
        lap("fleet")
    finally:
        shutil.rmtree(store_root, ignore_errors=True)
    pipeline = (phase_pipeline(cfg, index, pts, queries, stream, seed)
                if name == "l2" else None)
    lap("pipeline")
    log(f"seconds.{name}", data_s=t_data, build_s=t_build, **phase_s)
    out = {"name": name, "N": n, "D": spec.dim, "S": s, "E": 256, "P": p,
           "C_clusters": 1024, "data_s": t_data, "build_s": t_build,
           "grid": grid_info, "sphere_hits": sphere_rows,
           "hit_count_pass": hit_rows, "pq_scan_pass": pq_rows,
           "engines": engines, "tiers": tiers,
           "tiers_rt": rt_tiers, "mutate": mutate, "paged": paged,
           "obs": obs, "dist": dist, "fleet": fleet, "pipeline": pipeline,
           "autotune": tuned_engines, "phase_s": phase_s,
           "max_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "card": card}
    del index, mut, grid
    torch.cuda.empty_cache()
    return out


def kernel_line(kernels: dict, serves: list[dict], lm: dict) -> dict:
    line = []
    for name, rows in kernels.items():
        head = rows[0]
        src, replaces = SOURCES[name]
        counts = {key: lm["launches"][key]
                  + sum(e["launches"][key] for s in serves
                        for e in s["engines"].values())
                  + sum(s["mutate"]["launches"][key]
                        + s["paged"]["launches"][key] for s in serves)
                  + sum(ls[key] for s in serves
                        for ph in ("obs", "dist", "fleet", "pipeline",
                                   "autotune")
                        if s[ph] for ls in s[ph]["launches"].values())
                  for key in ENTRIES.get(name, (name,))}
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(counts.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "variants": rows})
        if name in ENTRIES:
            # each entry's launches beside its first row's numbers
            firsts = {r.get("entry", "sphere_hits"): r for r in reversed(rows)}
            line[-1]["entries"] = {
                key: {"launches": n, **{
                    k: firsts[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "launch_floor_ms")
                    if k in firsts[key]}}
                for key, n in counts.items()}
        if name in CALL_LAUNCHES:
            line[-1]["launches_are"] = CALL_LAUNCHES[name]
    return {"kernels": line}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "chip_smoke"),
                    help="directory for the report, ptxas output and traces")
    ap.add_argument("--hit-calls", metavar="DIR",
                    help="also write each index's replayed hit_count and "
                         "pq_scan calls to DIR/hit_calls_<index>.pt and "
                         "DIR/pq_calls_<index>.pt (about 1 and 2 GB at l2) "
                         "for bench_stage_a.py --hit-count/--pq-scan --calls")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    device = phase_device()
    phase_build(args.out)
    kernels = phase_kernels(args.seed)
    tune = phase_autotune(args.seed)
    serves = [phase_serve(name, spec, args.seed, N_POINTS, device["nvidia_smi"],
                          args.out, tune["tuned"], args.hit_calls)
              for name, spec in (("l2", DEEP_LIKE), ("ip", TTI_LIKE))]
    attn = phase_attention(args.seed, device["nvidia_smi"])
    lm = phase_lm(args.seed, device["nvidia_smi"])
    families = phase_families(args.seed, device["nvidia_smi"])
    cells = start_dryrun_cells(args.out)
    try:
        train = phase_train(args.seed, device["nvidia_smi"])
        shard = phase_shard(args.seed, device["nvidia_smi"])
        dry = phase_dryrun(device["nvidia_smi"], cells, train)
    finally:
        for c in cells:
            if c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
    # the probe entry on each index's own grid leads its rows (the l2 np 16
    # row heads the line): that is the main path's shape (cap is the
    # fullest cell's, known after the build); the dense entry on each grid
    # follows; the hit counts' engine-pass replays follow the synthetic rows
    kernels["kernels"]["sphere_hits"][:0] = sorted(
        (r for s in serves for r in s["sphere_hits"]),
        key=lambda r: r.get("entry") != "sphere_probe")
    kernels["kernels"]["hit_count"] += [r for s in serves
                                        for r in s["hit_count_pass"]]
    kernels["kernels"]["pq_scan"] += [r for s in serves
                                      for r in s["pq_scan_pass"]]
    line = kernel_line(kernels["kernels"], serves, lm)
    report = {"device": device, **kernels, "serve": serves,
              "autotune": {k: tune[k] for k in ("rows", "cache")},
              "attention": attn, "lm": lm, "lm_families": families,
              "train": train, "shard": shard, "dryrun": dry,
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
