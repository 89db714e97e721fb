"""JUNO on PyTorch and CUDA for NVIDIA Hopper — the port of ``repro``.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``build/``, ``serve/``, ``data/``) so each counterpart is easy to find,
and imports nothing of ``repro`` or JAX: it keeps its own copies of what
it needs. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.

Ported so far: the online query path of tiers H, M, L and H2 — stage A
(the IVF filter), τ from the density model, stage B (the selective LUT
and the int8 hit table) and stage C (the masked-ADC scan of tier H, the
hit count of tiers M/L and composed H2, the fused two-stage scan of fused
H2), each stage A/B/C step a hand-written CUDA kernel; the RT prefilter
(``rt/``: the centroid grid, the ``sphere_hits`` kernel, the
``fused_three_stage`` kernel for fused H2 and the engine's probe-budget
routing); the mutable index (side buffer, insert/delete/compact, the LSM
freshness tiers, the online rebuild and hot swap); the offline build and
the streaming (out-of-core) build (``build/pipeline.py``), the artifact
store, the serving engine in both its configurations (``fused=False``
and ``fused=True``) with its mutation plane, the paged tier,
observability (``obs/``: metrics, spans, JSONL export, the online recall
probe), the cluster-sharded index (``dist/``: one ``torch.device`` a
shard, searched in one process and merged exactly) and the replica fleet
(``serve/fleet.py``: routing, admission, failover, fan-out writes,
sharded and paged replicas). On the LM side: JUNO-attention
(``models/juno_attention.py``), the dense decoder-only serving path
(``models/``: config, params, layers, transformer, api; ``serve/engine.py``,
the continuous-batching decode engine; ``configs/``; ``data/tokens.py``),
the MoE, MLA, Mamba-2, hybrid, cross-attention (VLM) and Whisper
encoder-decoder families (``models/{moe,mla,mamba2,whisper}.py``, all ten
architectures' configs), and training (``train/``: AdamW and the train
step, gradients by autograd with remat; ``dist/``: checkpoints in the
reference's layout, the step watchdog and crash-restart loop, gradient
compression; ``launch/train.py``, the trainer CLI). See ROADMAP.md for
what is still to come.
"""
from .device import resolve_device  # noqa: F401
