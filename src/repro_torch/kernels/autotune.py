"""Measured autotune pass for the two fused scans.

Port of ``repro/kernels/autotune.py``. Both kernels it tunes,
``fused_two_stage`` and ``fused_three_stage``, run on one CUDA core
(``csrc/two_stage.cuh``) whose launch shape is a choice made at run time
from a small lattice: the count kernel's threads and the points a thread
holds the valid flags of (``COUNT_SHAPES``, a 4096-point chunk each) and
the select kernel's threads (``SELECT_THREADS``). Every shape gives the
same bits. The CPU's plain versions have no knob: the reference's
``topc_impl``, a second θ-selection for its host dispatch, is not ported,
so on the CPU the one candidate is the default. This module picks among
the launch shapes by measurement:

* ``tune(kernel)`` times each candidate :class:`KernelConfig` on a
  synthetic problem (one warm-up call, then the median of ``repeats``
  calls: CUDA events on the card, ``perf_counter`` on the CPU) and
  returns the winner. Candidates are deduplicated down to the knobs that
  are *effective* on the backend (on CUDA the three launch knobs, on the
  CPU none), and ties go to the earlier candidate in the canonical order,
  so repeated tuning under timing jitter cannot oscillate between
  equivalent configs. A candidate that fails to launch raises; none is
  skipped.
* ``save_cache``/``load_cache`` persist winners as JSON keyed by the
  schema, the backend (``"cpu"`` or ``"cuda:" + the card's name``) and
  the tag of the two kernels' libraries (``_build._target``'s source
  hash). Loading FAILS CLOSED: a corrupt file, a schema bump, another
  backend's or another build's cache, or out-of-domain field values all
  return ``None`` (the caller retunes): a stale cache is never applied.
* ``set_config``/``active_config`` hold the process-global active
  configs that ``kernels.ops``' two fused dispatchers read on every call.
  The port traces nothing, so a config takes effect at the next call;
  no config is part of an engine's dispatch key, so installing one
  never widens an engine's signature lattice.

Every knob is result-invariant: a wrong cache entry could only ever cost
speed, and the fail-closed load refuses even that.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .fused_three_stage import fused_three_stage, fused_three_stage_plain
from .fused_two_stage import fused_two_stage, fused_two_stage_plain

SCHEMA_VERSION = 1

#: kernels this pass knows how to tune (and the ops dispatchers consult)
KERNELS = ("fused_two_stage", "fused_three_stage")

# canonical candidate axes, the default first: the enumeration order is the
# deterministic tie-break order, so keep these stable across releases. The
# lattice holds the shapes that won a measured row on the H100 (PERF.md).
#: (threads, points a thread) of the count kernel: a 4096-point chunk each
COUNT_SHAPES = ((256, 16), (512, 8))
#: threads of the select kernel
SELECT_THREADS = (256, 128, 512)


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point in the tuning space; defaults reproduce the untuned path.

    ``count_threads``/``count_per_thread``/``select_threads`` steer the CUDA
    kernels' launch shape: all three are result-invariant by construction.
    """

    count_threads: int = 256
    count_per_thread: int = 16
    select_threads: int = 256

    def validate(self) -> bool:
        """True iff every field is in the domain the kernels accept."""
        return (_is_int(self.count_threads) and _is_int(self.count_per_thread)
                and (self.count_threads, self.count_per_thread) in COUNT_SHAPES
                and _is_int(self.select_threads)
                and self.select_threads in SELECT_THREADS)

    def launch(self) -> dict:
        """The CUDA kernels' launch-shape keyword arguments."""
        return dict(count_threads=self.count_threads,
                    count_per_thread=self.count_per_thread,
                    select_threads=self.select_threads)


_active: dict[str, KernelConfig] = {}


def active_config(kernel: str) -> KernelConfig:
    """Config the ops dispatchers apply for ``kernel`` (default if unset)."""
    return _active.get(kernel, KernelConfig())


def set_config(kernel: str, config: KernelConfig) -> None:
    """Install ``config`` as the process-global active config for ``kernel``.

    Takes effect at the next dispatch (see module docstring).
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")
    if not config.validate():
        raise ValueError(f"invalid config for {kernel!r}: {config}")
    _active[kernel] = config


def reset() -> None:
    """Drop all active configs (every kernel back to defaults)."""
    _active.clear()


def backend_name(device=None) -> str:
    """The backend string cache entries are keyed on: ``"cpu"``, or
    ``"cuda:"`` and the card's name for ``resolve_device(device)``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(dev)
    return "cpu"


def kernels_tag() -> str:
    """The two kernels' library names, which carry their sources' hash: a
    cache tuned against another build is stale."""
    return ",".join(_build._target(k).stem for k in KERNELS)


def _effective_key(config: KernelConfig, backend: str):
    """The knob subset that can reach the dispatched path on ``backend``."""
    if backend.startswith("cuda"):
        return (config.count_threads, config.count_per_thread,
                config.select_threads)
    return ()


def candidates(backend: str | None = None) -> list[KernelConfig]:
    """Canonically-ordered candidate configs, deduplicated per backend.

    Two configs differing only in knobs the ``backend`` cannot exercise
    would measure identically; only the first (canonical order) survives.
    The default config is always the first.
    """
    backend = backend or backend_name()
    out, seen = [], set()
    for (ct, cp), st in itertools.product(COUNT_SHAPES, SELECT_THREADS):
        cfg = KernelConfig(count_threads=ct, count_per_thread=cp,
                           select_threads=st)
        key = _effective_key(cfg, backend)
        if key not in seen:
            seen.add(key)
            out.append(cfg)
    return out


def _index_problem(lut, table, codes, valid, cap_c: int):
    """Per-probe (Q, np, P, S) codes and (Q, np, P) valid as an index of
    Q·np clusters, each probed once: ``codes[cids]`` gives them back."""
    q, n_probe, p, s = codes.shape
    cids = torch.arange(q * n_probe, device=codes.device).reshape(q, n_probe)
    return (lut, table, codes.reshape(q * n_probe, p, s),
            valid.reshape(q * n_probe, p), cids, cap_c)


def _two_stage_problem(seed: int = 0):
    """The reference's small synthetic tuning workload (its draws), as
    ``(lut, table, codes, valid, cids, cap_c)`` on the CPU."""
    rng = np.random.default_rng(seed)
    q, n_probe, p, s, e = 8, 4, 64, 8, 16
    lut = torch.from_numpy(rng.normal(size=(q, n_probe, s, e)).astype(np.float32))
    table = torch.from_numpy(
        rng.integers(-1, 2, size=(q, n_probe, s, e)).astype(np.int8))
    codes = torch.from_numpy(
        rng.integers(0, e, size=(q, n_probe, p, s)).astype(np.uint8))
    valid = torch.from_numpy(rng.random(size=(q, n_probe, p)) < 0.9)
    return _index_problem(lut, table, codes, valid, 32)


def _three_stage_problem(seed: int = 0):
    """The two-stage workload plus the reference's tiny synthetic grid:
    ``(..., cids, q0, q1, radius, c0, c1, reach, slot_idx, cap_c)``."""
    *two, cap_c = _two_stage_problem(seed)
    rng = np.random.default_rng(seed + 1)
    q, n_probe = two[4].shape
    n_cells, cap = 9, 8
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    q0, q1 = f32(rng.normal(size=(q,))), f32(rng.normal(size=(q,)))
    radius = f32(rng.random(size=(q,)))
    rng.normal(size=(4, n_cells))               # the reference's cell boxes
    c0, c1 = (f32(rng.normal(size=(n_cells, cap))) for _ in range(2))
    reach = f32(np.abs(rng.normal(size=(n_cells, cap))))
    slot_idx = torch.from_numpy(
        rng.integers(0, n_cells * cap, size=(q, n_probe)).astype(np.int32))
    return (*two, q0, q1, radius, c0, c1, reach, slot_idx, cap_c)


def synthetic_problem(kernel: str, *, q: int = 128, p: int = 1024,
                      s: int = 48, signed: bool = False, device=None,
                      seed: int = 0):
    """A tuning workload at the engines' np 16, E 256 and C 320 with ``q``
    queries, made on ``device`` from a seeded ``torch.Generator``: an
    index of 1024 clusters of ``p`` slots whose valid slots sit at the
    front (an eighth to a half of each, as a built index lays them out),
    16 distinct clusters a query, a non-negative (l2) or ``signed`` (ip)
    LUT over ``s`` subspaces and a {-1, 0, +1} table; for
    ``fused_three_stage`` also a grid of 256 cells of 8 slots whose
    verdicts keep about half the probes. The defaults are the engines'
    batch and ``tune``'s problem on the card."""
    n_probe, e, cap_c, n_clusters = 16, 256, 320, 1024
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.rand((q, n_probe, s, e), generator=gen, device=dev)
    lut = (lut - 0.5) * 4.0 if signed else lut * 4.0
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=gen,
                          device=dev, dtype=torch.int8)
    codes = torch.randint(0, e, (n_clusters, p, s), generator=gen,
                          device=dev, dtype=torch.uint8)
    fill = torch.randint(p // 8, p // 2 + 1, (n_clusters, 1), generator=gen,
                         device=dev)
    valid = torch.arange(p, device=dev)[None, :] < fill
    cids = torch.argsort(torch.rand((q, n_clusters), generator=gen,
                                    device=dev), dim=1)[:, :n_probe]
    out = (lut, table, codes, valid, cids.contiguous())
    if kernel == "fused_two_stage":
        return (*out, cap_c)
    if kernel != "fused_three_stage":
        raise ValueError(f"unknown kernel {kernel!r}")
    n_cells, cap = 256, 8
    q0, q1 = (torch.randn((q,), generator=gen, device=dev) for _ in range(2))
    c0, c1 = (torch.randn((n_cells, cap), generator=gen, device=dev)
              for _ in range(2))
    reach = torch.rand((n_cells, cap), generator=gen, device=dev)
    radius = torch.full((q,), 1.0, device=dev)
    slot_idx = torch.randint(0, n_cells * cap, (q, n_probe), generator=gen,
                             device=dev, dtype=torch.int32)
    return (*out, q0, q1, radius, c0, c1, reach, slot_idx, cap_c)


def run_fn(kernel: str, config: KernelConfig, problem, *,
           metric: str = "l2"):
    """A zero-arg callable running ``kernel`` on ``problem`` with
    ``config`` applied: the CUDA kernel at its launch shape for CUDA
    tensors, the plain version for CPU tensors (over codes gathered per
    probe once, outside the callable)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    lut, table, codes, valid, cids, *rest = problem
    *sph, cap_c = rest
    kw = dict(cap_c=cap_c, metric=metric)
    if lut.device.type == "cuda":
        fn = fused_two_stage if kernel == "fused_two_stage" else \
            fused_three_stage
        return lambda: fn(lut, table, codes, valid, cids, *sph, **kw,
                          **config.launch())
    fn = fused_two_stage_plain if kernel == "fused_two_stage" else \
        fused_three_stage_plain
    g_codes, g_valid = codes[cids], valid[cids]
    return lambda: fn(lut, table, g_codes, g_valid, *sph, **kw)


def _median_ms(fn, repeats: int, on_cuda: bool) -> float:
    """One warm-up call, then the median of ``repeats`` timed calls: CUDA
    events on the card, the host clock on the CPU. On the card the stream
    sleeps ~1 ms before each call, so the whole call is enqueued before its
    start event fires: the events bracket device time, not the wrapper's
    host overhead, which no launch shape changes."""
    fn()
    times = []
    for _ in range(max(1, repeats)):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(kernel: str, *, repeats: int = 5, problem=None, device=None,
            metric: str = "l2") -> list[tuple[KernelConfig, float]]:
    """Every effective candidate for ``kernel`` with its median ms, in
    canonical order. ``problem`` defaults to :func:`synthetic_problem` on
    the card and the reference's small problem on the CPU; the backend is
    the problem's device's."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")
    if problem is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            problem = synthetic_problem(kernel, device=dev)
        else:
            problem = (_two_stage_problem() if kernel == "fused_two_stage"
                       else _three_stage_problem())
    dev = problem[0].device
    on_cuda = dev.type == "cuda"
    out = []
    for cfg in candidates(backend_name(dev)):
        fn = run_fn(kernel, cfg, problem, metric=metric)
        out.append((cfg, _median_ms(fn, repeats, on_cuda)))
    return out


def winner(timed: list[tuple[KernelConfig, float]]) -> KernelConfig:
    """The fastest of :func:`measure`'s candidates; ties go to the earlier
    (canonical) one."""
    return min(enumerate(timed), key=lambda it: (it[1][1], it[0]))[1][0]


def tune(kernel: str, *, repeats: int = 5, problem=None, device=None
         ) -> KernelConfig:
    """Measure every effective candidate for ``kernel``; return the winner.

    One warm-up call per candidate, then ``repeats`` timed runs; the score
    is the median. Winner = min (median, canonical index): the index
    tie-break keeps re-tuning deterministic when two configs measure
    identically. A candidate that fails to launch raises.
    """
    return winner(measure(kernel, repeats=repeats, problem=problem,
                          device=device))


def default_cache_path() -> Path:
    """Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` or a per-user
    default."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


def save_cache(configs: dict[str, KernelConfig], path: Path | str,
               *, backend: str | None = None,
               kernels: str | None = None) -> None:
    """Write ``configs`` as the JSON cache for ``backend`` and the kernels'
    tag ``kernels`` (default :func:`kernels_tag`): deterministic
    serialization, parents created."""
    for kernel, cfg in configs.items():
        if kernel not in KERNELS or not cfg.validate():
            raise ValueError(f"refusing to cache invalid entry "
                             f"{kernel!r}: {cfg}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {
        "schema": SCHEMA_VERSION,
        "backend": backend or backend_name(),
        "kernels": kernels or kernels_tag(),
        "configs": {k: dataclasses.asdict(v)
                    for k, v in sorted(configs.items())},
    }
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def load_cache(path: Path | str, *, backend: str | None = None,
               kernels: str | None = None
               ) -> dict[str, KernelConfig] | None:
    """Load a cache written by :func:`save_cache`, FAILING CLOSED.

    Returns the config dict only when the file parses, the schema version,
    the backend and the kernels' tag match, every kernel name is known and
    every field validates. Anything else gives ``None`` (the caller
    retunes): a stale or foreign cache is never applied.
    """
    path = Path(path)
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    if doc.get("schema") != SCHEMA_VERSION:
        return None
    if doc.get("backend") != (backend or backend_name()):
        return None
    if doc.get("kernels") != (kernels or kernels_tag()):
        return None
    raw = doc.get("configs")
    if not isinstance(raw, dict):
        return None
    out = {}
    names = {f.name for f in dataclasses.fields(KernelConfig)}
    for kernel, fields in raw.items():
        if kernel not in KERNELS or not isinstance(fields, dict):
            return None
        if set(fields) != names:
            return None
        cfg = KernelConfig(**fields)
        if not cfg.validate():
            return None
        out[kernel] = cfg
    return out


def ensure_tuned(path: Path | str | None = None, *, repeats: int = 3,
                 kernels: tuple[str, ...] = KERNELS,
                 device=None) -> dict[str, KernelConfig]:
    """Load cached winners (or tune and cache them) and install them.

    The one-call orchestrator: a cache hit installs with no measurement; a
    miss (absent, corrupt, stale or foreign: :func:`load_cache` fails
    closed) retunes every requested kernel on ``device``, saves and
    installs. Configs take effect at the next dispatch.
    """
    path = Path(path) if path is not None else default_cache_path()
    backend = backend_name(device)
    configs = load_cache(path, backend=backend)
    if configs is None or any(k not in configs for k in kernels):
        configs = {k: tune(k, repeats=repeats, device=device)
                   for k in kernels}
        save_cache(configs, path, backend=backend)
    for kernel in kernels:
        set_config(kernel, configs[kernel])
    return dict(configs)
