"""Incremental fold of minor delta generations into the base index, and
minor generations on disk.

Port of ``repro/build/merge.py``. :func:`fold_step` moves live points of
the oldest minor generations into free padded slots of their clusters, a
bounded number of clusters a call. :func:`commit_minor` writes a
generation through the store's temp-directory → fsync → rename commit,
with one sha256 a code row in its manifest; :func:`minor_codes_loader`
faults the codes back in on first touch, every row verified. The format
is the reference's: a minor written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .store import ArtifactError, ArtifactStore, _array_digest, _commit

MINOR_SCHEMA = 1
_MINOR_ARRAYS = "minor.npz"
_MINOR_MANIFEST = "manifest.json"


def fold_step(mid, *, max_clusters: int = 32,
              lane: tuple[int, int] | None = None) -> int:
    """Fold minor-generation points into free base slots of their clusters.

    Walks generations oldest first; for each, groups live positions by
    owning cluster and moves up to ``len(_free[c])`` of them into that
    cluster's freed padded slots, touching at most ``max_clusters``
    clusters in all. Plan, check the plan (a base slot listed twice raises
    ``RuntimeError`` with nothing mutated), write the device, then the
    host bookkeeping, as ``insert``/``compact``. Generations left with no
    live point are dropped. A disk-backed generation's codes are faulted
    in (verified) only when a fold takes points from it; on a read-only
    base (the paged tier keeps every free list empty) this does nothing.

    Parameters
    ----------
    mid : MutableIndexBase
        Tier-enabled mutable index.
    max_clusters : int
        Budget: clusters folded in this call.
    lane : (lo, hi), optional
        Fold only clusters in ``[lo, hi)`` (one shard's range).

    Returns
    -------
    int
        Number of points moved into the base.
    """
    budget = int(max_clusters)
    moved = 0
    for m in list(mid._minors):
        if budget <= 0:
            break
        pos_all = np.flatnonzero(m.valid)
        if lane is not None:
            lo, hi = lane
            pos_all = pos_all[(m.cluster[pos_all] >= lo)
                              & (m.cluster[pos_all] < hi)]
        if pos_all.size == 0:
            continue
        cl: list[int] = []
        sl: list[int] = []
        pos_l: list[int] = []
        plan: list[tuple[int, int]] = []
        for c in np.unique(m.cluster[pos_all]).tolist():
            if budget <= 0:
                break
            free = mid._free[c]
            if not free:
                continue
            ppos = pos_all[m.cluster[pos_all] == c][:len(free)]
            cl += [c] * len(ppos)
            sl += [int(s) for s in free[-len(ppos):][::-1]]
            pos_l += ppos.tolist()
            plan.append((c, len(ppos)))
            budget -= 1
        if not pos_l:
            continue
        if len(set(zip(cl, sl))) != len(sl):
            raise RuntimeError(
                "fold plan references a base slot twice (corrupted free "
                "list / double-free); refusing to fold")
        codes = m.materialize()          # verified fault-in when disk-backed
        pos_t = torch.as_tensor(pos_l, device=codes.device)
        mid._apply_insert(cl, sl, m.ids[pos_l].astype(np.int32),
                          codes[pos_t])
        for c, take in plan:
            del mid._free[c][-take:]
        for c, slot, pos in zip(cl, sl, pos_l):
            mid._loc[int(m.ids[pos])] = (c, slot)
        m.valid[np.asarray(pos_l)] = False
        moved += len(pos_l)
    if moved:
        mid._minors = [m for m in mid._minors if m.live]
        mid._delta_epoch += 1
    return moved


def save_minor(path: str, codes: np.ndarray, cluster: np.ndarray,
               ids: np.ndarray, valid: np.ndarray, *, gen: int) -> dict:
    """Write one minor generation (``minor.npz`` + ``manifest.json``) into
    ``path``: whole-array digests and one sha256 a code row. Returns the
    manifest."""
    os.makedirs(path, exist_ok=True)
    arrays = {"codes": np.ascontiguousarray(codes, np.uint8),
              "cluster": np.ascontiguousarray(cluster, np.int32),
              "ids": np.ascontiguousarray(ids, np.int32),
              "valid": np.ascontiguousarray(valid, bool)}
    manifest = {
        "minor_schema": MINOR_SCHEMA,
        "gen": int(gen),
        "capacity": int(arrays["ids"].shape[0]),
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "sha256": _array_digest(v)}
                   for k, v in arrays.items()},
        "sha256_rows": [_array_digest(row) for row in arrays["codes"]],
    }
    np.savez(os.path.join(path, _MINOR_ARRAYS), **arrays)
    with open(os.path.join(path, _MINOR_MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    return manifest


def commit_minor(store: ArtifactStore, name: str, codes: np.ndarray,
                 cluster: np.ndarray, ids: np.ndarray, valid: np.ndarray,
                 *, gen: int, max_attempts: int = 32) -> str:
    """Commit a minor generation as the next generation of ``name`` in
    ``store``, as :meth:`ArtifactStore.put` commits an index (temp
    directory, fsync, rename with retry). A failure leaves no committed
    generation behind. Returns the committed directory."""
    return _commit(store.root, name,
                   lambda tmp: save_minor(tmp, codes, cluster, ids, valid,
                                          gen=gen),
                   lambda: store.latest(name), lambda v: store.path(name, v),
                   max_attempts)


def load_minor(path: str, *, verify_rows: bool = True):
    """Read a minor generation, fail-closed.

    Raises :class:`ArtifactError` on a missing or foreign manifest, an
    array set that differs from it, or (with ``verify_rows``) a code row
    whose sha256 differs from the manifest's.

    Returns
    -------
    tuple
        ``(codes, cluster, ids, valid, manifest)``, numpy arrays.
    """
    mpath = os.path.join(path, _MINOR_MANIFEST)
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError(f"unreadable minor manifest {mpath!r}: {e}")
    if manifest.get("minor_schema") != MINOR_SCHEMA:
        raise ArtifactError(f"{mpath!r} is not a minor generation "
                            f"(minor_schema="
                            f"{manifest.get('minor_schema')!r})")
    with np.load(os.path.join(path, _MINOR_ARRAYS)) as z:
        if set(z.files) != set(manifest["arrays"]):
            raise ArtifactError(f"minor array set mismatch in {path!r}: "
                                f"{sorted(z.files)} vs "
                                f"{sorted(manifest['arrays'])}")
        codes, cluster, ids, valid = (z[k] for k in
                                      ("codes", "cluster", "ids", "valid"))
    if verify_rows:
        rows = manifest.get("sha256_rows")
        if rows is None or len(rows) != codes.shape[0]:
            raise ArtifactError(
                f"minor manifest {mpath!r} lacks per-row digests")
        for i, row in enumerate(codes):
            if _array_digest(row) != rows[i]:
                raise ArtifactError(f"sha256 mismatch on minor code row {i} "
                                    f"in {path!r}: artifact corrupt")
    return codes, cluster, ids, valid, manifest


def minor_codes_loader(path: str, device=None
                       ) -> Callable[[], torch.Tensor]:
    """First-touch fault-in of a disk-backed minor generation: a thunk that
    reads its codes, verifies every row (``ArtifactError`` on corruption)
    and returns them as a (B, S) uint8 tensor on ``device`` (``None`` =
    ``cuda``)."""
    dev = resolve_device(device)

    def load() -> torch.Tensor:
        codes = load_minor(path, verify_rows=True)[0]
        return torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    return load
