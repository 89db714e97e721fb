"""Synthetic ANN datasets statistically matched to the paper's benchmarks.

Port of ``repro/data/synthetic.py``: the same anisotropic Gaussian
mixtures (power-law mode sizes for IVF imbalance, points concentrated near
their mode for PQ-entry locality), drawn from a numpy ``Generator(seed)``.
The distribution is the reference's; the draws are the port's own.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """One synthetic dataset family."""

    name: str
    dim: int
    metric: str          # "l2" | "ip"
    n_modes: int = 256   # latent mixture components
    anisotropy: float = 4.0
    power: float = 1.5   # mode-size power-law exponent


SIFT_LIKE = DatasetSpec("sift-like", 128, "l2")
DEEP_LIKE = DatasetSpec("deep-like", 96, "l2")
TTI_LIKE = DatasetSpec("tti-like", 200, "ip", n_modes=128)


_CHUNK = 1 << 17  # rows drawn at a time: host memory stays ~2x the output


def _mixture(spec: DatasetSpec, rng: np.random.Generator):
    """The mixture's modes, per-mode scales and mode weights (the first
    draws of a dataset)."""
    d, g = spec.dim, spec.n_modes
    mu = rng.standard_normal((g, d), dtype=np.float32) * 4.0
    scales = np.exp(rng.standard_normal((g, d), dtype=np.float32)
                    * np.float32(np.log(spec.anisotropy) / 2.0))
    w = np.arange(1, g + 1, dtype=np.float64) ** (-spec.power)
    return mu, scales, w / w.sum()


def _draw_chunks(rng, mixture, n: int, widen: float):
    """Yield the n rows of one draw, ``_CHUNK`` rows at a time."""
    mu, scales, w = mixture
    for lo in range(0, n, _CHUNK):
        m = min(_CHUNK, n - lo)
        mode = rng.choice(mu.shape[0], size=m, p=w)
        eps = rng.standard_normal((m, mu.shape[1]), dtype=np.float32)
        yield mu[mode] + eps * (scales[mode] * np.float32(widen))


def make_dataset(spec: DatasetSpec, n_points: int, n_queries: int, *,
                 seed: int = 42) -> tuple[np.ndarray, np.ndarray]:
    """Draw ``(points (N, D) f32, queries (Q, D) f32)`` from ``seed``."""
    rng = np.random.default_rng(seed)
    mixture = _mixture(spec, rng)

    def draw(n, widen):
        out = np.empty((n, spec.dim), np.float32)
        lo = 0
        for chunk in _draw_chunks(rng, mixture, n, widen):
            out[lo:lo + chunk.shape[0]] = chunk
            lo += chunk.shape[0]
        return out

    points = draw(n_points, 1.0)
    queries = draw(n_queries, 1.1)
    if spec.metric == "ip":  # normalise magnitude spread for MIPS realism
        stretch = 1.0 + 0.3 * rng.random((n_points, 1), dtype=np.float32)
        points /= np.maximum(np.linalg.norm(points, axis=-1, keepdims=True),
                             1e-6)
        points *= stretch
        queries /= np.maximum(np.linalg.norm(queries, axis=-1, keepdims=True),
                              1e-6)
    return points, queries


def point_chunks(spec: DatasetSpec, n_points: int, *, seed: int = 42):
    """The points of ``make_dataset(spec, n_points, ..., seed=seed)`` as a
    re-iterable chunk source (``build.pipeline``'s): a zero-arg callable
    whose every call replays the same draws, 131,072 rows a chunk, so the
    set is never held whole. Only for specs whose points need no pass over
    the whole set (the ip specs' magnitude stretch is drawn after the
    queries)."""
    if spec.metric != "l2":
        raise ValueError(f"{spec.name}: its points are drawn whole "
                         "(metric ip), not chunk by chunk")

    def it():
        rng = np.random.default_rng(seed)
        yield from _draw_chunks(rng, _mixture(spec, rng), n_points, 1.0)
    return it
