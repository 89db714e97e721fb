"""Product quantization: codebook training, encoding and decoding.

Port of ``repro/core/pq.py`` (``decode`` included: the RT grid build
measures cluster reach from the codes). The D-dim residual space is split
into S = D/M subspaces of M = 2 dims (the JUNO setup); the S codebooks
train as one batched k-means instead of a ``vmap``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kmeans import assign, kmeans


class PQCodebook(NamedTuple):
    """Per-subspace codebook entries and their squared norms."""

    entries: torch.Tensor   # (S, E, M) f32
    entry_sq: torch.Tensor  # (S, E)    f32 — |e|^2

    @property
    def n_subspaces(self) -> int:
        """Number of subspaces S."""
        return self.entries.shape[0]

    @property
    def n_entries(self) -> int:
        """Entries per subspace E."""
        return self.entries.shape[1]

    @property
    def sub_dim(self) -> int:
        """Subspace dimension M."""
        return self.entries.shape[2]


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (N, S, M) with S = D // M; D must be divisible by M."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    return x.reshape(n, d // m, m)


def _entry_sq(entries: torch.Tensor) -> torch.Tensor:
    """|e|^2 summed over M in index order (the reference's rounding)."""
    acc = entries[..., 0] * entries[..., 0]
    for j in range(1, entries.shape[-1]):
        acc = acc + entries[..., j] * entries[..., j]
    return acc


def train_codebook(residuals: torch.Tensor, init_idx: torch.Tensor, *,
                   m: int = 2, n_iters: int = 10,
                   chunk: int = 16384) -> PQCodebook:
    """Train one k-means codebook per subspace.

    Parameters
    ----------
    residuals : torch.Tensor
        (N, D) f32 training residuals.
    init_idx : torch.Tensor
        (S, E) int — per-subspace init indices into the N residuals.
    m : int
        Subspace dimension M.
    n_iters : int
        Lloyd iterations.
    chunk : int
        Assignment chunk (memory O(S·chunk·E); see ``kmeans.assign``).

    Returns
    -------
    PQCodebook
        Entries (S, E, M) and their squared norms (S, E).
    """
    sub = split_subspaces(residuals, m).transpose(0, 1).contiguous()
    st = kmeans(sub, init_idx, n_iters=n_iters, chunk=chunk)
    return PQCodebook(entries=st.centroids, entry_sq=_entry_sq(st.centroids))


def encode(residuals: torch.Tensor, codebook: PQCodebook) -> torch.Tensor:
    """Nearest entry per subspace: residuals (N, D) -> codes (N, S) uint8."""
    sub = split_subspaces(residuals, codebook.sub_dim).transpose(0, 1)
    codes = assign(sub, codebook.entries)                         # (S, N)
    return codes.transpose(0, 1).to(torch.uint8).contiguous()


def decode(codes: torch.Tensor, codebook: PQCodebook) -> torch.Tensor:
    """Reconstruct residuals from codes: (N, S) uint8 -> (N, S·M) f32."""
    n, s = codes.shape
    s_idx = torch.arange(s, device=codes.device)
    return codebook.entries[s_idx, codes.long()].reshape(n, -1)
