"""JUNO core of the port: index build, the search of tiers H, M, L and H2
(fused and composed, with or without the RT prefilter), and the mutable
index with its side buffer and freshness tiers.

Public API:
    JunoConfig, JunoIndexData, build, search   — juno.py
    SideBuffer, MutableIndexBase, MutableJunoIndex — juno.py
    MergeScheduler, promote_l0                  — freshness.py
    exact_topk, recall_n_at_k                   — ref.py
"""
from .freshness import (MergeScheduler, MinorGeneration,  # noqa: F401
                        combined_delta, promote_l0)
from .juno import (BuildDraws, JunoConfig, JunoIndexData,  # noqa: F401
                   MutableIndexBase, MutableJunoIndex, SideBuffer, build,
                   draw_build, empty_side_buffer, index_to, search)
from .ref import exact_topk, recall_n_at_k  # noqa: F401
