"""JUNO core of the port: index build, the search of tiers H, M, L and H2
(fused and composed, with or without the RT prefilter), and the mutable
index with its side buffer and freshness tiers; ``core.scan`` holds the
stage-D oracles of one cluster's scan.

Public API:
    JunoConfig, JunoIndexData, build, search   — juno.py
    SideBuffer, MutableIndexBase, MutableJunoIndex — juno.py
    MergeScheduler, promote_l0                  — freshness.py
    exact_topk                                  — ref.py
    recall_1_at_k, recall_n_at_k                — metrics.py (paper §6.1)
"""
from .freshness import (MergeScheduler, MinorGeneration,  # noqa: F401
                        combined_delta, promote_l0)
from .juno import (BuildDraws, JunoConfig, JunoIndexData,  # noqa: F401
                   MutableIndexBase, MutableJunoIndex, SideBuffer, build,
                   draw_build, empty_side_buffer, index_to, search)
from .metrics import recall_1_at_k, recall_n_at_k  # noqa: F401
from .ref import exact_topk  # noqa: F401
