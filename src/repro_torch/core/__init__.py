"""JUNO core of the port: index build and the search of tiers H, M, L
and H2 (fused and composed), with or without the RT prefilter.

Public API:
    JunoConfig, JunoIndexData, build, search   — juno.py
    exact_topk, recall_n_at_k                   — ref.py
"""
from .juno import (BuildDraws, JunoConfig, JunoIndexData,  # noqa: F401
                   build, draw_build, index_to, search)
from .ref import exact_topk, recall_n_at_k  # noqa: F401
