"""The input-shape matrix and per-(arch × shape) applicability.

Port of ``repro/launch/shapes.py``, the same shapes and skip reasons.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Skip rules from the assignment (recorded in DESIGN.md §4):
    long_500k needs sub-quadratic attention — run for SSM/hybrid/SWA archs,
    skip for pure full-attention archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 500k dense KV decode is "
                       "quadratic-cost; runnable via --juno-attention only "
                       "(DESIGN.md §4)")
    return True, ""
