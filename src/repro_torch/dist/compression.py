"""Gradient compression for a cross-host all-reduce.

Port of ``repro/dist/compression.py``. Two codecs over gradient trees
(nested dicts of tensors):

* bf16 cast-through: halves the traffic; AdamW's m/v accumulation absorbs
  the rounding noise.
* int8 with error feedback: 4× compression; each leaf's quantization
  residual is carried to the next step and added back before quantizing,
  so the accumulated decompressed signal tracks the accumulated true
  gradient (the EF-SGD guarantee). Codes round half to even, as the
  reference's ``jnp.round``. The arithmetic follows the jitted reference
  as XLA compiles it: the scale's division by 127 is a product with the
  f32 reciprocal, the residual one fused multiply-add.

Compressed leaves are ``Int8Leaf(q, scale)`` NamedTuples.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.params import tree_map


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


# --------------------------------------------------------------------------
# bf16 cast-through
# --------------------------------------------------------------------------


def compress_bf16(tree):
    """Cast float leaves to bf16 (non-float leaves pass through)."""
    return tree_map(lambda x: x.to(torch.bfloat16) if _is_float(x) else x,
                    tree)


def decompress_bf16(tree):
    """Cast float leaves back to f32."""
    return tree_map(lambda x: x.float() if _is_float(x) else x, tree)


# --------------------------------------------------------------------------
# int8 with error feedback
# --------------------------------------------------------------------------


_INV127 = float(np.float32(1.0) / np.float32(127.0))


class Int8Leaf(NamedTuple):
    q: torch.Tensor       # int8 codes, same shape as the gradient leaf
    scale: torch.Tensor   # () f32: the leaf's max-abs / 127


def _one(g, e):
    """One leaf -> (its compressed form, its residual)."""
    if not _is_float(g):
        return g, torch.zeros((), dtype=torch.float32)
    g_eff = g.float() + e
    # XLA divides by the constant 127 as a product with its f32 reciprocal
    scale = torch.clamp(torch.max(torch.abs(g_eff)) * _INV127, min=1e-12)
    q = torch.clamp(torch.round(g_eff / scale), -127, 127).to(torch.int8)
    # ``g_eff - q * scale`` is a fused multiply-add in the jitted
    # reference: rounded once, through f64
    residual = (q.double() * -scale.double() + g_eff.double()).float()
    return Int8Leaf(q, scale), residual


def compress_int8(tree, err: Optional[object] = None):
    """Quantize float leaves to ``Int8Leaf`` with error feedback.

    ``err`` is the residual tree returned by the previous call (None on
    the first step). Returns ``(compressed_tree, new_err)``.
    """
    if err is None:
        err = tree_map(lambda x: torch.zeros(
            x.shape if _is_float(x) else (), dtype=torch.float32,
            device=x.device if isinstance(x, torch.Tensor) else None), tree)

    def walk(t, e):
        if isinstance(t, dict):
            pairs = {k: walk(t[k], e[k]) for k in t}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        return _one(t, e)
    return walk(tree, err)


def decompress_int8(tree):
    """Invert ``compress_int8`` (up to the quantization residual)."""
    return tree_map(lambda x: x.q.float() * x.scale
                    if isinstance(x, Int8Leaf) else x, tree)
