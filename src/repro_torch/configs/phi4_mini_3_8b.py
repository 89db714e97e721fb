"""phi4-mini-3.8b [dense] — arXiv:2412.08905 (hf-verified tier).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
Deviation notes: phi-4-mini uses partial rotary + tied embeddings; we apply
full-head RoPE and untied head (backbone-shape preserving).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064,
)

SMOKE = ModelConfig(
    name="phi4-mini-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, attn_chunk=64,
)
