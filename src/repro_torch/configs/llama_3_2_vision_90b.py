"""llama-3.2-vision-90b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision scaled
per assignment (unverified tier). 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256 — cross-attn image layers.

Realised as 80 self-attention + 20 cross-attention blocks (every 5th layer
cross-attends), image frontend stubbed: input_specs() provides patch
embeddings (B, 6400, d_model)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    cross_attn_period=5, n_context_tokens=6400,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    cross_attn_period=2, n_context_tokens=16, attn_chunk=64,
)
