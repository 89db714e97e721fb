"""h2o-danube-3-4b [dense] — arXiv:2401.16818 (unverified tier).
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 — llama+mistral mix,
SWA. Window = 4096 (the danube-family sliding window); head_dim = 120."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-3-4b",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    sliding_window=4096,
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    n_layers=2, d_model=120, n_heads=4, n_kv_heads=2,
    d_ff=240, vocab_size=512, sliding_window=32, attn_chunk=64,
)
