"""deepseek-coder-33b [dense] — arXiv:2401.14196 (hf-verified tier).
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 — llama-arch."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab_size=32256,
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke",
    n_layers=2, d_model=112, n_heads=4, n_kv_heads=2,
    d_ff=224, vocab_size=512, attn_chunk=64,
)
