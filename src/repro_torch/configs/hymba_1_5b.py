"""hymba-1.5b [hybrid] — arXiv:2411.13676 (hf-verified tier).
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + mamba heads in every block (head_dim=64).

Deviations (recorded per DESIGN.md §4): meta-tokens omitted; all layers use
SWA (window 1024) — Hymba mixes 3 global layers in, our uniform-scan layout
keeps every block identical (long_500k viability is what SWA provides).
"""
from ..models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="hymba-1.5b",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    mixer_kind="hybrid", sliding_window=1024,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, n_groups=1),
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    mixer_kind="hybrid", sliding_window=32,
    ssm=SSMConfig(d_state=8, head_dim=16, expand=2, n_groups=1, chunk=16),
    attn_chunk=64,
)
