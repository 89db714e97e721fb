"""mamba2-1.3b [ssm] — arXiv:2405.21060 (unverified tier).
48L d_model=2048 (attention-free) d_ff=0 vocab=50280, ssm_state=128 —
SSD (state-space duality). d_inner=4096 (expand 2), 64 heads × head_dim 64.
Blocks are pure mamba mixers (no MLP), matching the published architecture.
"""
from ..models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,   # attn unused
    d_ff=0, vocab_size=50280,
    attn_kind="none", mixer_kind="ssm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=512,
    attn_kind="none", mixer_kind="ssm",
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1, chunk=16),
)
