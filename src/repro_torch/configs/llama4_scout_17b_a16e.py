"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E
(unverified tier). 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (+1 shared expert, per the released
model). Early-fusion vision frontend is a stub → lowered as a text LM
(DESIGN.md §4). iRoPE nuance (rope-free every 4th layer) not modeled."""
from ..models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1),
    attn_chunk=64,
)
