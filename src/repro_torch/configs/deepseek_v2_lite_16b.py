"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf-verified tier).
27L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400, MLA kv_lora=512,
MoE: 64 routed experts top-6 + 2 shared (d_ff_expert=1408).

Note: the assignment line says "2 shared+160 routed" which contradicts its
own "MoE 64e top-6"; the published model is 64 routed + 2 shared, top-6 —
we implement that. Deviation: layer 0 is MoE like the rest (published model
has one dense first layer) to keep the uniform scanned stack.
"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    head_dim=128,
    attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab_size=512,
    head_dim=16,
    attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, n_shared=1),
    attn_chunk=64,
)
