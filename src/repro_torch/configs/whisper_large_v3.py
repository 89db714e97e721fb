"""whisper-large-v3 [audio] — arXiv:2212.04356 (unverified tier).
32L d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866 — enc-dec.

The conv/mel frontend is a STUB per the task spec: input_specs() provides
precomputed frame embeddings (B, 1500, d_model). "32L" is per stack
(32 encoder + 32 decoder). Deviation: RoPE instead of Whisper's
learned/sinusoidal positions (backbone-shape preserving, see DESIGN.md §4).
"""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    encoder_decoder=True, n_encoder_layers=32,
    n_context_tokens=1500,          # 30 s of audio at 50 Hz after conv stub
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512,
    encoder_decoder=True, n_encoder_layers=2, n_context_tokens=24,
    attn_chunk=64,
)
