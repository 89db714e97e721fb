"""Unified model configuration covering all 10 architectures of the repo.

Port of ``repro/models/config.py``, field for field: one declarative
dataclass that each ``repro_torch/configs/<arch>.py`` instantiates with
the published numbers. The model code dispatches on the ``attn_kind`` /
``mixer_kind`` / ``moe`` / ``cross_attn_period`` / ``encoder_decoder``
fields, so every family (dense / MoE / MLA / SSM / hybrid / enc-dec /
VLM) is a configuration, not a fork.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0         # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256          # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 → d_model // n_heads

    # mixer selection
    attn_kind: str = "gqa"                  # "gqa" | "mla" | "none"
    mixer_kind: str = "attn"                # "attn" | "ssm" | "hybrid"
    sliding_window: Optional[int] = None    # SWA width (tokens) or None

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # structure
    cross_attn_period: int = 0              # every Nth layer cross-attends
    n_context_tokens: int = 0               # cross-attn context length (stub frontend)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # numerics / memory policy
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 1024                  # flash-style KV block size

    # training
    max_seq_len: int = 8192
    accum_steps: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or \
            self.attn_kind != "gqa"

    @property
    def is_ssm_only(self) -> bool:
        return self.mixer_kind == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if serve_step memory is bounded independent of context length
        (SSM state, or sliding-window attention)."""
        return (self.mixer_kind == "ssm"
                or (self.sliding_window is not None)
                or (self.mixer_kind == "hybrid"
                    and self.sliding_window is not None))

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), for the
        6·N·D roofline term. MoE counts all experts; n_active_params()
        counts the activated subset."""
        return self._count(active_only=False)

    def n_active_params(self) -> int:
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        d, hd = self.d_model, self.head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += d * self.vocab_size                  # lm_head

        def attn_params():
            if self.attn_kind == "mla":
                m = self.mla or MLAConfig()
                qd = nh * (m.qk_nope_dim + m.qk_rope_dim)
                p = d * qd                                             # q
                p += d * (m.kv_lora_rank + m.qk_rope_dim)              # kv down
                p += m.kv_lora_rank * nh * (m.qk_nope_dim + m.v_head_dim)
                p += nh * m.v_head_dim * d                             # o
                return p
            return d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d

        def mlp_params():
            if self.moe:
                e = (self.moe.top_k if active_only else self.moe.n_experts)
                p = 3 * d * self.moe.d_ff_expert * (e + self.moe.n_shared)
                p += d * self.moe.n_experts                            # router
                return p
            return 3 * d * self.d_ff                                   # swiglu

        def ssm_params():
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            p = d * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim)
            p += d_in * d                                              # out
            return p

        per_layer = 2 * d                                              # norms
        if self.mixer_kind == "attn":
            per_layer += attn_params() + (mlp_params() if self.d_ff or self.moe else 0)
        elif self.mixer_kind == "ssm":
            per_layer = d + ssm_params()
        else:  # hybrid: both mixers in parallel + mlp
            per_layer += attn_params() + ssm_params() + mlp_params()

        n_blocks = self.n_layers
        if self.cross_attn_period:
            n_cross = self.n_layers // self.cross_attn_period
            n_blocks = self.n_layers - n_cross
            total += n_cross * (attn_params() + mlp_params() + 2 * d)
        total += n_blocks * per_layer
        if self.encoder_decoder:
            # encoder blocks (self-attn + mlp) + decoder cross-attn add-ons
            total += self.n_encoder_layers * (attn_params() + mlp_params()
                                              + 2 * d)
            total += self.n_layers * (attn_params() + d)   # cross per dec layer
        return total
