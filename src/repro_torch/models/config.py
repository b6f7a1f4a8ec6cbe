"""ModelConfig — one declarative config covers all 10 assigned architectures.

Families:
  ``dense``   decoder-only transformer (GQA/MQA, optional qk-norm/bias/SWA)
  ``moe``     dense attention + mixture-of-experts FFN (optional MLA, shared experts)
  ``vlm``     dense backbone with periodic cross-attention layers (vision stub)
  ``ssm``     xLSTM: mLSTM blocks with periodic sLSTM blocks
  ``hybrid``  Mamba2 backbone with a periodic *shared* attention block (Zamba2)
  ``audio``   encoder-decoder transformer (speech frontend stub) — Seamless

All sizes are the exact published configs (see repro_torch/configs/*.py).
A copy of repro/models/config.py (pure dataclasses).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    expert_ff: int = 0  # routed-expert hidden size
    num_shared: int = 0  # shared (always-on) experts (DeepSeek)
    capacity_factor: float = 1.25
    # first k layers use a dense FFN instead of MoE (DeepSeek first_k_dense_replace)
    first_k_dense: int = 0
    dense_ff: int = 0  # hidden size for those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (Zamba2 backbone)."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: mLSTM (matrix-state) + periodic sLSTM (scalar-state) blocks."""

    slstm_every: int = 8  # every k-th block is sLSTM (0 = pure mLSTM)
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 1.333
    chunk: int = 64  # mLSTM chunkwise-parallel chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads (Qwen3 overrides)
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    swa_window: int = 0  # 0 = full attention
    rope_theta: float = 10_000.0
    # norm / activation
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | relu2 | gelu
    # family-specific blocks
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # vlm: every k-th layer is a gated cross-attention layer
    cross_attn_every: int = 0
    num_image_tokens: int = 1024
    # hybrid (Zamba2): shared attention block applied every k mamba layers
    shared_attn_every: int = 0
    # audio / enc-dec
    n_encoder_layers: int = 0  # >0 ⇒ encoder-decoder; n_layers = decoder layers
    encoder_seq: int = 1024  # stub frontend frames
    # embeddings
    tie_embeddings: bool = False
    vocab_pad_to: int = 0  # pad vocab to a multiple (sharding divisibility)
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # -- derived --------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to and self.vocab_size % self.vocab_pad_to:
            return self.vocab_size + self.vocab_pad_to - self.vocab_size % self.vocab_pad_to
        return self.vocab_size

    @property
    def is_enc_dec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (sub-quadratic sequence mixing)."""
        return self.family in ("ssm", "hybrid") or self.swa_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for 6·N·D roofline + memory planning) -----------------
    def param_count(self) -> Tuple[int, int]:
        """Returns (total_params, active_params_per_token)."""
        D, H, KV, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim_
        V = self.padded_vocab
        embed = V * D * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla:
                m = self.mla
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                return (
                    D * m.q_lora_rank
                    + m.q_lora_rank * H * qk_hd
                    + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                    + H * m.v_head_dim * D
                )
            return D * H * hd + 2 * D * KV * hd + H * hd * D

        def dense_ff_params(ff: int) -> int:
            mult = 3 if self.activation == "swiglu" else 2
            return mult * D * ff

        total = 0
        active = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn_params() + dense_ff_params(self.d_ff)
            n_cross = self.n_layers // self.cross_attn_every if self.cross_attn_every else 0
            total = self.n_layers * per_layer + n_cross * attn_params()
            total += self.n_encoder_layers * (attn_params() + dense_ff_params(self.d_ff))
            if self.is_enc_dec:  # decoder cross-attention
                total += self.n_layers * attn_params()
            active = total
        elif self.family == "moe":
            m = self.moe
            router = D * m.num_experts
            routed = m.num_experts * dense_ff_params(m.expert_ff)
            shared = m.num_shared * dense_ff_params(m.expert_ff)
            n_moe = self.n_layers - m.first_k_dense
            total = self.n_layers * attn_params()
            total += m.first_k_dense * dense_ff_params(m.dense_ff)
            total += n_moe * (router + routed + shared)
            active = self.n_layers * attn_params()
            active += m.first_k_dense * dense_ff_params(m.dense_ff)
            active += n_moe * (router + (m.top_k + m.num_shared) * dense_ff_params(m.expert_ff))
        elif self.family == "ssm":
            x = self.xlstm
            inner = int(x.mlstm_proj_factor * D)
            n_s = self.n_layers // x.slstm_every if x.slstm_every else 0
            n_m = self.n_layers - n_s
            mlstm = 2 * D * inner + 3 * inner * inner // max(self.n_heads, 1) + inner * D
            # sLSTM: 4 gates × (input + recurrent per-head) + FFN
            hd_s = D // self.n_heads
            slstm = 4 * (D * D + self.n_heads * hd_s * hd_s) + 2 * D * int(x.slstm_ff_factor * D)
            total = n_m * mlstm + n_s * slstm
            active = total
        elif self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(D)
            nh = s.n_heads(D)
            mamba = D * (2 * di + 2 * s.d_state + nh) + di * s.d_conv + di * D
            n_shared = self.n_layers // self.shared_attn_every if self.shared_attn_every else 0
            shared_blk = attn_params() + dense_ff_params(self.d_ff)
            total = self.n_layers * mamba + shared_blk  # weights shared: counted once
            active = self.n_layers * mamba + n_shared * shared_blk
        else:
            raise ValueError(self.family)
        return total + embed, active + embed
