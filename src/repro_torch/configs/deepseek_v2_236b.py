"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400  [arXiv:2405.04434; hf]
First layer uses a dense FFN (d_ff=12288) per the published config.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102_400,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        expert_ff=1536,
        num_shared=2,
        capacity_factor=1.25,
        first_k_dense=1,
        dense_ff=12288,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        num_experts=4,
        top_k=2,
        expert_ff=96,
        num_shared=1,
        capacity_factor=1.25,
        first_k_dense=1,
        dense_ff=128,
    ),
    mla=MLAConfig(
        kv_lora_rank=32,
        q_lora_rank=48,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    dtype="float32",
    param_dtype="float32",
)
