"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768  [arXiv:2401.04088; hf]
SWA window 4096 (per the Mistral sliding-window design named in the
assignment) makes the long_500k decode cell O(window).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    activation="swiglu",
    norm="rmsnorm",
    swa_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=16384, capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    norm="rmsnorm",
    swa_window=16,
    moe=MoEConfig(num_experts=4, top_k=2, expert_ff=128, capacity_factor=1.25),
    dtype="float32",
    param_dtype="float32",
)
