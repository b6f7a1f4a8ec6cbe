"""qwen3-4b [dense] — qk_norm, GQA, head_dim=128 (≠ d_model/H).

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936  [hf:Qwen/Qwen3-8B]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=32,
    qk_norm=True,
    activation="swiglu",
    norm="rmsnorm",
    dtype="float32",
    param_dtype="float32",
)
