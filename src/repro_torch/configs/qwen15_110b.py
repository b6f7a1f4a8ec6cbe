"""qwen1.5-110b [dense] — QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152_064,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    dtype="float32",
    param_dtype="float32",
)
