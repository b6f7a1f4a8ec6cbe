"""llama-3.2-vision-90b [vlm] — gated cross-attn image layers every 5th.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision]  The vision frontend is a STUB:
``input_specs`` supplies precomputed patch embeddings (B, 1024, D).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    cross_attn_every=5,
    num_image_tokens=1024,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-90b-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    norm="rmsnorm",
    cross_attn_every=2,
    num_image_tokens=16,
    dtype="float32",
    param_dtype="float32",
)
