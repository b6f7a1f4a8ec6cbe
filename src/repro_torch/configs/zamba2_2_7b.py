"""zamba2-2.7b [hybrid] — Mamba2 backbone + one *shared* attention block
applied every 6 layers (9 applications, weights shared).

54L d_model=2560 32H (kv=32) d_ff=10240 ssm_state=64  [arXiv:2411.15242; hf]
Long-context adaptation (DESIGN.md §6.1): the shared attention block uses a
4096 sliding window so the long_500k decode cell holds O(window) KV state.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    norm="rmsnorm",
    swa_window=4096,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    norm="rmsnorm",
    swa_window=16,
    shared_attn_every=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=8),
    dtype="float32",
    param_dtype="float32",
)
