"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000  [arXiv:2402.16819]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256_000,
    activation="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    activation="relu2",
    norm="layernorm",
    dtype="float32",
    param_dtype="float32",
)
