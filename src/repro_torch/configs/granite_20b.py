"""granite-20b [dense] — llama-arch code model, MQA (kv=1).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152  [arXiv:2405.04324; hf]

GELU MLP (2 matrices): with the published d_ff=4·d_model, a 3-matrix
swiglu would put the model at 28B; the real granite-20b-code MLP is
gelu, landing the total at ~20B as the name says.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="granite-20b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    activation="gelu",
    norm="rmsnorm",
    dtype="float32",
    param_dtype="float32",
)
