"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12L(enc) + 12L(dec) d_model=1024 16H d_ff=4096 vocab=256206
[arXiv:2308.11596; hf]  The speech frontend is a STUB: ``input_specs``
supplies precomputed frame embeddings (B, 1024, D). vocab padded to 256
multiple for clean vocab-parallel sharding (256206 → 256256).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    vocab_pad_to=256,
    activation="gelu",
    norm="layernorm",
    n_encoder_layers=12,
    encoder_seq=1024,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=510,
    vocab_pad_to=64,
    activation="gelu",
    norm="layernorm",
    n_encoder_layers=2,
    encoder_seq=16,
    dtype="float32",
    param_dtype="float32",
)
