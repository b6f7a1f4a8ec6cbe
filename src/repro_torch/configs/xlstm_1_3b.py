"""xlstm-1.3b [ssm] — mLSTM blocks with every 8th an sLSTM block (7:1).

48L d_model=2048 4H d_ff=0 vocab=50304  [arXiv:2405.04517]
Sub-quadratic (O(1) recurrent state) → runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    norm="rmsnorm",
    xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=2.0, slstm_ff_factor=1.333, chunk=64),
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    norm="rmsnorm",
    xlstm=XLSTMConfig(slstm_every=2, mlstm_proj_factor=2.0, slstm_ff_factor=1.333, chunk=8),
    dtype="float32",
    param_dtype="float32",
)
