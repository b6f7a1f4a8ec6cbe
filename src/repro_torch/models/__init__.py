"""Model zoo of the port: the dense family (granite, nemotron, qwen1.5,
qwen3), the moe family (mixtral-8x22b with grouped-query attention and a
sliding window; deepseek-v2 with multi-head latent attention), the vlm
family (llama-3.2-vision: gated cross-attention to image tokens), the ssm
family (xlstm: mLSTM blocks with periodic sLSTM blocks), the hybrid family
(zamba2: Mamba2 with a shared attention block) and the audio family
(seamless: an encoder-decoder), all ten architectures, on the kernels of
:mod:`repro_torch.kernels`."""
from .config import MLAConfig, MoEConfig, ModelConfig, SSMConfig, XLSTMConfig
from .transformer import forward, init_params
from .decode import decode_step, encode, init_cache, prefill

__all__ = [
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "XLSTMConfig",
    "decode_step",
    "encode",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
]
