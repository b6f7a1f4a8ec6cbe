"""Model zoo of the port: the dense family (granite, nemotron, qwen1.5,
qwen3), the moe family with grouped-query attention (mixtral-8x22b: 8
experts, top-2, sliding-window attention) and the hybrid family (zamba2:
Mamba2 with a shared attention block) on the kernels of
:mod:`repro_torch.kernels`. The configuration dataclasses cover all ten
architectures; the other families, and MLA (deepseek-v2), raise
``NotImplementedError`` naming their slice of the port (ROADMAP)."""
from .config import MLAConfig, MoEConfig, ModelConfig, SSMConfig, XLSTMConfig
from .transformer import forward, init_params
from .decode import decode_step, init_cache, prefill

__all__ = [
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "XLSTMConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
]
