"""xLSTM blocks: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar
memory, a sequential recurrence with block-diagonal recurrent weights)
(port of ``repro/models/xlstm.py``).

mLSTM cell (stabilized exponential gating), per head with key/value dim P:
  m_t = max(f̃_t + m_{t−1}, ĩ_t)                     (stabilizer)
  i'_t = exp(ĩ_t − m_t),  f'_t = exp(f̃_t + m_{t−1} − m_t)
  C_t = f'_t C_{t−1} + i'_t v_t k_tᵀ                 (P×P matrix state)
  n_t = f'_t n_{t−1} + i'_t k_t
  h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1)
with f̃ the log-sigmoid of the forget pre-activation.

:func:`mlstm_chunked` runs the sequence through :func:`repro_torch.kernels.
ops.mlstm_scan` at the reference's ``kernel_mlstm_scan`` region, and the
sLSTM blocks run their time loop through :func:`repro_torch.kernels.ops.
slstm_scan` (the reference's ``lax.scan`` of ``_slstm_cell``): one CUDA
launch each on the card, the plain versions on the CPU. The chunked scan
computes the cell above (the carried state enters as C·q), which is what
the reference's decode computes and what its chunked form computes within
one chunk; across chunks the reference contracts q with C's other index
(ROADMAP, queue 3). The projections, the causal conv, the gated FFN and
the one-token decode updates are plain torch, as the reference leaves them
to XLA. Dtypes are the reference's: q/k/v in the activation dtype (taken
to float32 inside the scans), the states (C, n, m, h, c) and the conv
tails in float32, the decode's conv and projections after it in float32
(the weights promoted), ``y`` rounded to the activation dtype before the
norm. The decodes write the layer's cache IN PLACE.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from .common import dense_init, rms_norm
from .ssm import _causal_conv, conv_tail

CONV = 4  # the causal conv's width; the cache keeps its last CONV - 1 inputs


def _dims(cfg) -> Tuple[int, int, int]:
    """(inner width, heads, head dim P) of the mLSTM blocks."""
    inner = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    return inner, cfg.n_heads, inner // cfg.n_heads


def _conv_step(cache: Dict[str, torch.Tensor], x: torch.Tensor, p) -> torch.Tensor:
    """One decode step of the causal conv over [cached CONV - 1 inputs, x
    (B, 1, C)], float32, the cache's tail moved on in place; returns
    silu(conv) (B, C)."""
    win = torch.cat([cache["conv"], x.float()], dim=1)
    out = torch.einsum("bkc,kc->bc", win, p["conv_w"].float()) + p["conv_b"].float()
    cache["conv"].copy_(win[:, 1:])
    return F.silu(out)


# ---------------------------------------------------------------- mLSTM ----

def mlstm_params(gen: torch.Generator, cfg, dtype: torch.dtype, layers: int) -> Dict[str, Any]:
    """mLSTM weights of ``layers`` layers, stacked on a leading axis."""
    D = cfg.d_model
    inner, nh, _ = _dims(cfg)
    L = layers
    return {
        "w_up": dense_init(gen, (L, D, 2 * inner), dtype, fan_in=D),
        "conv_w": dense_init(gen, (L, CONV, inner), dtype, fan_in=CONV),
        "conv_b": torch.zeros((L, inner), dtype=dtype, device=gen.device),
        "wq": dense_init(gen, (L, inner, inner), dtype, fan_in=inner),
        "wk": dense_init(gen, (L, inner, inner), dtype, fan_in=inner),
        "wv": dense_init(gen, (L, inner, inner), dtype, fan_in=inner),
        "w_if": dense_init(gen, (L, inner, 2 * nh), dtype, fan_in=inner),  # input/forget gates
        "out_norm": torch.ones((L, inner), dtype=dtype, device=gen.device),
        "w_down": dense_init(gen, (L, inner, D), dtype, fan_in=inner),
    }


def mlstm_chunked(
    q: torch.Tensor,  # (B, S, nh, P)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, S, nh) pre-activation ĩ
    f_gate: torch.Tensor,  # (B, S, nh) pre-activation f̃ (log-sigmoid applied in the scan)
    chunk: int,
    state: ref.MlstmState = None,
) -> Tuple[torch.Tensor, ref.MlstmState]:
    """Chunked scan; returns (y (B, S, nh, P) float32, final (C, n, m))."""
    return ops.mlstm_scan(q, k, v, i_gate, f_gate, chunk=chunk, state=state)


def _mlstm_seq(p: Dict[str, Any], x: torch.Tensor, cfg):
    """The block over a whole sequence: (out (B, S, D), the conv's input xc
    (B, S, inner), the scan's final (C, n, m))."""
    inner, nh, P = _dims(cfg)
    B, S, _ = x.shape
    up = x @ p["w_up"]
    xg, xc = up[..., :inner], up[..., inner:]
    xconv = F.silu(_causal_conv(xc, p["conv_w"], p["conv_b"]))
    q = (xconv @ p["wq"]).reshape(B, S, nh, P)
    k = (xconv @ p["wk"]).reshape(B, S, nh, P)
    v = (xc @ p["wv"]).reshape(B, S, nh, P)
    gates = xconv @ p["w_if"]
    y, state = mlstm_chunked(q, k, v, gates[..., :nh], gates[..., nh:], chunk=cfg.xlstm.chunk)
    y = y.reshape(B, S, inner).to(x.dtype)
    y = rms_norm(y, p["out_norm"]) * F.silu(xg)
    return y @ p["w_down"], xc, state


def mlstm_block(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, D) -> (B, S, D)."""
    return _mlstm_seq(p, x, cfg)[0]


def mlstm_init_cache(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    inner, nh, P = _dims(cfg)
    return {
        "conv": torch.zeros((batch, CONV - 1, inner), dtype=torch.float32, device=device),
        "C": torch.zeros((batch, nh, P, P), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, P), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), ref.NEG_INF, dtype=torch.float32, device=device),
    }


def mlstm_prefill(p: Dict[str, Any], x: torch.Tensor, cfg, cache: Dict[str, torch.Tensor]):
    """Like :func:`mlstm_block`, and writes the layer's ``cache`` IN PLACE
    whole: the conv tail and the final (C, n, m)."""
    out, xc, (C, n, m) = _mlstm_seq(p, x, cfg)
    conv_tail(cache["conv"], xc)
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    cache["m"].copy_(m)
    return out


def mlstm_decode(
    p: Dict[str, Any], x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D) one token; the cell's step in float32, written to
    ``cache`` IN PLACE (the returned dict holds the same tensors)."""
    inner, nh, P = _dims(cfg)
    up = x @ p["w_up"]
    xg, xc = up[..., :inner], up[..., inner:]
    xconv = _conv_step(cache, xc, p)  # (B, inner) float32
    q = (xconv @ p["wq"].float()).reshape(-1, nh, P)
    k = (xconv @ p["wk"].float()).reshape(-1, nh, P)
    v = (xc @ p["wv"])[:, 0].reshape(-1, nh, P).float()
    gates = xconv @ p["w_if"].float()
    i_t, f_t = gates[:, :nh], gates[:, nh:]
    logf = F.logsigmoid(f_t)
    m_prev = cache["m"]
    m_new = torch.maximum(logf + m_prev, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(logf + m_prev - m_new)
    scale = P ** -0.5
    C = cache["C"]
    C.mul_(f_p[..., None, None]).add_(
        torch.einsum("bhp,bhr->bhpr", v, k).mul_(i_p[..., None, None]))
    n = cache["n"]
    n.mul_(f_p[..., None]).add_(i_p[..., None] * k)
    num = torch.einsum("bhpr,bhr->bhp", C, q * scale)
    den = torch.einsum("bhp,bhp->bh", n, q * scale).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    cache["m"].copy_(m_new)
    y = h.reshape(-1, 1, inner).to(x.dtype)
    y = rms_norm(y, p["out_norm"]) * F.silu(xg)
    return y @ p["w_down"], cache


# ---------------------------------------------------------------- sLSTM ----

def slstm_params(gen: torch.Generator, cfg, dtype: torch.dtype, layers: int) -> Dict[str, Any]:
    """sLSTM weights of ``layers`` layers, stacked on a leading axis."""
    D = cfg.d_model
    nh = cfg.n_heads
    hd = D // nh
    ff = int(cfg.xlstm.slstm_ff_factor * D)
    L = layers
    return {
        "conv_w": dense_init(gen, (L, CONV, D), dtype, fan_in=CONV),
        "conv_b": torch.zeros((L, D), dtype=dtype, device=gen.device),
        # input projections for gates z, i, f, o
        "w_gates": dense_init(gen, (L, D, 4 * D), dtype, fan_in=D),
        # block-diagonal recurrent weights per head: (4 gates, nh, hd, hd)
        "r_gates": dense_init(gen, (L, 4, nh, hd, hd), dtype, fan_in=hd),
        "gn": torch.ones((L, D), dtype=dtype, device=gen.device),
        "ff_gate": dense_init(gen, (L, D, ff), dtype, fan_in=D),
        "ff_up": dense_init(gen, (L, D, ff), dtype, fan_in=D),
        "ff_down": dense_init(gen, (L, ff, D), dtype, fan_in=ff),
    }


def _slstm_cell(p, xg: torch.Tensor, state: ref.SlstmState) -> ref.SlstmState:
    """One step. xg: (B, 4D) input-gate pre-activations; state (h, c, n, m)."""
    return ref.slstm_cell_ref(xg, p["r_gates"], state)


def _slstm_out(p, hs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cell's outputs ``hs`` (B, S, nh, hd) float32 through the group
    norm and the gated FFN (factor 4/3), in x's dtype."""
    B, S = hs.shape[:2]
    y = rms_norm(hs.reshape(B, S, -1).to(x.dtype), p["gn"])
    ff = F.silu(y @ p["ff_gate"]) * (y @ p["ff_up"])
    return ff @ p["ff_down"]


def _slstm_seq(p: Dict[str, Any], x: torch.Tensor, cfg):
    """The block over a whole sequence: (out (B, S, D), final (h, c, n, m))."""
    xconv = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
    hs, state = ops.slstm_scan(xconv @ p["w_gates"], p["r_gates"])
    return _slstm_out(p, hs, x), state


def slstm_block(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, D) -> (B, S, D)."""
    return _slstm_seq(p, x, cfg)[0]


def slstm_init_cache(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    nh = cfg.n_heads
    hd = D // nh
    return {
        "conv": torch.zeros((batch, CONV - 1, D), dtype=torch.float32, device=device),
        "h": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "c": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), ref.NEG_INF, dtype=torch.float32, device=device),
    }


def slstm_prefill(p: Dict[str, Any], x: torch.Tensor, cfg, cache: Dict[str, torch.Tensor]):
    """Like :func:`slstm_block`, and writes the layer's ``cache`` IN PLACE
    whole: the conv tail (of the block's input x) and the final (h, c, n, m)."""
    out, state = _slstm_seq(p, x, cfg)
    conv_tail(cache["conv"], x)
    for key, t in zip("hcnm", state):
        cache[key].copy_(t)
    return out


def slstm_decode(
    p: Dict[str, Any], x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D) one token; written to ``cache`` IN PLACE."""
    xconv = _conv_step(cache, x, p)
    xg = xconv @ p["w_gates"].float()
    state = _slstm_cell(p, xg, tuple(cache[key] for key in "hcnm"))
    for key, t in zip("hcnm", state):
        cache[key].copy_(t)
    return _slstm_out(p, state[0][:, None], x), cache
