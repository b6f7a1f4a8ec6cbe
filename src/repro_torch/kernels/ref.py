"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in the same float32
operation order, with torch ops that run on any device. The CPU path of
:mod:`repro_torch.kernels.ops` uses them, the tests hold them to
``repro.kernels.ref`` and to the Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel to them on the card. Nothing on the GPU path calls
them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

Stages = Sequence[Tuple[float, float]]
NEG_INF = -1e30  # the reference's mask value


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x·rsqrt(mean(x²) + eps)·scale in float32, returned in x's dtype.

    ``contiguous()`` pins the layout the row sums are taken over, so a
    strided view and a packed copy of the same rows give the same bits.
    """
    xf = x.float().contiguous()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_residual_ref(
    x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rmsnorm(h)·scale, h) with h = x + res summed in float32; both in x's dtype.

    Like the Pallas kernel (and the CUDA one), the norm sees the float32
    sum; ``repro.kernels.ref.rmsnorm_residual_ref`` norms the sum rounded to
    x's dtype, which differs inside the bf16 tolerance.
    """
    h = x.float() + res.float()
    return rmsnorm_ref(h, scale, eps).to(x.dtype), h.to(x.dtype)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention in float32, q (B, Sq, H, hd), k (B, Sk, KV,
    hd), v (B, Sk, KV, hd_v); the output is (B, Sq, H, hd_v).

    Query head h reads KV head h // (H // KV) (q is regrouped, K/V are not
    repeated). Key j is visible to query i when j <= i (causal) and
    j > i - window (window > 0); masked scores are -1e30, the row sum is
    clamped at 1e-30. The kernel takes the same softmax online over tiles.
    v's head dim may differ from q's and k's (MLA: 128 against 192).
    """
    b, sq, h, hd = q.shape
    sk, kv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, sq, kv, g, hd) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]  # (B, Sq, KV, G, 1)
    return (out / torch.clamp(l, min=1e-30)).reshape(b, sq, h, hd_v).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: int,
    *,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token (B, 1, H, hd) against a (B, S, KV, hd) cache, float32.

    Positions [max(0, cache_len - window), cache_len) are valid (all below
    cache_len for window = 0); an empty range gives a zero row, as in the
    kernel, which never visits a tile without a valid position.
    """
    b, _, h, hd = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q[:, 0].float().reshape(b, kv, h // kv, hd) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    pos = torch.arange(s_max, device=q.device)
    valid = pos < cache_len
    if window:
        valid &= pos >= cache_len - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _stages_f32(x: torch.Tensor, stages: Stages) -> torch.Tensor:
    """x ← x·s + o per stage in float32, each product and sum rounded."""
    x = x.float()
    for scale, offset in stages:
        x = x * scale + offset
    return x


def map_chain_ref(x: torch.Tensor, stages: Stages) -> torch.Tensor:
    """x ← x·s + o per stage in float32, each product and sum rounded
    separately, cast once to x's dtype (as the Pallas kernel computes).

    Sequential, never algebraically collapsed: bitwise identity with the
    unfused op-by-op ``senml_parse`` chain is the contract, in float32,
    where this is that very sequence of roundings.
    """
    return _stages_f32(x, stages).to(x.dtype)


def affine_rmsnorm_ref(
    x: torch.Tensor, scale: torch.Tensor, stages: Stages, eps: float = 1e-6
) -> torch.Tensor:
    """rmsnorm of the stages' float32 result, cast once to x's dtype."""
    return rmsnorm_ref(_stages_f32(x, stages), scale, eps).to(x.dtype)


def kalman_scan_ref(
    z: torch.Tensor, xe: torch.Tensor, p: torch.Tensor, q: float, r: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scalar Kalman filter per channel over the rows of ``z`` (B, C).

    Per row: p⁻ = p + q; k = p⁻/(p⁻ + r); xe ← xe + k·(z − xe);
    p ← (1 − k)·p⁻. Returns (filtered rows (B, C), final xe, final p).
    """
    rows = []
    for i in range(z.shape[0]):
        p_pred = p + q
        k = p_pred / (p_pred + r)
        xe = xe + k * (z[i] - xe)
        p = (1.0 - k) * p_pred
        rows.append(xe)
    y = torch.stack(rows) if rows else z.new_empty((0,) + tuple(z.shape[1:]))
    return y, xe, p


def ssd_scan_ref(
    xh: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    B_ssm: torch.Tensor,
    C_ssm: torch.Tensor,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 chunked SSD scan in float32: xh (B, S, nh, P), dt (B, S, nh),
    a (nh,), B/C (B, S, N) → (y (B, S, nh, P), final state (B, nh, N, P)).

    The chunked algorithm of ``repro/models/ssm.py:_ssd_chunked_impl`` with
    every input taken to float32 first (the jnp scan forms C·Bᵀ in the
    inputs' dtype), in the decomposition of the bf16 CUDA build: every
    chunk's own state s_c = Bᵀ(x·exp(cum_last − cum)·dt) and decay
    e_c = exp(cum_last), all at once; then the state pass
    h_c = e_c·h_{c−1} + s_c over the chunks, from ``h0`` or zero; then
    y = W·x + exp(cum)·(C·h_{c−1}) for all chunks at once. Where ``chunk``
    does not divide S, the sequence is zero-padded to whole chunks (dt = 0
    and x = B = C = 0: no decay, no input) and y cropped, as the kernel
    masks its ragged last chunk; the reference shrinks the chunk to a
    divisor of S instead. Both give the same y and state up to rounding.
    """
    b, s, nh, p = xh.shape
    n = B_ssm.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    h = torch.zeros((b, nh, n, p), dtype=torch.float32, device=xh.device)
    if h0 is not None:
        h = h0.float().clone()
    if nc == 0:
        return torch.zeros((b, s, nh, p), dtype=torch.float32, device=xh.device), h

    def chunks(t: torch.Tensor) -> torch.Tensor:  # (B, S, ...) → (nc, B, chunk, ...), f32
        t = t.float()
        if pad:
            t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, chunk, *t.shape[2:]).transpose(0, 1)

    xc, dtc, bc, cc = chunks(xh), chunks(dt), chunks(B_ssm), chunks(C_ssm)
    cum = torch.cumsum(dtc * a.float(), dim=2)  # (nc, B, L, nh) log-decay, ≤ 0
    last = cum[:, :, -1:, :]  # (nc, B, 1, nh)
    # each chunk's own state and decay
    to_end = torch.exp(last - cum) * dtc
    states = torch.einsum("cbjn,cbjhp->cbhnp", bc, xc * to_end[..., None])
    el = torch.exp(last[:, :, 0, :])[..., None, None]  # (nc, B, nh, 1, 1)
    # the state pass: the state before each chunk, and the final one
    before = []
    for c in range(nc):
        before.append(h)
        h = el[c] * h + states[c]
    h_prev = torch.stack(before)  # (nc, B, nh, N, P)
    # the outputs of all chunks
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).tril()[:, :, None]
    T = torch.where(causal, torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]), 0.0)
    W = T * torch.einsum("cbin,cbjn->cbij", cc, bc)[..., None] * dtc[:, :, None, :, :]
    y = torch.einsum("cbijh,cbjhp->cbihp", W, xc)
    y = y + torch.einsum("cbin,cbhnp->cbihp", cc, h_prev) * torch.exp(cum)[..., None]
    y = y.transpose(0, 1).reshape(b, nc * chunk, nh, p)[:, :s]
    return y, h
