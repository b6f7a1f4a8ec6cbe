"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in the same float32
operation order, with torch ops that run on any device. The CPU path of
:mod:`repro_torch.kernels.ops` uses them, the tests hold them to
``repro.kernels.ref`` and to the Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel to them on the card. Nothing on the GPU path calls
them. The ``*_bwd_ref`` functions are the backward kernels' twins, each
``torch.autograd.grad`` of its forward's plain version.
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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of :func:`rmsnorm_ref` for the incoming gradient ``g``:
    ``torch.autograd.grad`` of the forward's plain version, dscale in
    float32 (``csrc/rmsnorm_bwd.cu``'s twin)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sg = scale.detach().float().requires_grad_(True)
        dx, ds = torch.autograd.grad(rmsnorm_ref(xg, sg, eps), (xg, sg), g)
    return dx, ds


def rmsnorm_residual_bwd_ref(
    x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
    gh: Optional[torch.Tensor] = None, eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dres, dscale) of :func:`rmsnorm_residual_ref` for the incoming
    gradients ``g`` of y and ``gh`` of h (None: h unused)."""
    with torch.enable_grad():
        xg, rg = (t.detach().requires_grad_(True) for t in (x, res))
        sg = scale.detach().float().requires_grad_(True)
        y, h = rmsnorm_residual_ref(xg, rg, sg, eps)
        outs, grads = (y, h) if gh is not None else (y,), (g, gh) if gh is not None else (g,)
        dx, dres, ds = torch.autograd.grad(outs, (xg, rg, sg), grads)
    return dx, dres, ds


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_ref` for the output's gradient
    ``do``: ``torch.autograd.grad`` of the forward's plain version, each in
    its input's dtype (``csrc/flash_attention_bwd.cu``'s twin)."""
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_attention_ref(qg, kg, vg, causal=causal, window=window, scale=scale)
        return torch.autograd.grad(o, (qg, kg, vg), do)


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
    # masked in log space: exp(cum_i - cum_j) above the diagonal can overflow,
    # and where() would then hand autograd 0 * inf
    T = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))
    W = T * torch.einsum("cbin,cbjn->cbij", cc, bc)[..., None] * dtc[:, :, None, :, :]
    y = torch.einsum("cbijh,cbjhp->cbihp", W, xc)
    y = y + torch.einsum("cbin,cbhnp->cbihp", cc, h_prev) * torch.exp(cum)[..., None]
    y = y.transpose(0, 1).reshape(b, nc * chunk, nh, p)[:, :s]
    return y, h


MlstmState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
SlstmState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_scan_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,
    f_gate: torch.Tensor,
    chunk: int = 64,
    state: Optional[MlstmState] = None,
) -> Tuple[torch.Tensor, MlstmState]:
    """The chunked mLSTM scan in float32: q/k/v (B, S, nh, P), the gates'
    pre-activations ĩ, f̃ (B, S, nh) → (y (B, S, nh, P), final (C (B, nh,
    P, P), n (B, nh, P), m (B, nh))), from ``state`` or C = n = 0, m = -1e30.

    The recurrence of ``repro/models/xlstm.py``'s docstring, which its
    ``mlstm_decode`` steps token by token, computed a chunk at a time as
    ``_mlstm_chunked_impl`` does (every input taken to float32): per chunk,
    log f = log σ(f̃), cumf its inclusive cumsum, src_j = ĩ_j − cumf_j, the
    stabilizer m_c = max(m_{c−1}, max_j src_j), and
      W_ij = exp(cumf_i + src_j − m_c)·(q_i·k_j)/√P for j ≤ i, else 0,
      carry_i = exp(cumf_i + m_{c−1} − m_c),
      y_i = (Σ_j W_ij v_j + carry_i·C q_i/√P)
            / max(|Σ_j W_ij + carry_i·n·q_i/√P|, exp(−m_c)),
      C ← exp(cumf_L + m_{c−1} − m_c)·C + Σ_j exp(cumf_L − cumf_j + ĩ_j − m_c)·v_j k_jᵀ,
    and n likewise with k_j. The carried state enters y as C·q (C[p, r]
    sums v_p k_r), as in the decode; the reference's chunked form contracts
    q with C's other index there, which departs from its own recurrence
    wherever a prompt spans more than one chunk (ROADMAP, queue 3).

    Decomposed as the kernel is not: each chunk's own state contribution
    for all chunks at once, the stabilizers as a running max, then the pass
    over the chunks, then the outputs of all chunks at once. Where
    ``chunk`` does not divide S the sequence is padded to whole chunks with
    ĩ = −inf (no input, no say in the stabilizer) and log f = 0 (no decay),
    which leaves y and the state as a shorter last chunk gives them; the
    reference shrinks the chunk to a divisor of S instead (the same y up to
    rounding: only the stabilizers' frames differ).
    """
    b, s, nh, p = q.shape
    dev = q.device
    if state is None:
        C = torch.zeros((b, nh, p, p), dtype=torch.float32, device=dev)
        n = torch.zeros((b, nh, p), dtype=torch.float32, device=dev)
        m = torch.full((b, nh), NEG_INF, dtype=torch.float32, device=dev)
    else:
        C, n, m = (t.float().clone() for t in state)
    nc = -(-s // chunk)
    if nc == 0:
        return torch.zeros((b, s, nh, p), dtype=torch.float32, device=dev), (C, n, m)
    pad = nc * chunk - s

    def chunks(t: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        # (B, S, ...) → (nc, B, chunk, ...) in float32
        t = t.float()
        if pad:
            t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=fill)
        return t.reshape(b, nc, chunk, *t.shape[2:]).transpose(0, 1)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)  # (nc, B, L, nh, P)
    ic = chunks(i_gate, float("-inf"))  # (nc, B, L, nh)
    cumf = torch.cumsum(chunks(torch.nn.functional.logsigmoid(f_gate.float())), dim=2)
    src = ic - cumf
    last = cumf[:, :, -1]  # (nc, B, nh)
    stab = torch.cummax(torch.cat([m[None], src.amax(dim=2)]), dim=0).values
    m_prev, m_new = stab[:-1], stab[1:]  # (nc, B, nh)
    scale = p ** -0.5
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()[:, :, None]
    logw = cumf[:, :, :, None, :] + src[:, :, None, :, :] - m_new[:, :, None, None, :]
    W = torch.exp(torch.where(causal, logw, float("-inf"))) * (  # masked in log space, as T above
        torch.einsum("cbihp,cbjhp->cbijh", qc, kc) * scale)  # (nc, B, Li, Lj, nh)
    # each chunk's own contribution to the state, and the decay of the one before
    to_end = torch.exp(last[:, :, None] - cumf + ic - m_new[:, :, None])  # (nc, B, L, nh)
    dC = torch.einsum("cbjhp,cbjhr->cbhpr", vc * to_end[..., None], kc)
    dn = torch.einsum("cbjh,cbjhr->cbhr", to_end, kc)
    decay = torch.exp(last + m_prev - m_new)
    before_C, before_n = [], []
    for c in range(nc):
        before_C.append(C)
        before_n.append(n)
        C = decay[c][..., None, None] * C + dC[c]
        n = decay[c][..., None] * n + dn[c]
    carry = torch.exp(cumf + m_prev[:, :, None] - m_new[:, :, None]) * scale  # (nc, B, L, nh)
    num = torch.einsum("cbijh,cbjhp->cbihp", W, vc) + torch.einsum(
        "cbhpr,cbihr->cbihp", torch.stack(before_C), qc) * carry[..., None]
    den = W.sum(dim=3) + torch.einsum("cbhr,cbihr->cbih", torch.stack(before_n), qc) * carry
    y = num / torch.maximum(den.abs(), torch.exp(-m_new)[:, :, None])[..., None]
    y = y.transpose(0, 1).reshape(b, nc * chunk, nh, p)[:, :s]
    return y, (C, n, stab[-1])


def slstm_cell_ref(
    pre_x: torch.Tensor, r_gates: torch.Tensor, state: SlstmState
) -> SlstmState:
    """One sLSTM step: ``pre_x`` (B, 4·nh·hd), the input's gate
    pre-activations (z, i, f, o); ``r_gates`` (4, nh, hd, hd), the
    block-diagonal recurrent weights; ``state`` (h, c, n (B, nh, hd), m
    (B, nh)) float32. ``repro/models/xlstm.py:_slstm_cell`` in float32: the
    i and f gates are per-head means of their pre-activations, and
    h = o·c / max(n, 1e-6)."""
    h, c, n, m = state
    b, nh, hd = h.shape
    rec = torch.einsum("bhp,ghpr->bghr", h, r_gates.float())
    pre = pre_x.float().reshape(b, 4, nh, hd) + rec
    z_t = torch.tanh(pre[:, 0])
    i_t = pre[:, 1].mean(-1)
    f_t = pre[:, 2].mean(-1)
    o_t = torch.sigmoid(pre[:, 3])
    logf = torch.nn.functional.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    i_p = torch.exp(i_t - m_new)[..., None]
    f_p = torch.exp(logf + m - m_new)[..., None]
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, c_new, n_new, m_new


def slstm_scan_ref(
    xg: torch.Tensor, r_gates: torch.Tensor, state: Optional[SlstmState] = None
) -> Tuple[torch.Tensor, SlstmState]:
    """The sLSTM recurrence over S: xg (B, S, 4·nh·hd) the input's gate
    pre-activations, ``r_gates`` (4, nh, hd, hd) → (hs (B, S, nh, hd),
    final (h, c, n, m)), all float32, from ``state`` or h = c = n = 0,
    m = -1e30: :func:`slstm_cell_ref` step by step, the reference's
    ``lax.scan`` of ``_slstm_cell``."""
    b, s, _ = xg.shape
    _, nh, hd, _ = r_gates.shape
    dev = xg.device
    if state is None:
        zeros = torch.zeros((b, nh, hd), dtype=torch.float32, device=dev)
        state = (zeros, zeros, zeros, torch.full((b, nh), NEG_INF, dtype=torch.float32, device=dev))
    else:
        state = tuple(t.float() for t in state)
    hs = []
    for t in range(s):
        state = slstm_cell_ref(xg[:, t], r_gates, state)
        hs.append(state[0])
    out = torch.stack(hs, dim=1) if hs else torch.zeros((b, 0, nh, hd), device=dev)
    return out, state


def _grads_of(fn, inputs, outs_grads):
    """``torch.autograd.grad`` of ``fn(*leaves)`` at ``inputs``: each input
    that is not None becomes a leaf (a detached copy in its dtype); the
    outputs whose incoming gradient is not None are differentiated. Returns
    one gradient per input (None where the input was None or does not reach
    those outputs)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True) for t in inputs]
        outs = fn(*leaves)
        pairs = [(o, g) for o, g in zip(outs, outs_grads) if g is not None]
        wrt = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return tuple(None if t is None else next(got) for t in leaves)


def ssd_scan_bwd_ref(
    xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B_ssm: torch.Tensor,
    C_ssm: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    chunk: int = 128, h0: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """(dxh, ddt, da, dB, dC, dh0) of :func:`ssd_scan_ref` for the incoming
    gradients ``dy`` of y and ``dh`` of the final state (None: the state is
    unused): ``torch.autograd.grad`` of the forward's plain version, each in
    its input's dtype, dh0 None without ``h0`` (``csrc/ssd_bwd.cu``'s twin)."""
    def fn(x, d, a_, b_, c_, h):
        return ssd_scan_ref(x, d, a_, b_, c_, chunk, h)

    return _grads_of(fn, (xh, dt, a, B_ssm, C_ssm, h0), (dy, dh))


def mlstm_scan_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
    f_gate: torch.Tensor, dy: torch.Tensor, dstate: Optional[Sequence[Optional[torch.Tensor]]] = None,
    chunk: int = 64, state: Optional[MlstmState] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """(dq, dk, dv, dĩ, df̃, dC0, dn0, dm0) of :func:`mlstm_scan_ref` for the
    incoming gradients ``dy`` of y and ``dstate`` = (dC, dn, dm) of the final
    state (None, or None entries, where unused): ``torch.autograd.grad`` of
    the forward's plain version, through the stabilizer m and the
    denominator's max as autograd takes them (``csrc/mlstm_bwd.cu``'s twin).
    The state's gradients are None without ``state``."""
    def fn(q_, k_, v_, i_, f_, C0, n0, m0):
        st = None if C0 is None else (C0, n0, m0)
        y, (C, n, m) = mlstm_scan_ref(q_, k_, v_, i_, f_, chunk, st)
        return y, C, n, m

    st = tuple(state) if state is not None else (None, None, None)
    ds = tuple(dstate) if dstate is not None else (None, None, None)
    return _grads_of(fn, (q, k, v, i_gate, f_gate) + st, (dy,) + ds)


def mlstm_steps_ref(q, k, v, i_gate, f_gate, C, n, m):
    """The mLSTM cell step by step (the reference module's equations, as its
    ``mlstm_decode`` takes them) from the state (C, n, m): (y, C, n, m)."""
    scale = q.shape[-1] ** -0.5
    ys = []
    for t in range(q.shape[1]):
        logf = torch.nn.functional.logsigmoid(f_gate[:, t])
        m_new = torch.maximum(logf + m, i_gate[:, t])
        i_p, f_p = torch.exp(i_gate[:, t] - m_new), torch.exp(logf + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * torch.einsum("bhp,bhr->bhpr", v[:, t], k[:, t])
        n = f_p[..., None] * n + i_p[..., None] * k[:, t]
        num = torch.einsum("bhpr,bhr->bhp", C, q[:, t] * scale)
        den = torch.einsum("bhp,bhp->bh", n, q[:, t] * scale).abs()
        ys.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(ys, dim=1), C, n, m


def mlstm_recurrence_bwd_f64(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
    f_gate: torch.Tensor, dy: torch.Tensor, segment: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dĩ, df̃) in float64 from the zero state: autograd of the
    cell's recurrence step by step, not chunked, every input taken to
    float64. The yardstick ``mlstm_scan_bwd``'s kernel and
    :func:`mlstm_scan_bwd_ref` are both held to. Only the states at every
    ``segment``-th step are kept for the backward (the steps between are
    run again), so (1, 2048, 4, 1024) fits a card."""
    from torch.utils.checkpoint import checkpoint

    b, s, nh, p = q.shape
    with torch.enable_grad():
        leaves = [x.detach().double().requires_grad_(True) for x in (q, k, v, i_gate, f_gate)]
        C = torch.zeros((b, nh, p, p), dtype=torch.float64, device=q.device)
        n = torch.zeros((b, nh, p), dtype=torch.float64, device=q.device)
        m = torch.full((b, nh), NEG_INF, dtype=torch.float64, device=q.device)
        ys = []
        for t0 in range(0, s, segment):
            piece = [x[:, t0:t0 + segment] for x in leaves]
            y, C, n, m = checkpoint(mlstm_steps_ref, *piece, C, n, m, use_reentrant=False)
            ys.append(y)
        return torch.autograd.grad(torch.cat(ys, dim=1), leaves, dy.double())


def slstm_scan_bwd_ref(
    xg: torch.Tensor, r_gates: torch.Tensor, dhs: torch.Tensor,
    dstate: Optional[Sequence[Optional[torch.Tensor]]] = None,
    state: Optional[SlstmState] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """(dxg, dR, dh0, dc0, dn0, dm0) of :func:`slstm_scan_ref` for the
    incoming gradients ``dhs`` of hs and ``dstate`` = (dh, dc, dn, dm) of
    the final state (None, or None entries, where unused):
    ``torch.autograd.grad`` of the forward's plain version
    (``csrc/slstm_bwd.cu``'s twin), with R taken to float32 once, so that
    its gradient sums every step in float32 and a bf16 R's is rounded once
    (per step, autograd would sum S bf16-rounded terms in bf16). The
    state's gradients are None without ``state``."""
    def fn(x, r, h0, c0, n0, m0):
        st = None if h0 is None else (h0, c0, n0, m0)
        hs, (h, c, n, m) = slstm_scan_ref(x, r.float(), st)
        return hs, h, c, n, m

    st = tuple(state) if state is not None else (None,) * 4
    ds = tuple(dstate) if dstate is not None else (None,) * 4
    return _grads_of(fn, (xg, r_gates) + st, (dhs,) + ds)
