"""The backward kernels' plain versions for the hybrid and ssm families
(``kernels/ref.py``: ``ssd_scan_bwd_ref``, ``mlstm_scan_bwd_ref``,
``slstm_scan_bwd_ref``, each ``torch.autograd.grad`` of its forward's
plain version) against ``jax.grad`` of the reference on the CPU, at small
shapes from numpy draws:

* K7's against the VJP of ``repro/models/ssm.py:_ssd_chunked_impl``, with
  a ragged S (the port pads the last chunk, the reference shrinks the
  chunk to a divisor of S: the same function) and from a carried state;
  and, there too, the head-summed algebra ``csrc/ssd_bwd.cu``'s bf16 build
  runs, written here in float64;
* the sLSTM's against the VJP of the reference's ``lax.scan`` of
  ``_slstm_cell``, from the zero state and from a carried one;
* the mLSTM's against the VJP of ``mlstm_chunked`` at one chunk (where the
  reference is exact; ROADMAP queue 3) and, over several chunks, against
  float64 autograd of the cell's recurrence written here, which
  ``ref.mlstm_recurrence_bwd_f64`` (the card's float64 yardstick) matches.

Each gradient is held at REL = 1e-4 of its largest |value| (``SSD_REL``'s
precedent: float32 sums in another order). The CUDA kernels are held to
these plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 2). Every input is drawn from a seeded numpy
generator; nothing global is set.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
from repro_torch.kernels import autograd, ops, ref

REL = 1e-4


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def assert_rel(got, want, rel=REL):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, limit = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= limit, f"max |err| {err} above {limit} ({rel} of max |want|)"


# -- K7 ssd_scan ----------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,nh,p,n,chunk,with_state", [
    (1, 16, 2, 8, 4, 8, False),   # two whole chunks
    (2, 13, 2, 8, 4, 4, True),    # ragged (the reference's chunk: 1), from a state, d h_final
    (1, 21, 3, 6, 5, 8, False),   # ragged (the reference's chunk: 7)
])
def test_ssd_scan_bwd_ref_is_jax_grad_of_the_reference(b, s, nh, p, n, chunk, with_state):
    g = np.random.default_rng(s + chunk)
    xh = g.standard_normal((b, s, nh, p)).astype(np.float32)
    dt = g.uniform(0.05, 0.5, (b, s, nh)).astype(np.float32)
    a = -g.uniform(0.2, 1.5, (nh,)).astype(np.float32)
    B, C = (g.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    dy = g.standard_normal((b, s, nh, p)).astype(np.float32)
    h0 = g.standard_normal((b, nh, n, p)).astype(np.float32) if with_state else None
    dh = g.standard_normal((b, nh, n, p)).astype(np.float32) if with_state else None

    def fn(*args):
        return j_ssm._ssd_chunked_impl(*args[:5], chunk, args[5] if with_state else None)

    inputs = (xh, dt, a, B, C) + ((h0,) if with_state else ())
    (_, jh), vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh) if with_state else jnp.zeros_like(jh)))
    got = ref.ssd_scan_bwd_ref(t(xh), t(dt), t(a), t(B), t(C), t(dy),
                               t(dh) if with_state else None, chunk, t(h0) if with_state else None)
    assert (got[5] is None) != with_state
    for gv, wv in zip(got, want):
        assert_rel(gv, wv)


def _ssd_bwd_head_summed(xh, dt, a, B, C, dy, dh, chunk, h0):
    """csrc/ssd_bwd.cu's bf16 algebra in plain float64 torch: per chunk the
    states' terms, then D = sum_h dS^h, with dC_i = sum_j D_ij B_j +
    sum_h e^h_i (H^h dy^h_i) and dB_j = sum_i D_ij C_i + sum_h to^h_j
    (G^h x^h_j); dcum's carried and state-update terms from the same
    products (C_i . H dy_i, x_j . G^T B_j), its in-chunk terms the row
    minus the column sums of (dy.x) W; ddt and da from its reverse cumsum.
    A ragged last chunk is zero-padded. Returns (dxh, ddt, da, dB, dC, dh0)."""
    b, s, nh, p = xh.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunked(x):
        x = torch.nn.functional.pad(x.double(), (0, 0) * (x.dim() - 2) + (0, pad))
        return x.reshape(b, nc, chunk, *x.shape[2:])

    x, dtc, Bc, Cc, dyc = chunked(xh), chunked(dt), chunked(B), chunked(C), chunked(dy)
    cum = torch.cumsum(dtc * a.double(), dim=2)                       # (b, nc, L, nh)
    e, last = torch.exp(cum), cum[:, :, -1:]
    eto = torch.exp(last - cum)
    to, el = eto * dtc, torch.exp(last[:, :, 0])                      # el: (b, nc, nh)
    s_c = torch.einsum("bcjh,bcjn,bcjhp->bchnp", to, Bc, x)
    u_c = torch.einsum("bcih,bcin,bcihp->bchnp", e, Cc, dyc)
    Hs, Gs = [None] * nc, [None] * nc
    hv = torch.zeros((b, nh, n, p), dtype=torch.float64) if h0 is None else h0.double()
    for c in range(nc):
        Hs[c] = hv
        hv = el[:, c, :, None, None] * hv + s_c[:, c]
    gv = torch.zeros((b, nh, n, p), dtype=torch.float64) if dh is None else dh.double()
    for c in reversed(range(nc)):
        Gs[c] = gv
        gv = el[:, c, :, None, None] * gv + u_c[:, c]
    H, G = torch.stack(Hs, 1), torch.stack(Gs, 1)                     # (b, nc, nh, n, p)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (b, nc, i, j, nh)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))[None, None, :, :, None]
    T = torch.exp(torch.where(causal, diff, torch.tensor(float("-inf"), dtype=torch.float64)))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    dv = torch.einsum("bcihp,bcjhp->bcijh", dyc, x)
    W = T * CB * dtc[:, :, None, :, :]
    dS = dv * T * dtc[:, :, None, :, :]
    D = dS.sum(-1)                                                    # sum over the heads
    gB = torch.einsum("bcjn,bchnp->bcjhp", Bc, G)
    gx = torch.einsum("bchnp,bcjhp->bcjhn", G, x)
    hd = torch.einsum("bchnp,bcihp->bcihn", H, dyc)
    dx = torch.einsum("bcijh,bcihp->bcjhp", W, dyc) + to[..., None] * gB
    dCc = torch.einsum("bcij,bcjn->bcin", D, Bc) + (e[..., None] * hd).sum(3)
    dBc = torch.einsum("bcij,bcin->bcjn", D, Cc) + (to[..., None] * gx).sum(3)
    w = (x * gB).sum(-1)                                              # x_j . G^T B_j
    hy = torch.einsum("bcin,bcihn->bcih", Cc, hd)                    # C_i . H dy_i
    rv = dv * W
    dcum = e * hy - to * w + rv.sum(3) - rv.sum(2)
    dcum[:, :, -1] += (to * w).sum(2) + el * (G * H).sum((-1, -2))
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = eto * w + (dv * T * CB).sum(2) + a.double() * dla
    da = (dtc * dla).sum((0, 1, 2))

    def trim(x):
        return x.reshape(b, nc * chunk, *x.shape[3:])[:, :s]

    return trim(dx), trim(ddt), da, trim(dBc), trim(dCc), None if h0 is None else gv


@pytest.mark.parametrize("b,s,nh,p,n,chunk,with_state", [
    (1, 16, 2, 8, 4, 8, False),
    (2, 13, 2, 8, 4, 4, True),
    (1, 21, 3, 6, 5, 8, False),
])
def test_the_head_summed_decomposition_is_jax_grad_of_the_reference(b, s, nh, p, n, chunk, with_state):
    # the algebra csrc/ssd_bwd.cu's bf16 build runs (dB and dC's in-chunk
    # terms summed over the heads before their products), at the shapes above
    g = np.random.default_rng(s + chunk)
    xh = g.standard_normal((b, s, nh, p)).astype(np.float32)
    dt = g.uniform(0.05, 0.5, (b, s, nh)).astype(np.float32)
    a = -g.uniform(0.2, 1.5, (nh,)).astype(np.float32)
    B, C = (g.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    dy = g.standard_normal((b, s, nh, p)).astype(np.float32)
    h0 = g.standard_normal((b, nh, n, p)).astype(np.float32) if with_state else None
    dh = g.standard_normal((b, nh, n, p)).astype(np.float32) if with_state else None

    def fn(*args):
        return j_ssm._ssd_chunked_impl(*args[:5], chunk, args[5] if with_state else None)

    inputs = (xh, dt, a, B, C) + ((h0,) if with_state else ())
    (_, jh), vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh) if with_state else jnp.zeros_like(jh)))
    got = _ssd_bwd_head_summed(t(xh), t(dt), t(a), t(B), t(C), t(dy), t(dh) if with_state else None,
                               chunk, t(h0) if with_state else None)
    assert (got[5] is None) != with_state
    for gv, wv in zip(got, want):
        assert_rel(gv, wv)


# -- the sLSTM recurrence ------------------------------------------------------------------

@pytest.mark.parametrize("b,s,nh,hd,with_state", [(1, 9, 2, 8, False), (2, 7, 2, 16, True)])
def test_slstm_scan_bwd_ref_is_jax_grad_of_the_references_scan(b, s, nh, hd, with_state):
    g = np.random.default_rng(s * hd)
    xg = g.standard_normal((b, s, 4 * nh * hd)).astype(np.float32)
    R = (g.standard_normal((4, nh, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    if with_state:
        state = (g.standard_normal((b, nh, hd)), g.standard_normal((b, nh, hd)),
                 np.abs(g.standard_normal((b, nh, hd))) + 0.5, g.standard_normal((b, nh)))
        state = tuple(x.astype(np.float32) for x in state)
    else:
        state = (np.zeros((b, nh, hd), np.float32),) * 3 + (np.full((b, nh), -1e30, np.float32),)
    dhs = g.standard_normal((b, s, nh, hd)).astype(np.float32)
    dfinal = tuple(g.standard_normal(x.shape).astype(np.float32) for x in state)

    def fn(xg_, R_, *st):
        def step(carry, x):
            new = j_xlstm._slstm_cell({"r_gates": R_}, x, carry)
            return new, new[0]

        final, hs = jax.lax.scan(step, tuple(st), xg_.transpose(1, 0, 2))
        return hs.transpose(1, 0, 2, 3), final

    _, vjp = jax.vjp(fn, *map(jnp.asarray, (xg, R) + state))
    want = vjp((jnp.asarray(dhs), tuple(map(jnp.asarray, dfinal))))
    got = ref.slstm_scan_bwd_ref(t(xg), t(R), t(dhs), tuple(map(t, dfinal)),
                                 tuple(map(t, state)) if with_state else None)
    count = 6 if with_state else 2
    assert sum(x is not None for x in got) == count
    for gv, wv in zip(got[:count], want[:count]):
        assert_rel(gv, wv)


# -- the chunked mLSTM scan ----------------------------------------------------------------

def _mlstm_inputs(b, s, nh, p, seed):
    g = np.random.default_rng(seed)
    q, k, v = (g.standard_normal((b, s, nh, p)).astype(np.float32) for _ in range(3))
    ig, fg = (g.standard_normal((b, s, nh)).astype(np.float32) for _ in range(2))
    dy = g.standard_normal((b, s, nh, p)).astype(np.float32)
    return (q, k, v, ig, fg), dy, g


@pytest.mark.parametrize("b,s,nh,p,chunk", [(1, 8, 2, 8, 8), (2, 5, 2, 16, 8)])
def test_mlstm_scan_bwd_ref_is_jax_grad_of_the_reference_at_one_chunk(b, s, nh, p, chunk):
    # from the zero state, the final state's gradients included: the
    # reference's chunked scan is exact within one chunk
    inputs, dy, g = _mlstm_inputs(b, s, nh, p, seed=s + p)
    dfinal = (g.standard_normal((b, nh, p, p)), g.standard_normal((b, nh, p)),
              g.standard_normal((b, nh)))
    dfinal = tuple(x.astype(np.float32) for x in dfinal)
    _, vjp = jax.vjp(lambda *x: j_xlstm.mlstm_chunked(*x, chunk), *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy), tuple(map(jnp.asarray, dfinal))))
    got = ref.mlstm_scan_bwd_ref(*map(t, inputs), t(dy), tuple(map(t, dfinal)), chunk)
    assert got[5:] == (None, None, None)
    for gv, wv in zip(got, want):
        assert_rel(gv, wv)


def _recurrence64(q, k, v, ig, fg, state):
    """The mLSTM cell step by step (the equations of the reference module's
    docstring, as its ``mlstm_decode`` computes them) in float64 torch."""
    b, s, nh, p = q.shape
    C, n, m = state
    scale = p ** -0.5
    ys = []
    for i in range(s):
        logf = torch.nn.functional.logsigmoid(fg[:, i])
        m_new = torch.maximum(logf + m, ig[:, i])
        i_p, f_p = torch.exp(ig[:, i] - m_new), torch.exp(logf + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * torch.einsum("bhp,bhr->bhpr", v[:, i], k[:, i])
        n = f_p[..., None] * n + i_p[..., None] * k[:, i]
        num = torch.einsum("bhpr,bhr->bhp", C, q[:, i] * scale)
        den = torch.einsum("bhp,bhp->bh", n, q[:, i] * scale).abs()
        ys.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("s,chunk,with_state", [(24, 8, False), (23, 8, True), (13, 5, False)])
def test_mlstm_scan_bwd_ref_over_chunks_is_float64_autograd_of_the_recurrence(s, chunk, with_state):
    b, nh, p = 2, 2, 8
    inputs, dy, g = _mlstm_inputs(b, s, nh, p, seed=s + chunk)
    if with_state:  # a carried state: the state of 6 steps of the scan
        warm, _, _ = _mlstm_inputs(b, 6, nh, p, seed=99)
        _, state = ref.mlstm_scan_ref(*map(t, warm), chunk=6)
    else:
        state = (torch.zeros((b, nh, p, p)), torch.zeros((b, nh, p)), torch.full((b, nh), -1e30))
    with torch.enable_grad():
        leaves = [t(x).double().requires_grad_(True) for x in inputs]
        st = [x.double().requires_grad_(True) for x in state]
        y = _recurrence64(*leaves, st)
        want = torch.autograd.grad(y, leaves + (st if with_state else []), t(dy).double())
    got = ref.mlstm_scan_bwd_ref(*map(t, inputs), t(dy), None, chunk,
                                 state if with_state else None)
    assert sum(x is not None for x in got) == len(want)
    for gv, wv in zip([x for x in got if x is not None], want):
        assert_rel(gv, wv)


@pytest.mark.parametrize("s,segment", [(23, 5), (16, 64)])
def test_mlstm_recurrence_bwd_f64_is_autograd_of_the_recurrence(s, segment):
    # the float64 yardstick the card's mLSTM gradients are held to
    # (scripts/torch_mlstm_f64_probe.py): its steps run again a segment at a
    # time under checkpointing, and give autograd's gradients exactly
    b, nh, p = 2, 2, 8
    inputs, dy, _ = _mlstm_inputs(b, s, nh, p, seed=s + segment)
    state = (torch.zeros((b, nh, p, p)), torch.zeros((b, nh, p)), torch.full((b, nh), -1e30))
    with torch.enable_grad():
        leaves = [t(x).double().requires_grad_(True) for x in inputs]
        y = _recurrence64(*leaves, [x.double() for x in state])
        want = torch.autograd.grad(y, leaves, t(dy).double())
    got = ref.mlstm_recurrence_bwd_f64(*map(t, inputs), t(dy), segment=segment)
    for gv, wv in zip(got, want):
        assert gv.dtype == torch.float64
        assert_rel(gv, wv, rel=1e-12)


# -- the CPU path never takes the card's autograd ----------------------------------------

def test_a_cpu_call_under_autograd_runs_the_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached kernels/autograd.py")

    for name in ("SsdScan", "MlstmScan", "SlstmScan", "RmsNorm", "RmsNormResidual", "FlashAttention"):
        monkeypatch.setattr(getattr(autograd, name), "apply", refuse)
    g = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=g).requires_grad_(True)

    with torch.enable_grad():
        xh, bm, cm = leaf(1, 9, 2, 4), leaf(1, 9, 3), leaf(1, 9, 3)
        dt = torch.rand((1, 9, 2), generator=g).requires_grad_(True)
        a = (-torch.rand((2,), generator=g)).requires_grad_(True)
        y, h = ops.ssd_scan(xh, dt, a, bm, cm, chunk=4)
        q, k, v, ig, fg = leaf(1, 9, 2, 4), leaf(1, 9, 2, 4), leaf(1, 9, 2, 4), leaf(1, 9, 2), leaf(1, 9, 2)
        ym, _ = ops.mlstm_scan(q, k, v, ig, fg, chunk=4)
        xg, R = leaf(1, 5, 4 * 2 * 4), leaf(4, 2, 4, 4)
        hs, _ = ops.slstm_scan(xg, R)
        x, s = leaf(3, 8), leaf(8)
        r = ops.rmsnorm(x, s) + ops.rmsnorm_residual(x, x, s)[0]
        qa = leaf(1, 6, 2, 8)
        o = ops.flash_attention(qa, qa, qa)
        loss = y.sum() + h.sum() + ym.sum() + hs.sum() + r.sum() + o.sum()
        grads = torch.autograd.grad(loss, (xh, dt, a, bm, cm, q, k, v, ig, fg, xg, R, x, s, qa))
    assert all(torch.isfinite(gr).all() for gr in grads)
