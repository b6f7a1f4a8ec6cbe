"""The port's ssm family (xlstm: mLSTM blocks with periodic sLSTM blocks)
against the JAX reference on the CPU, at its SMOKE config (d_model 64, 4
layers, slstm_every 2, chunk 8) in float32; helpers in
``tests/torch_families.py``.

The reference's chunked mLSTM scan is exact within one chunk; across
chunks its inter-chunk term contracts q with the carried C's other index
and departs from the cell's recurrence, which its own decode computes
(``test_the_references_chunked_scan_departs_from_its_recurrence``; ROADMAP
queue 3). The port computes the recurrence. So the port is held to the
reference where the reference is exact: the scan and the blocks at S ≤
chunk, the sLSTM scan at any S, every decode step, prefill at one chunk,
the engine at prompts of at most one chunk; and, at S 24 (three chunks),
the port's forward against the reference's prefill of the first 8 tokens
followed by 16 teacher-forced decode steps. The multi-chunk scan is also
held to a float64 loop of the recurrence written here.

Tolerances, float32, relative to the largest |value| compared: 2e-5 (the
same float32 math in another order of sums; observed ≤ 5e-6); the float64
recurrence is held at 2e-5 too.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode as j_decode
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import prefill as j_prefill
from repro.models import xlstm as j_xlstm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.convert import cache_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill, xlstm
from repro_torch.models.transformer import ssm_plan
from repro_torch.serve.engine import Request, ServeEngine
from torch_families import (
    both,
    cli_requests,
    layer,
    serve,
    shapes,
    t,
    to_np,
    tokens,
)

ARCH = "xlstm-1.3b"
REL = 2e-5


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def assert_rel(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, limit = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= limit, f"max |err| {err} above {limit} ({rel} of max |want|)"


def true_state(C, n, m):
    """The stabilized state (C, n, m) as the unstabilized (C·e^m, n·e^m):
    the scans may carry different stabilizers for the same state."""
    C, n, m = (np.asarray(_np(x), np.float64) for x in (C, n, m))
    return C * np.exp(m)[..., None, None], n * np.exp(m)[..., None]


def scan_inputs(b, s, nh, p, seed=0):
    g = np.random.default_rng(seed)
    q, k, v = (g.standard_normal((b, s, nh, p)).astype(np.float32) for _ in range(3))
    ig, fg = (g.standard_normal((b, s, nh)).astype(np.float32) for _ in range(2))
    return q, k, v, ig, fg


def scan_state(b, nh, p, seed=9):
    """A carried state: the true state of 6 steps of the recurrence."""
    q, k, v, ig, fg = scan_inputs(b, 6, nh, p, seed)
    _, (C, n, m) = ref.mlstm_scan_ref(*(t(x) for x in (q, k, v, ig, fg)), chunk=6)
    return C.numpy(), n.numpy(), m.numpy()


def recurrence(q, k, v, ig, fg, state=None):
    """The mLSTM cell step by step in float64 (the equations of the
    reference module's docstring, as its ``mlstm_decode`` computes them)."""
    q, k, v, ig, fg = (np.asarray(x, np.float64) for x in (q, k, v, ig, fg))
    b, s, nh, p = q.shape
    if state is None:
        C, n, m = np.zeros((b, nh, p, p)), np.zeros((b, nh, p)), np.full((b, nh), -1e30)
    else:
        C, n, m = (np.asarray(x, np.float64) for x in state)
    scale = p ** -0.5
    ys = []
    for i in range(s):
        logf = -np.logaddexp(0.0, -fg[:, i])
        m_new = np.maximum(logf + m, ig[:, i])
        i_p, f_p = np.exp(ig[:, i] - m_new), np.exp(logf + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * np.einsum("bhp,bhr->bhpr", v[:, i], k[:, i])
        n = f_p[..., None] * n + i_p[..., None] * k[:, i]
        num = np.einsum("bhpr,bhr->bhp", C, q[:, i] * scale)
        den = np.abs(np.einsum("bhp,bhp->bh", n, q[:, i] * scale))
        ys.append(num / np.maximum(den, np.exp(-m_new))[..., None])
        m = m_new
    return np.stack(ys, axis=1), (C, n, m)


# -- the scans --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,p,chunk", [
    (1, 1, 2, 8, 8),
    (2, 5, 2, 16, 8),
    (2, 8, 4, 32, 8),
])
def test_mlstm_scan_ref_is_the_references_at_one_chunk(dtype, b, s, nh, p, chunk):
    # from the zero state: a carried state enters the reference's chunk
    # through its inter-chunk term, the one that departs (see below)
    q, k, v, ig, fg = scan_inputs(b, s, nh, p, seed=s)
    lo = lambda x: jnp.asarray(x).astype(jnp.dtype(dtype))  # noqa: E731
    jy, (jC, jn, jm) = j_xlstm.mlstm_chunked(
        lo(q), lo(k), lo(v), jnp.asarray(ig), jnp.asarray(fg), chunk)
    tlo = lambda x: t(x).to(getattr(torch, dtype))  # noqa: E731
    y, (C, n, m) = ref.mlstm_scan_ref(tlo(q), tlo(k), tlo(v), t(ig), t(fg), chunk)
    assert y.dtype == torch.float32 and y.shape == (b, s, nh, p)
    assert_rel(y, jy)
    for got, want in zip((C, n, m), (jC, jn, jm)):
        assert_rel(got, want)


@pytest.mark.parametrize("s,chunk,with_state", [(24, 8, False), (23, 8, False), (24, 8, True),
                                                (13, 5, False)])
def test_mlstm_scan_ref_over_chunks_is_the_recurrence(s, chunk, with_state):
    # S 24 is three whole chunks; 23 and 13 end in a ragged chunk, which the
    # port masks (the reference would shrink the chunk to 1 for a prime S)
    b, nh, p = 2, 2, 16
    q, k, v, ig, fg = scan_inputs(b, s, nh, p, seed=s + chunk)
    state = scan_state(b, nh, p) if with_state else None
    want, want_final = recurrence(q, k, v, ig, fg, state)
    Cw, nw = true_state(*want_final)
    args = [t(x) for x in (q, k, v, ig, fg)]
    st = None if state is None else tuple(map(t, state))
    y, final = ref.mlstm_scan_ref(*args, chunk=chunk, state=st)
    one, one_final = ref.mlstm_scan_ref(*args, chunk=s, state=st)
    assert_rel(y, want)
    assert_rel(y, one)
    for got in (final, one_final):
        Cg, ng = true_state(*got)
        assert_rel(Cg, Cw)
        assert_rel(ng, nw)


def test_mlstm_scan_ref_of_no_positions_keeps_the_state():
    q, k, v, ig, fg = scan_inputs(1, 0, 2, 8)
    state = tuple(map(t, scan_state(1, 2, 8)))
    y, final = ops.mlstm_scan(*(t(x) for x in (q, k, v, ig, fg)), chunk=8, state=state)
    assert y.shape == (1, 0, 2, 8)
    for got, want in zip(final, state):
        assert torch.equal(got, want)


def test_the_references_chunked_scan_departs_from_its_recurrence():
    # The witness of the reference's defect (repro/models/xlstm.py:114-116:
    # the carried C contracted with q on its value index): at more than one
    # chunk its output leaves both its own one-chunk result and the
    # recurrence by far more than rounding, while the port's stays on both.
    b, s, nh, p = 2, 16, 2, 8
    q, k, v, ig, fg = scan_inputs(b, s, nh, p)
    want, _ = recurrence(q, k, v, ig, fg)
    jargs = [jnp.asarray(x) for x in (q, k, v, ig, fg)]
    j_one = np.asarray(j_xlstm.mlstm_chunked(*jargs, chunk=16)[0])
    j_four = np.asarray(j_xlstm.mlstm_chunked(*jargs, chunk=4)[0])
    scale = np.abs(want).max()
    assert np.abs(j_one - want).max() <= REL * scale  # exact within one chunk
    assert np.abs(j_four - want).max() > 0.1 * scale  # not across chunks
    assert np.abs(j_four - j_one).max() > 0.1 * scale
    y, _ = ref.mlstm_scan_ref(*(t(x) for x in (q, k, v, ig, fg)), chunk=4)
    assert_rel(y, want)
    assert_rel(y, j_one)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,hd,with_state", [(1, 1, 2, 8, False), (2, 19, 4, 16, False),
                                                  (2, 7, 4, 16, True)])
def test_slstm_scan_ref_is_the_references_scan(dtype, b, s, nh, hd, with_state):
    g = np.random.default_rng(s)
    xg = g.standard_normal((b, s, 4 * nh * hd)).astype(np.float32)
    R = (g.standard_normal((4, nh, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    if with_state:
        state = tuple(g.standard_normal((b, nh, hd)).astype(np.float32) for _ in range(2))
        state += (np.abs(g.standard_normal((b, nh, hd))).astype(np.float32) + 0.5,
                  g.standard_normal((b, nh)).astype(np.float32))
    else:
        state = (np.zeros((b, nh, hd), np.float32),) * 3 + (np.full((b, nh), -1e30, np.float32),)
    jd = jnp.dtype(dtype)

    def step(st, x):
        new = j_xlstm._slstm_cell({"r_gates": jnp.asarray(R).astype(jd)}, x, st)
        return new, new[0]

    jfinal, jhs = jax.lax.scan(step, tuple(map(jnp.asarray, state)),
                               jnp.asarray(xg).astype(jd).transpose(1, 0, 2))
    td = getattr(torch, dtype)
    hs, final = ops.slstm_scan(t(xg).to(td), t(R).to(td),
                               state=tuple(map(t, state)) if with_state else None)
    assert hs.dtype == torch.float32 and hs.shape == (b, s, nh, hd)
    assert_rel(hs, np.asarray(jhs).transpose(1, 0, 2, 3))
    for got, want in zip(final, jfinal):
        assert_rel(got, want)


# -- the blocks ---------------------------------------------------------------------------

def _cells(seed=0):
    jcfg, jp, tcfg, tp = both(ARCH, seed=seed)
    return (jcfg, layer(jp["mlstm_blocks"]["cell"]), layer(jp["slstm_blocks"]["cell"]),
            tcfg, layer(tp["mlstm_blocks"]["cell"]), layer(tp["slstm_blocks"]["cell"]))


def _x(cfg, b, s, seed=3):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 5, 8])
def test_mlstm_block_is_the_references(s):
    jcfg, jm, _, tcfg, tm, _ = _cells()
    x = _x(jcfg, 2, s)
    assert_rel(xlstm.mlstm_block(tm, t(x), tcfg), j_xlstm.mlstm_block(jm, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("s", [1, 8, 21])
def test_slstm_block_is_the_references(s):
    jcfg, _, js, tcfg, _, ts = _cells()
    x = _x(jcfg, 2, s)
    assert_rel(xlstm.slstm_block(ts, t(x), tcfg), j_xlstm.slstm_block(js, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_and_decode_of_a_block_are_the_references(kind):
    # prefill of 7 positions (one chunk) into the layer's cache, then three
    # decode steps, each against the reference's, the cache carried by each
    jcfg, jm, js, tcfg, tm, ts = _cells(seed=1)
    jcell, tcell = (jm, tm) if kind == "mlstm" else (js, ts)
    j_pre = getattr(j_decode, f"_{kind}_prefill")
    j_dec = getattr(j_xlstm, f"{kind}_decode")
    x = _x(jcfg, 2, 10, seed=4)
    jy, jc = j_pre(jcell, jnp.asarray(x[:, :7]), jcfg)
    cache = getattr(xlstm, f"{kind}_init_cache")(tcfg, 2, "cpu")
    y = getattr(xlstm, f"{kind}_prefill")(tcell, t(x[:, :7]), tcfg, cache)
    assert_rel(y, jy)
    for key, want in jc.items():
        assert_rel(cache[key], want)
    for i in range(7, 10):
        jy, jc = j_dec(jcell, jnp.asarray(x[:, i:i + 1]), jc, jcfg)
        y, cache = getattr(xlstm, f"{kind}_decode")(tcell, t(x[:, i:i + 1]), cache, tcfg)
        assert_rel(y, jy)
        for key, want in jc.items():
            assert_rel(cache[key], want)


# -- the model ----------------------------------------------------------------------------

def test_init_params_has_the_references_tree():
    jcfg, jp, tcfg, _ = both(ARCH)
    got = init_params(tcfg, torch.Generator().manual_seed(0))
    assert shapes(got) == shapes(jp)
    assert ssm_plan(tcfg) == [("mlstm", 0), ("slstm", 0), ("mlstm", 1), ("slstm", 1)]


def test_forward_prefill_and_decode_are_the_references():
    jcfg, jp, tcfg, tp = both(ARCH)
    toks = tokens(jcfg, (2, 8))
    assert_rel(forward(tp, tcfg, t(toks).long()), j_forward(jp, jcfg, jnp.asarray(toks)))
    jl, jc = j_prefill(jp, jcfg, jnp.asarray(toks), j_init_cache(jcfg, 2, 16))
    tl, tc = prefill(tp, tcfg, t(toks).long(), init_cache(tcfg, 2, 16))
    assert_rel(tl, jl)

    def caches_close(got, want):
        assert got["len"] == int(want["len"])
        for stack in ("mlstm", "slstm"):
            assert got[stack].keys() == want[stack].keys()
            for key, w in want[stack].items():
                assert_rel(got[stack][key], w)

    caches_close(tc, to_np(jc))
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = decode_step(tp, tcfg, t(nxt).long(), tc)
        assert_rel(tl, jl)
    caches_close(tc, to_np(jc))
    # a reference cache carried across
    got = decode_step(tp, tcfg, t(nxt).long(), cache_from_jax(to_np(jc)))[0]
    assert_rel(got, j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)[0])


def test_forward_over_three_chunks_is_the_references_prefill_then_decode():
    # where the reference is exact past one chunk: its prefill of 8 tokens
    # (one chunk), then 16 teacher-forced decode steps; the port's forward
    # runs the chunked scan over all 24 positions (three chunks)
    jcfg, jp, tcfg, tp = both(ARCH, seed=2)
    toks = tokens(jcfg, (2, 24), seed=5)
    got = forward(tp, tcfg, t(toks).long()).numpy()
    jl, jc = j_prefill(jp, jcfg, jnp.asarray(toks[:, :8]), j_init_cache(jcfg, 2, 32))
    want = [np.asarray(j_forward(jp, jcfg, jnp.asarray(toks[:, :8])))]
    for i in range(8, 24):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc)
        want.append(np.asarray(jl)[:, None])
    assert_rel(got, np.concatenate(want, axis=1))


@pytest.mark.parametrize("n", [1, 2])
def test_a_prompt_shorter_than_the_conv_then_decode_continues_the_forward(n):
    # the conv tail of a 1- or 2-token prompt is left-padded with zeros
    # (the reference's decode cannot go on from such a prompt)
    _, _, tcfg, tp = both(ARCH, seed=3)
    toks = tokens(tcfg, (2, n + 4), seed=7)
    want = forward(tp, tcfg, t(toks).long()).numpy()
    cache = init_cache(tcfg, 2, 16)
    logits, _ = prefill(tp, tcfg, t(toks[:, :n]).long(), cache)
    got = [logits.numpy()]
    for i in range(n, n + 4):
        got.append(decode_step(tp, tcfg, t(toks[:, i:i + 1]).long(), cache)[0].numpy())
    assert_rel(np.stack(got, axis=1), want[:, n - 1:])


def test_engine_greedy_tokens_are_the_references_over_refilled_slots():
    # prompts of at most one chunk (8), where the reference is exact; five
    # requests through two slots, so refilled caches are reused
    jcfg, jp, tcfg, tp = both(ARCH, seed=4)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in (8, 5, 7, 3, 6)]
    want = serve(JServeEngine, JRequest, jcfg, jp, prompts, [None] * 5, slots=2)
    got = serve(ServeEngine, Request, tcfg, tp, prompts, [None] * 5, slots=2)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3, 4] and all(len(v) == 5 for v in got.values())


def test_serve_cli_gives_the_references_requests():
    got, last = cli_requests("repro_torch.launch.serve", ARCH, "--device", "cpu")
    want, want_last = cli_requests("repro.launch.serve", ARCH)
    assert got == want and last == want_last == "served 4 requests"
