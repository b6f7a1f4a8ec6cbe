"""The port's vlm family (llama-3.2-vision: gated cross-attention to image
tokens) against the JAX reference on the CPU, at its SMOKE config in
float32 (rtol = atol = 1e-5; helpers in ``tests/torch_families.py``).

The reference initialises every gate to 0, so ``tanh(gate)·y`` drops every
cross-attention output and a check with those weights would hold nothing
of it. The gates are set to the same nonzero numpy values in both packages
(``torch_families.GATES``), and ``test_the_memory_reaches_the_logits``
shows that the image tokens then move the logits, in both.

  * the modules: ``cross_attention`` (K5 without a mask at Sq != Sk, and
    for one query K6 over the whole memory), ``cross_kv``/``cross_attend``
    against ``_cross_kv``/``_cross_apply``, ``chunked_attention`` without a
    mask at Sq != Sk;
  * the whole path: the parameter tree (the 0-d ``gate`` per layer),
    ``forward(memory=)``, ``prefill`` (logits, the self blocks' K/V and the
    ``cross`` stack), three ``decode_step``s, a reference cache carried
    across, ``ServeEngine``'s greedy tokens over refilled slots (a memory
    per request); the CLI.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attention
from repro.models import decode as j_decode
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import prefill as j_prefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.convert import cache_from_jax
from repro_torch.kernels import ops
from repro_torch.models import attention, decode_step, forward, init_cache, init_params, prefill
from repro_torch.serve.engine import Request, ServeEngine
from torch_families import (
    TOL,
    assert_cache_close,
    both,
    cli_requests,
    engine_prompts,
    hidden,
    layer,
    mem_len,
    memory,
    serve,
    shapes,
    t,
    to_np,
    tokens,
)

ARCH = "llama-3.2-vision-90b"


@pytest.mark.parametrize("seq", [1, 12, 40])
@pytest.mark.parametrize("block", [0, 1])
def test_cross_attention_is_the_references(seq, block):
    jcfg, jp, tcfg, tp = both(ARCH)
    jl, tl = layer(jp["cross_blocks"]["attn"], block), layer(tp["cross_blocks"]["attn"], block)
    assert tl["gate"].dim() == 0 and float(tl["gate"]) != 0
    x, mem = hidden(jcfg, (2, seq)), memory(jcfg, 2)
    want = np.asarray(j_attention.cross_attention(jl, jnp.asarray(x), jnp.asarray(mem), jcfg))
    got = attention.cross_attention(tl, t(x), t(mem), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("seq", [1, 7])
def test_cross_kv_and_cross_attend_are_the_references(seq):
    jcfg, jp, tcfg, tp = both(ARCH)
    jl, tl = layer(jp["cross_blocks"]["attn"], 1), layer(tp["cross_blocks"]["attn"], 1)
    mem, x = memory(jcfg, 2), hidden(jcfg, (2, seq))
    jk, jv = j_decode._cross_kv(jl, jnp.asarray(mem), jcfg)
    k, v = attention.cross_kv(tl, t(mem), tcfg)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    want = np.asarray(j_decode._cross_apply(jl, jnp.asarray(x), jk, jv, jcfg))
    np.testing.assert_allclose(attention.cross_attend(tl, t(x), k, v, tcfg).numpy(), want, **TOL)


@pytest.mark.parametrize("sq,sk,h,kv", [(1, 16, 4, 2), (12, 16, 4, 2), (159, 64, 8, 1),
                                        (600, 70, 2, 2)])
def test_chunked_attention_without_a_mask_and_sq_not_sk(sq, sk, h, kv):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, kv, 16)).astype(np.float32)
    want = np.asarray(j_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    got = attention.chunked_attention(t(q), t(k), t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_a_decoded_tokens_cross_attention_is_k6_over_the_whole_memory(monkeypatch):
    # one query against the memory goes to decode_attention (K6 on the card)
    # at cache_len = memory_len, never to flash_attention at Sq = 1
    jcfg, jp, tcfg, tp = both(ARCH)
    toks = tokens(jcfg, (1, 6))
    cache = init_cache(tcfg, 1, 16, memory_len=mem_len(tcfg))
    prefill(tp, tcfg, t(toks).long(), cache, memory=t(memory(jcfg, 1)))
    calls = []
    flash, dec = ops.flash_attention, ops.decode_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: calls.append("K5") or flash(*a, **k))
    monkeypatch.setattr(ops, "decode_attention",
                        lambda q, kc, vc, n, **k: calls.append(("K6", kc.shape[1], n)) or dec(q, kc, vc, n, **k))
    decode_step(tp, tcfg, t(toks[:, :1]).long(), cache)
    n_cross = tcfg.n_layers // tcfg.cross_attn_every
    assert "K5" not in calls
    assert calls.count(("K6", mem_len(tcfg), mem_len(tcfg))) == n_cross
    assert len(calls) == tcfg.n_layers  # the self blocks' K6 over their caches


# -- whole model --------------------------------------------------------------------

def test_init_params_has_the_references_tree():
    jcfg, jp, tcfg, _ = both(ARCH)
    got = init_params(tcfg, torch.Generator().manual_seed(0))
    assert shapes(got) == shapes(jp)
    n_cross = tcfg.n_layers // tcfg.cross_attn_every
    assert tuple(got["cross_blocks"]["attn"]["gate"].shape) == (n_cross,)
    assert not got["cross_blocks"]["attn"]["gate"].any()  # 0, as the reference's


@pytest.mark.parametrize("seq", [12, 40])
def test_forward_logits_are_the_references(seq):
    jcfg, jp, tcfg, tp = both(ARCH)
    toks, mem = tokens(jcfg, (2, seq), seed=seq), memory(jcfg, 2)
    want = np.asarray(j_forward(jp, jcfg, jnp.asarray(toks), memory=jnp.asarray(mem)))
    got = forward(tp, tcfg, t(toks).long(), memory=t(mem)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_the_memory_reaches_the_logits():
    # with nonzero gates the image tokens move the logits (in both
    # packages); with the reference's zero gates they do not
    jcfg, jp, tcfg, tp = both(ARCH)
    toks, mem = tokens(jcfg, (1, 10)), memory(jcfg, 1)
    runs = {}
    for name, m in (("drawn", mem), ("zero", np.zeros_like(mem))):
        runs[name] = forward(tp, tcfg, t(toks).long(), memory=t(m)).numpy()
        np.testing.assert_allclose(runs[name], np.asarray(j_forward(
            jp, jcfg, jnp.asarray(toks), memory=jnp.asarray(m))), **TOL)
    assert np.abs(runs["drawn"] - runs["zero"]).max() > 1e-2 * np.abs(runs["zero"]).max()
    tp["cross_blocks"]["attn"]["gate"].zero_()
    closed = [forward(tp, tcfg, t(toks).long(), memory=t(m)).numpy() for m in (mem, 0 * mem)]
    np.testing.assert_array_equal(closed[0], closed[1])


@pytest.mark.parametrize("seq", [9, 30])
def test_prefill_and_decode_are_the_references(seq):
    jcfg, jp, tcfg, tp = both(ARCH, seed=1)
    max_len, ml = 48, mem_len(jcfg)
    toks, mem = tokens(jcfg, (2, seq), seed=seq), memory(jcfg, 2, seed=seq)
    jl, jc = j_prefill(jp, jcfg, jnp.asarray(toks), j_init_cache(jcfg, 2, max_len, memory_len=ml),
                       memory=jnp.asarray(mem))
    cache = init_cache(tcfg, 2, max_len, memory_len=ml)
    cache["cross"]["k"].fill_(3.0)  # stale: prefill overwrites the cross stack whole
    tl, tc = prefill(tp, tcfg, t(toks).long(), cache, memory=t(mem))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["cross"]["k"].shape == (tcfg.n_layers // tcfg.cross_attn_every, 2, ml,
                                      tcfg.n_kv_heads, tcfg.head_dim_)
    assert_cache_close(tc, to_np(jc))
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = decode_step(tp, tcfg, t(nxt).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tc, to_np(jc))
    got = decode_step(tp, tcfg, t(nxt).long(), cache_from_jax(to_np(jc)))[0]
    want = j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_needs_a_memory_of_the_caches_length():
    _, _, tcfg, tp = both(ARCH)
    toks = t(tokens(tcfg, (1, 5))).long()
    cache = init_cache(tcfg, 1, 16, memory_len=mem_len(tcfg))
    with pytest.raises(ValueError, match="needs memory"):
        prefill(tp, tcfg, toks, cache)
    with pytest.raises(ValueError, match="memory_len"):
        prefill(tp, tcfg, toks, cache, memory=torch.zeros((1, 3, tcfg.d_model)))


def test_engine_greedy_tokens_over_refilled_slots():
    jcfg, jp, tcfg, tp = both(ARCH, seed=2)
    prompts, mems = engine_prompts(jcfg, 5)
    want = serve(JServeEngine, JRequest, jcfg, jp, prompts, mems, slots=2)
    got = serve(ServeEngine, Request, tcfg, tp, prompts, mems, slots=2)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3, 4] and all(len(v) == 5 for v in got.values())


def test_serve_cli_gives_the_references_requests():
    got, last = cli_requests("repro_torch.launch.serve", ARCH, "--device", "cpu")
    want, want_last = cli_requests("repro.launch.serve", ARCH)
    assert got == want and last == want_last == "served 4 requests"
