"""The port's audio family (seamless-m4t: an encoder-decoder over stub frame
embeddings) against the JAX reference on the CPU, at its SMOKE config in
float32 (rtol = atol = 1e-5; helpers in ``tests/torch_families.py``).

  * the modules: ``encode`` (non-causal self-attention blocks over the
    frames, K5 without a mask), the decoder's ungated ``cross_attention``,
    ``chunked_attention`` without a mask at Sq = Sk;
  * the whole path: the parameter tree, ``forward(memory=)`` (and that the
    frames move the logits), ``prefill`` (logits, the decoder's K/V and the
    ``cross`` stack of the encoder states' K/V), three ``decode_step``s, a
    reference cache carried across, ``ServeEngine``'s greedy tokens over
    refilled slots (frames per request); the CLI.
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
from repro_torch.models import attention, decode_step, encode, forward, init_cache, init_params, prefill
from repro_torch.serve.engine import Request, ServeEngine
from torch_families import (
    TOL,
    assert_cache_close,
    both,
    cli_requests,
    engine_prompts,
    layer,
    mem_len,
    memory,
    serve,
    shapes,
    t,
    to_np,
    tokens,
)

ARCH = "seamless-m4t-medium"


@pytest.mark.parametrize("batch,seed", [(1, 0), (2, 5)])
def test_encode_is_the_references(batch, seed):
    jcfg, jp, tcfg, tp = both(ARCH, seed=seed)
    frames = memory(jcfg, batch, seed=seed)
    want = np.asarray(j_decode.encode(jp, jcfg, jnp.asarray(frames)))
    got = encode(tp, tcfg, t(frames))
    assert got.shape == (batch, mem_len(tcfg), tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("seq", [1, 12])
@pytest.mark.parametrize("block", [0, 1])
def test_cross_attention_is_the_references(seq, block):
    jcfg, jp, tcfg, tp = both(ARCH)
    jl, tl = layer(jp["cross_blocks"]["attn"], block), layer(tp["cross_blocks"]["attn"], block)
    assert "gate" not in tl
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    mem = memory(jcfg, 2)
    want = np.asarray(j_attention.cross_attention(jl, jnp.asarray(x), jnp.asarray(mem), jcfg))
    np.testing.assert_allclose(attention.cross_attention(tl, t(x), t(mem), tcfg).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("s,h", [(16, 4), (129, 4), (600, 2)])
def test_chunked_attention_without_a_mask(s, h):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((1, s, h, 16)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    got = attention.chunked_attention(t(q), t(k), t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- whole model --------------------------------------------------------------------

def test_init_params_has_the_references_tree():
    jcfg, jp, tcfg, _ = both(ARCH)
    got = init_params(tcfg, torch.Generator().manual_seed(0))
    assert shapes(got) == shapes(jp)
    assert tuple(got["encoder"]["attn"]["wq"].shape)[0] == tcfg.n_encoder_layers


@pytest.mark.parametrize("seq", [12, 40])
def test_forward_logits_are_the_references(seq):
    jcfg, jp, tcfg, tp = both(ARCH)
    toks, frames = tokens(jcfg, (2, seq), seed=seq), memory(jcfg, 2)
    want = np.asarray(j_forward(jp, jcfg, jnp.asarray(toks), memory=jnp.asarray(frames)))
    got = forward(tp, tcfg, t(toks).long(), memory=t(frames)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_the_frames_reach_the_logits():
    jcfg, jp, tcfg, tp = both(ARCH)
    toks, frames = tokens(jcfg, (1, 10)), memory(jcfg, 1)
    runs = {}
    for name, m in (("drawn", frames), ("zero", np.zeros_like(frames))):
        runs[name] = forward(tp, tcfg, t(toks).long(), memory=t(m)).numpy()
        np.testing.assert_allclose(runs[name], np.asarray(j_forward(
            jp, jcfg, jnp.asarray(toks), memory=jnp.asarray(m))), **TOL)
    assert np.abs(runs["drawn"] - runs["zero"]).max() > 1e-2 * np.abs(runs["zero"]).max()


@pytest.mark.parametrize("seq", [9, 30])
def test_prefill_and_decode_are_the_references(seq):
    jcfg, jp, tcfg, tp = both(ARCH, seed=1)
    max_len, ml = 48, mem_len(jcfg)
    toks, frames = tokens(jcfg, (2, seq), seed=seq), memory(jcfg, 2, seed=seq)
    jl, jc = j_prefill(jp, jcfg, jnp.asarray(toks), j_init_cache(jcfg, 2, max_len, memory_len=ml),
                       memory=jnp.asarray(frames))
    tl, tc = prefill(tp, tcfg, t(toks).long(), init_cache(tcfg, 2, max_len, memory_len=ml),
                     memory=t(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["cross"]["v"].shape == (tcfg.n_layers, 2, ml, tcfg.n_kv_heads, tcfg.head_dim_)
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


def test_prefill_then_decode_continues_the_forward():
    jcfg, jp, tcfg, tp = both(ARCH, seed=3)
    toks, frames = tokens(jcfg, (2, 14), seed=6), memory(jcfg, 2, seed=6)
    want = np.asarray(j_forward(jp, jcfg, jnp.asarray(toks), memory=jnp.asarray(frames)))[:, -1]
    cache = init_cache(tcfg, 2, 16, memory_len=mem_len(tcfg))
    prefill(tp, tcfg, t(toks[:, :-1]).long(), cache, memory=t(frames))
    got, _ = decode_step(tp, tcfg, t(toks[:, -1:]).long(), cache)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


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
