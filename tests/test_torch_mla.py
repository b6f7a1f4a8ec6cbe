"""The port's MLA (multi-head latent attention, deepseek-v2) against the JAX
reference on the CPU, at deepseek-v2-236b's SMOKE config in float32
(rtol = atol = 1e-5; helpers in ``tests/torch_families.py``):

  * the modules: ``mla_attention`` (prefill: K/V expanded from the latent,
    q/k head dim 24 against v's 16), ``mla_decode`` (the absorbed decode
    over the latent cache, written in place) and ``chunked_attention``
    with a v head dim below q's;
  * route (a) of K5, held on the plain version: v zero-padded to q's head
    dim, the output sliced, gives the unpadded result bit for bit;
  * the whole path: the parameter tree, ``forward``, ``prefill`` (logits,
    and the ``c_kv``/``k_rope`` caches of the dense and the MoE stacks),
    three ``decode_step``s, a reference cache carried across, and
    ``ServeEngine``'s greedy tokens over refilled slots; the CLI.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attention
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import prefill as j_prefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.convert import cache_from_jax
from repro_torch.kernels import flash_attention, ref
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
    serve,
    shapes,
    t,
    to_np,
    tokens,
)

ARCH = "deepseek-v2-236b"


@pytest.mark.parametrize("stack", ["dense_blocks", "blocks"])
@pytest.mark.parametrize("seq", [1, 12, 40])
def test_mla_attention_is_the_references(stack, seq):
    jcfg, jp, tcfg, tp = both(ARCH)
    jl, tl = layer(jp[stack]["attn"], 0), layer(tp[stack]["attn"], 0)
    x = hidden(jcfg, (2, seq))
    pos = np.arange(seq)[None, :]
    want = np.asarray(j_attention.mla_attention(jl, jnp.asarray(x), jnp.asarray(pos), jcfg))
    got = attention.mla_attention(tl, t(x), t(pos).long(), tcfg)
    assert got.shape == (2, seq, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("filled,s_max", [(0, 16), (7, 16), (15, 16), (16, 16)])
def test_mla_decode_is_the_references(filled, s_max):
    # a cache holding `filled` positions of stale latents; at filled = s_max
    # the token goes to the last slot, as the reference's clamped write
    jcfg, jp, tcfg, tp = both(ARCH)
    jl, tl = layer(jp["blocks"]["attn"], 1), layer(tp["blocks"]["attn"], 1)
    m = jcfg.mla
    rng = np.random.default_rng(filled)
    c_kv = rng.standard_normal((2, s_max, m.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((2, s_max, m.qk_rope_head_dim)).astype(np.float32)
    x = hidden(jcfg, (2, 1), seed=filled + 10)
    jcache = {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope),
              "len": jnp.asarray(filled, jnp.int32)}
    want, wcache = j_attention.mla_decode(jl, jnp.asarray(x), jcache, jcfg)
    tcache = {"c_kv": t(c_kv.copy()), "k_rope": t(k_rope.copy()), "len": filled}
    got, gcache = attention.mla_decode(tl, t(x), tcache, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert gcache["c_kv"] is tcache["c_kv"]  # written in place
    assert gcache["len"] == int(wcache["len"]) == filled + 1
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(gcache[key].numpy(), np.asarray(wcache[key]), **TOL)


@pytest.mark.parametrize("sq,h,kv", [(12, 4, 4), (40, 8, 2), (600, 2, 1)])
def test_chunked_attention_with_a_smaller_v_head_dim(sq, h, kv):
    # MLA's shape: q/k head dim 24 (nope 16 + rope 8) against v's 16, causal,
    # the scale passed; 600 > the reference's 512-row q tile
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, h, 24)).astype(np.float32)
    k = rng.standard_normal((2, sq, kv, 24)).astype(np.float32)
    v = rng.standard_normal((2, sq, kv, 16)).astype(np.float32)
    want = np.asarray(j_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, scale=24 ** -0.5))
    got = attention.chunked_attention(t(q), t(k), t(v), causal=True, scale=24 ** -0.5)
    assert got.shape == (2, sq, h, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal,sq,sk", [(True, 33, 33), (False, 17, 70)])
@pytest.mark.parametrize("hd,hd_v", [(24, 16), (192, 128)])
def test_route_a_padded_value_is_exactly_the_unpadded_result(causal, sq, sk, hd, hd_v):
    # what K5 does on the card for MLA (v zero-padded to q's head dim, the
    # output sliced), on the plain version: the zero columns add nothing
    g = torch.Generator().manual_seed(hd)
    q = torch.randn((1, sq, 4, hd), generator=g)
    k = torch.randn((1, sk, 2, hd), generator=g)
    v = torch.randn((1, sk, 2, hd_v), generator=g)
    want = ref.flash_attention_ref(q, k, v, causal=causal, scale=0.1)
    got = flash_attention.attend_padded_value(ref.flash_attention_ref, q, k, v, causal=causal,
                                              scale=0.1)
    assert got.shape == (1, sq, 4, hd_v) and got.is_contiguous()
    assert torch.equal(got, want)
    # the card's bf16 runs MLA's (192, 128) at v's own head dim (flash_fwd_wide);
    # f32 and unbuilt pairs keep route (a)
    wide = (hd, hd_v) in flash_attention.WIDE_PAIRS
    assert ("route (a)" in flash_attention.route(torch.bfloat16, hd, hd_v)) == (not wide)
    assert flash_attention.route(torch.bfloat16, hd, hd_v).startswith("flash_fwd_wide") == wide
    assert "route (a)" in flash_attention.route(torch.float32, hd, hd_v)
    with pytest.raises(ValueError, match="above"):
        flash_attention.attend_padded_value(ref.flash_attention_ref, q[..., :8], k[..., :8], v)


# -- whole model --------------------------------------------------------------------

def test_init_params_has_the_references_tree():
    jcfg, jp, tcfg, _ = both(ARCH)
    got = init_params(tcfg, torch.Generator().manual_seed(0))
    assert shapes(got) == shapes(jp)
    assert "w_dq" in got["dense_blocks"]["attn"] and "w_dq" in got["blocks"]["attn"]


@pytest.mark.parametrize("seq", [12, 40])
def test_forward_logits_are_the_references(seq):
    jcfg, jp, tcfg, tp = both(ARCH)
    toks = tokens(jcfg, (2, seq), seed=seq)
    want = np.asarray(j_forward(jp, jcfg, jnp.asarray(toks)))
    got = forward(tp, tcfg, t(toks).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seq", [9, 30])
def test_prefill_and_decode_are_the_references(seq):
    jcfg, jp, tcfg, tp = both(ARCH, seed=1)
    max_len = 48
    toks = tokens(jcfg, (1, seq), seed=seq)
    jl, jc = j_prefill(jp, jcfg, jnp.asarray(toks), j_init_cache(jcfg, 1, max_len))
    cache = init_cache(tcfg, 1, max_len)
    assert set(cache["layers"]) == {"c_kv", "k_rope"} and set(cache["dense_layers"]) == {"c_kv", "k_rope"}
    tl, tc = prefill(tp, tcfg, t(toks).long(), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tc, to_np(jc))
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = decode_step(tp, tcfg, t(nxt).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tc, to_np(jc))
    # a reference cache carried across continues the same way
    got = decode_step(tp, tcfg, t(nxt).long(), cache_from_jax(to_np(jc)))[0]
    want = j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_decode_continues_the_forward():
    # prefill(S - 1) + decode_step(S-th token) against the reference's
    # forward over S, at a capacity that drops no token (capacity couples
    # the tokens that compete for an expert)
    def no_drops(c):
        import dataclasses

        return c.replace(moe=dataclasses.replace(c.moe, capacity_factor=c.moe.num_experts / c.moe.top_k))

    jcfg, jp, tcfg, tp = both(ARCH, seed=2, cfg_fn=no_drops)
    toks = tokens(jcfg, (2, 14), seed=5)
    want = np.asarray(j_forward(jp, jcfg, jnp.asarray(toks)))[:, -1]
    _, cache = prefill(tp, tcfg, t(toks[:, :-1]).long(), init_cache(tcfg, 2, 16))
    got, _ = decode_step(tp, tcfg, t(toks[:, -1:]).long(), cache)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_engine_greedy_tokens_over_refilled_slots():
    # 5 requests through 2 slots: slots are refilled in place
    jcfg, jp, tcfg, tp = both(ARCH, seed=2)
    prompts, mems = engine_prompts(jcfg, 5)
    want = serve(JServeEngine, JRequest, jcfg, jp, prompts, mems, slots=2)
    got = serve(ServeEngine, Request, tcfg, tp, prompts, mems, slots=2)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3, 4] and all(len(v) == 5 for v in got.values())


def test_serve_cli_gives_the_references_requests():
    # the same prompts drawn in the same order; the weights are each
    # package's own draw, so only the lengths and counts compare
    got, last = cli_requests("repro_torch.launch.serve", ARCH, "--device", "cpu")
    want, want_last = cli_requests("repro.launch.serve", ARCH)
    assert got == want and last == want_last == "served 4 requests"
