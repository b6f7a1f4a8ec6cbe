"""The port's dense-family model path against the JAX reference on the CPU.

Parameters are the reference's ``init_params(cfg, PRNGKey(0))``, handed over
as numpy through ``params_from_jax``; tokens are drawn with numpy. The
SMOKE configs run in float32, so the two packages differ only in the order
of their sums (2 layers, widths of 64–128, a 512-wide head): forward,
prefill (logits and the filled cache) and three decode steps are held to
rtol = atol = 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch import configs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.decode import _write_ring

TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = ["granite_20b", "nemotron_4_340b", "qwen15_110b", "qwen3_4b"]
OTHER = ["deepseek_v2_236b", "mixtral_8x22b", "llama32_vision_90b", "xlstm_1_3b",
         "zamba2_2_7b", "seamless_m4t_medium"]


def _configs(arch, swa=0):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if swa:
        jcfg, tcfg = jcfg.replace(swa_window=swa), tcfg.replace(swa_window=swa)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _t(tokens):
    return torch.from_numpy(np.asarray(tokens)).long()


CASES = [(a, 0) for a in DENSE] + [("qwen3_4b", 8)]
IDS = [a for a in DENSE] + ["qwen3_4b-swa8"]


@pytest.mark.parametrize("arch,swa", CASES, ids=IDS)
def test_forward_matches_reference(arch, swa):
    jcfg, tcfg = _configs(arch, swa)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, (2, 12))
    want = np.asarray(j_forward(jp, jcfg, toks))
    got = forward(tp, tcfg, _t(toks))
    assert got.shape == (2, 12, jcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch,swa", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(arch, swa):
    jcfg, tcfg = _configs(arch, swa)
    jp, tp = _params(jcfg)
    B, S, max_len = 2, 12, 16  # under swa8 the cache is a ring of 8 and prefill wraps
    toks = _tokens(jcfg, (B, S))
    jl, jc = j_prefill(jp, jcfg, toks, j_init_cache(jcfg, B, max_len))
    tl, tc = prefill(tp, tcfg, _t(toks), init_cache(tcfg, B, max_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["len"] == int(jc["len"]) == S
    for name in ("k", "v"):
        assert tc["layers"][name].shape == jc["layers"][name].shape
        np.testing.assert_allclose(tc["layers"][name].numpy(), np.asarray(jc["layers"][name]), **TOL)
    for step in range(3):
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jl, jc = j_decode_step(jp, jcfg, tok, jc)
        tl, tc = decode_step(tp, tcfg, _t(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tc["len"] == int(jc["len"]) == S + step + 1
    np.testing.assert_allclose(tc["layers"]["k"].numpy(), np.asarray(jc["layers"]["k"]), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    # tests/test_archs.py::test_prefill_decode_consistency on the port alone
    cfg = configs.get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 12
    toks = _t(_tokens(cfg, (B, S)))
    full = forward(params, cfg, toks)
    plogits, cache = prefill(params, cfg, toks, init_cache(cfg, B, S + 4))
    np.testing.assert_allclose(plogits.numpy(), full[:, -1].numpy(), rtol=2e-2, atol=2e-2)
    dlogits, cache = decode_step(params, cfg, plogits.argmax(-1)[:, None], cache)
    assert not torch.isnan(dlogits).any()
    assert cache["len"] == S + 1
    # and decode of the last prompt token continues prefill of the others
    _, short = prefill(params, cfg, toks[:, :-1], init_cache(cfg, B, S + 4))
    last, _ = decode_step(params, cfg, toks[:, -1:], short)
    np.testing.assert_allclose(last.numpy(), plogits.numpy(), rtol=1e-5, atol=1e-5)


def test_cache_from_jax_continues_the_reference():
    jcfg, tcfg = _configs("qwen3_4b")
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, (1, 9))
    jl, jc = j_prefill(jp, jcfg, toks, j_init_cache(jcfg, 1, 16))
    tc = cache_from_jax(jax.tree.map(np.asarray, jc))
    assert tc["len"] == 9 and isinstance(tc["len"], int)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    want, _ = j_decode_step(jp, jcfg, tok, jc)
    got, _ = decode_step(tp, tcfg, _t(tok), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_jax_keeps_layout_and_bf16_bits():
    jcfg, _ = _configs("qwen3_4b")
    jp = j_init_params(jcfg.replace(param_dtype="bfloat16"), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    wq = tp["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == (jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.head_dim_)
    assert tuple(tp["blocks"]["attn"]["wo"].shape) == (
        jcfg.n_layers, jcfg.n_heads, jcfg.head_dim_, jcfg.d_model)
    np.testing.assert_array_equal(
        wq.float().numpy(), np.asarray(jp["blocks"]["attn"]["wq"], np.float32))


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_matches_reference_tree(arch):
    # the port draws its own numbers, in the reference's tree and shapes
    jcfg, tcfg = _configs(arch)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), j_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = init_params(tcfg, torch.Generator().manual_seed(0))

    def shapes(tree):
        return {k: shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree.shape)

    assert shapes(tp) == jshapes


def test_write_ring_keeps_the_last_window():
    cache = torch.zeros((1, 4, 1, 1))
    new = torch.arange(10, dtype=torch.float32).reshape(1, 10, 1, 1)
    _write_ring(cache, new)
    # positions 6..9 in slots p % 4
    assert cache.flatten().tolist() == [8.0, 9.0, 6.0, 7.0]


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_configs_are_copies_of_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        got = dataclasses.asdict(getattr(configs, get)(arch))
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        assert got == want


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_name_their_slice(arch):
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="slice"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=cfg.family):
        init_cache(cfg, 1, 8)
