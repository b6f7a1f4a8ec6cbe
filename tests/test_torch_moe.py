"""The port's moe family (``repro_torch.models.mlp``'s MoE, the moe branches
of ``transformer.py`` and ``decode.py``) against the JAX reference on the
CPU.

Parameters are the reference's, handed over through ``params_from_jax``;
inputs are drawn with numpy. Everything runs in float32, where the two
packages differ only in the order of their sums:

  * ``moe_layer`` within 1e-5, on the reference's routing and on a routing
    skewed so that most tokens want the same two experts, where the same
    (token, choice) pairs are dropped at capacity; the sparse decode path
    (``MOE_DECODE = "sparse"``) and ``moe_aux_loss``;
  * mixtral-8x22b SMOKE: the parameter tree's keys and shapes, ``forward``
    logits within 1e-5 past its 16-token window, prefill (logits and the
    filled ring cache) and decode steps, and ``ServeEngine``'s greedy
    tokens over refilled slots with prompts longer than the window;
  * deepseek-v2 SMOKE with ``mla=None`` (``first_k_dense`` dense layers and
    a shared expert) the same way; with MLA in ``tests/test_torch_mla.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import mlp as j_mlp
from repro.models import prefill as j_prefill
from repro.models.common import KeyGen
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import decode_step, forward, init_cache, init_params, mlp, prefill
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
MIXTRAL = "mixtral-8x22b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer(jcfg, seed=0):
    """One MoE layer's parameters in both packages."""
    jp = j_mlp.moe_params(KeyGen(jax.random.PRNGKey(seed)), jcfg, jnp.float32)
    return jp, params_from_jax(_np(jp))


def _skew(jp, x, strength=4.0):
    """Router weights and inputs that send most tokens to experts 0 and 1."""
    d = x.shape[-1]
    v = np.random.default_rng(3).standard_normal(d).astype(np.float32)
    v /= np.linalg.norm(v)
    x = x + 2.0 * v
    router = np.array(jp["router"])
    router[:, 0] += strength * v
    router[:, 1] += 0.8 * strength * v
    return dict(jp, router=jnp.asarray(router)), x


def _ref_kept(jp, x, jcfg):
    """The reference's routing of x: expert ids and which choices it keeps."""
    m = jcfg.moe
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    T = xt.shape[0]
    C = max(int(T * m.top_k / m.num_experts * m.capacity_factor), 4)
    pos = j_mlp._positions_within_group(idx.reshape(-1), m.num_experts)
    return np.asarray(idx), np.asarray(pos < C)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("skewed", [False, True], ids=["balanced", "skewed"])
@pytest.mark.parametrize("shape", [(2, 24), (1, 7)])
def test_moe_layer_is_the_references(activation, skewed, shape):
    jcfg = jconfigs.get_smoke_config(MIXTRAL).replace(activation=activation)
    tcfg = configs.get_smoke_config(MIXTRAL).replace(activation=activation)
    jp, _ = _layer(jcfg)
    x = np.random.default_rng(1).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    if skewed:
        jp, x = _skew(jp, x)
    tp = params_from_jax(_np(jp))
    want = np.asarray(j_mlp.moe_layer(jp, jnp.asarray(x), jcfg))
    got = mlp.moe_layer(tp, _t(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the same (token, choice) pairs routed, and the same ones dropped
    idx, kept = _ref_kept(jp, x, jcfg)
    _, _, tidx = mlp._route(tp, _t(x).reshape(-1, x.shape[-1]), tcfg.moe.top_k)
    _, tkept = mlp.dispatch(tcfg, tidx)
    assert np.array_equal(tidx.numpy(), idx)
    assert np.array_equal(tkept.numpy(), kept)
    if skewed and shape[1] > 7:
        assert not kept.all()  # capacity drops tokens
        # a token whose two choices were both dropped adds nothing, in both
        dropped = ~kept.reshape(-1, 2).any(-1)
        assert dropped.any() and not np.abs(got.reshape(-1, got.shape[-1])[dropped]).any()


@pytest.mark.parametrize("n", [1, 8, 100])
def test_positions_within_group_is_the_references(n):
    flat = np.random.default_rng(n).integers(0, 5, n).astype(np.int32)
    want = np.asarray(j_mlp._positions_within_group(jnp.asarray(flat), 5))
    got = mlp._positions_within_group(torch.from_numpy(flat).long(), 5).numpy()
    assert np.array_equal(got, want)


def test_sparse_decode_and_aux_loss_are_the_references(monkeypatch):
    jcfg = jconfigs.get_smoke_config("deepseek-v2-236b")
    tcfg = configs.get_smoke_config("deepseek-v2-236b")
    jp, tp = _layer(jcfg, seed=4)
    x = np.random.default_rng(2).standard_normal((2, jcfg.d_model)).astype(np.float32)
    want = np.asarray(j_mlp._moe_decode_sparse(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(mlp._moe_decode_sparse(tp, _t(x), tcfg).numpy(), want, **TOL)
    # through moe_layer: one token, T·K <= E, under the sparse switch
    monkeypatch.setattr(j_mlp, "MOE_DECODE", "sparse")
    monkeypatch.setattr(mlp, "MOE_DECODE", "sparse")
    x1 = x[:1, None]
    want = np.asarray(j_mlp.moe_layer(jp, jnp.asarray(x1), jcfg))
    np.testing.assert_allclose(mlp.moe_layer(tp, _t(x1), tcfg).numpy(), want, **TOL)
    xs = np.random.default_rng(5).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    want = float(j_mlp.moe_aux_loss(jp, jnp.asarray(xs), jcfg))
    got = float(mlp.moe_aux_loss(tp, _t(xs), tcfg))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


# -- whole models ---------------------------------------------------------------------

def _deepseek_gqa():
    return (dataclasses.replace(jconfigs.get_smoke_config("deepseek-v2-236b"), mla=None),
            dataclasses.replace(configs.get_smoke_config("deepseek-v2-236b"), mla=None))


def _models(arch):
    if arch == "deepseek-gqa":
        return _deepseek_gqa()
    return jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)


MODELS = [MIXTRAL, "deepseek-gqa"]


def _both(arch, seed=0):
    jcfg, tcfg = _models(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, params_from_jax(_np(jp))


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", MODELS)
def test_init_params_has_the_references_tree(arch):
    jcfg, tcfg = _models(arch)
    want = _shapes(jax.eval_shape(lambda k: j_init_params(jcfg, k), jax.random.PRNGKey(0)))
    got = _shapes(init_params(tcfg, torch.Generator().manual_seed(0)))
    assert got == want


@pytest.mark.parametrize("arch", MODELS)
@pytest.mark.parametrize("seq", [12, 40])
def test_forward_logits_are_the_references(arch, seq):
    jcfg, jp, tcfg, tp = _both(arch)
    toks = np.random.default_rng(seq).integers(0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    want = np.asarray(j_forward(jp, jcfg, jnp.asarray(toks)))
    got = forward(tp, tcfg, _t(toks).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _assert_cache_close(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key == "len":
            assert got["len"] == int(w)
        elif isinstance(w, dict):
            _assert_cache_close(got[key], w)
        else:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", MODELS)
@pytest.mark.parametrize("seq", [9, 30])
def test_prefill_and_decode_are_the_references(arch, seq):
    jcfg, jp, tcfg, tp = _both(arch, seed=1)
    max_len = 48
    toks = np.random.default_rng(seq).integers(0, jcfg.vocab_size, (1, seq)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, jnp.asarray(toks), j_init_cache(jcfg, 1, max_len))
    tl, tc = prefill(tp, tcfg, _t(toks).long(), init_cache(tcfg, 1, max_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, _np(jc))
    for step in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = decode_step(tp, tcfg, _t(nxt).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, _np(jc))
    # a reference cache carried across continues the same way
    got = decode_step(tp, tcfg, _t(nxt).long(), cache_from_jax(_np(jc)))[0]
    want = j_decode_step(jp, jcfg, jnp.asarray(nxt), jc)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _serve(engine_cls, request_cls, cfg, params, prompts, *, slots, max_new=5):
    eng = engine_cls(cfg, params, slots=slots, max_len=64)
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid, p, max_new=max_new))
    return {r.rid: r.tokens for r in eng.run()}


@pytest.mark.parametrize("arch", MODELS)
def test_engine_greedy_tokens_over_refilled_slots(arch):
    # 5 requests through 2 slots, prompts past mixtral's 16-token window, so
    # slots are refilled in place and the ring cache wraps
    jcfg, jp, tcfg, tp = _both(arch, seed=2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (23, 5, 37, 17, 12)]
    want = _serve(JServeEngine, JRequest, jcfg, jp, prompts, slots=2)
    got = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=2)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3, 4] and all(len(t) == 5 for t in got.values())

