"""The port's model-serving kernels (K4 rmsnorm_residual, K5 flash_attention,
K6 decode_attention): plain versions against the reference, wrappers, dispatch.

The plain versions are held to ``repro.kernels.ref`` and to the Pallas
kernels in interpret mode, with the parameter sets of tests/test_kernels.py
(``block_q = block_k = block_s = 64``, ``block_rows = 8``) and its
tolerances: 2e-5 in float32, 2e-2 in bfloat16. Inputs are drawn with numpy
from a seed and handed to both packages. The CUDA kernels themselves run on
the card only: tests/test_torch_gpu.py and ``chip_smoke.py`` hold them to
these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm_residual as pallas_rmsnorm_residual
from repro_torch.kernels import build, decode_attention, flash_attention, ops, ref, rmsnorm

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _pair(g, shape, dtype, scale=1.0):
    """The same numbers as a jax array and a torch tensor of ``dtype``."""
    x = (g.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float32)


# -- K4 rmsnorm_residual ---------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 17, 256), (4, 128), (1, 33, 512), (3, 5)])
def test_rmsnorm_residual_plain_matches_reference(shape, dtype):
    g = np.random.default_rng(3)
    xj, xt = _pair(g, shape, dtype)
    rj, rt = _pair(g, shape, dtype)
    s = (1.0 + 0.1 * g.standard_normal(shape[-1:])).astype(np.float32)
    sj, st = jnp.asarray(s), torch.from_numpy(s)
    got_n, got_a = ref.rmsnorm_residual_ref(xt, rt, st)
    assert got_n.dtype == xt.dtype and got_a.dtype == xt.dtype and got_n.shape == xt.shape
    want_n, want_a = jref.rmsnorm_residual_ref(xj, rj, sj)
    pal_n, pal_a = pallas_rmsnorm_residual(xj, rj, sj, block_rows=8, interpret=True)
    for want in (want_a, pal_a):
        np.testing.assert_allclose(_np(got_a), _np(want), **_tol(dtype))
    for want in (want_n, pal_n):
        np.testing.assert_allclose(_np(got_n), _np(want), **_tol(dtype))


def test_rmsnorm_residual_plain_norms_the_f32_sum():
    # as the Pallas kernel: the norm sees x + res in float32, not the rounded sum
    g = np.random.default_rng(4)
    _, xt = _pair(g, (8, 64), "bfloat16")
    _, rt = _pair(g, (8, 64), "bfloat16")
    st = torch.ones(64)
    normed, added = ref.rmsnorm_residual_ref(xt, rt, st)
    assert torch.equal(added, (xt.float() + rt.float()).to(torch.bfloat16))
    assert torch.equal(normed, ref.rmsnorm_ref(xt.float() + rt.float(), st).to(torch.bfloat16))


# -- K5 flash_attention ------------------------------------------------------------

FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 64, 64, 4, 2, 32, True, 0),      # GQA
    (1, 96, 96, 2, 1, 64, True, 0),       # MQA, ragged seq vs block
    (1, 128, 128, 2, 2, 64, False, 0),    # bidirectional (encoder)
    (1, 256, 256, 2, 2, 64, True, 64),    # sliding window
    (2, 33, 77, 2, 2, 16, False, 0),      # cross-attn-like, unaligned
    (1, 80, 80, 8, 2, 128, True, 0),      # qwen3's head dim and groups of 4
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_reference(b, sq, sk, h, kv, hd, causal, window, dtype):
    g = np.random.default_rng(0)
    qj, qt = _pair(g, (b, sq, h, hd), dtype)
    kj, kt = _pair(g, (b, sk, kv, hd), dtype)
    vj, vt = _pair(g, (b, sk, kv, hd), dtype)
    got = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    groups = h // kv
    pal = pallas_flash(
        qj, jnp.repeat(kj, groups, axis=2), jnp.repeat(vj, groups, axis=2),
        causal=causal, window=window, block_q=64, block_k=64, interpret=True,
    )
    np.testing.assert_allclose(_np(got), _np(pal), **_tol(dtype))


def test_flash_attention_plain_takes_kv_heads_natively():
    # q head h reads kv head h // (H // KV): the same as repeating each kv head
    g = np.random.default_rng(1)
    _, qt = _pair(g, (1, 20, 6, 16), "float32")
    _, kt = _pair(g, (1, 20, 2, 16), "float32")
    _, vt = _pair(g, (1, 20, 2, 16), "float32")
    native = ref.flash_attention_ref(qt, kt, vt)
    repeated = ref.flash_attention_ref(qt, kt.repeat_interleave(3, 2), vt.repeat_interleave(3, 2))
    torch.testing.assert_close(native, repeated, rtol=0, atol=1e-6)


# -- K6 decode_attention -------------------------------------------------------------

DECODE_CASES = [
    (2, 128, 100, 4, 4, 64, 0),
    (2, 128, 128, 4, 2, 64, 0),    # GQA
    (1, 256, 200, 8, 1, 32, 0),    # MQA
    (1, 256, 250, 4, 2, 64, 64),   # sliding window
    (3, 96, 1, 2, 2, 16, 0),       # first decode step
    (1, 192, 130, 8, 2, 128, 0),   # qwen3's head dim and groups of 4
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,smax,clen,h,kv,hd,window", DECODE_CASES)
def test_decode_attention_plain_matches_reference(b, smax, clen, h, kv, hd, window, dtype):
    g = np.random.default_rng(1)
    qj, qt = _pair(g, (b, 1, h, hd), dtype)
    kj, kt = _pair(g, (b, smax, kv, hd), dtype)
    vj, vt = _pair(g, (b, smax, kv, hd), dtype)
    got = ref.decode_attention_ref(qt, kt, vt, clen, window=window)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    cl = jnp.asarray(clen, jnp.int32)
    want = jref.decode_attention_ref(qj, kj, vj, cl, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    pal = pallas_decode(qj, kj, vj, cl, window=window, block_s=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pal), **_tol(dtype))


def test_decode_attention_plain_empty_cache_is_a_zero_row():
    # no valid position: l = 0 gives zeros, as the kernel gives, not NaN
    g = np.random.default_rng(2)
    _, qt = _pair(g, (1, 1, 4, 16), "float32")
    _, kt = _pair(g, (1, 32, 2, 16), "float32")
    out = ref.decode_attention_ref(qt, kt, kt, 0)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("lo,hi,blocks,sms", [
    (0, 2048, 8, 132), (0, 1, 8, 132), (0, 0, 8, 132), (186, 250, 2, 132),
    (0, 4096, 1, 132), (5, 6, 64, 132), (0, 100, 1000, 132),
    (0, 2048, 32, 132), (0, 63, 8, 132), (0, 65, 8, 132), (1948, 2048, 32, 132),
    (0, 4000, 48, 132),
])
def test_decode_split_plan_covers_the_valid_range(lo, hi, blocks, sms):
    chunk, splits = decode_attention.split_plan(lo, hi, blocks, sms)
    base = lo // decode_attention.TILE * decode_attention.TILE
    assert chunk % decode_attention.TILE == 0 and splits >= 1
    assert base + splits * chunk >= hi  # every valid position falls in a split
    assert base + (splits - 1) * chunk < max(hi, base + 1)  # and no split starts past the end
    assert blocks * splits <= max(blocks, decode_attention.BLOCKS_PER_SM * sms + blocks)
    # split s reads [base + s * chunk, + chunk) clipped to [lo, hi), as the kernel
    # does: each valid position once, and no split block idle where any is valid
    ranges = [(max(lo, base + s * chunk), min(hi, base + (s + 1) * chunk)) for s in range(splits)]
    assert [p for start, end in ranges for p in range(start, end)] == list(range(lo, hi))
    assert hi <= lo or all(end > start for start, end in ranges)


# -- dispatch and wrappers -------------------------------------------------------------


def test_cpu_dispatch_runs_plain_versions_and_counts_no_launch():
    build.reset_launch_counts()
    g = np.random.default_rng(5)
    _, x = _pair(g, (3, 7, 64), "float32")
    _, r = _pair(g, (3, 7, 64), "float32")
    s = torch.ones(64)
    for a, b in zip(ops.rmsnorm_residual(x, r, s), ref.rmsnorm_residual_ref(x, r, s)):
        assert torch.equal(a, b)
    _, q = _pair(g, (1, 9, 4, 16), "float32")
    _, k = _pair(g, (1, 9, 2, 16), "float32")
    assert torch.equal(ops.flash_attention(q, k, k, window=4),
                       ref.flash_attention_ref(q, k, k, window=4))
    assert torch.equal(ops.decode_attention(q[:, :1], k, k, 5),
                       ref.decode_attention_ref(q[:, :1], k, k, 5))
    assert ops.launch_counts() == {name: 0 for name in build.KERNELS}


@pytest.mark.parametrize("call", [
    lambda t: rmsnorm.rmsnorm_residual(t, t, torch.ones(16)),
    lambda t: flash_attention.flash_attention(t, t, t),
    lambda t: decode_attention.decode_attention(t[:, :1], t, t, 2),
], ids=["rmsnorm_residual", "flash_attention", "decode_attention"])
def test_cuda_wrappers_reject_cpu_tensors(call):
    # a CUDA wrapper launches on CUDA tensors or raises; it has no CPU fallback
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros((1, 4, 2, 16)))


def test_model_kernels_are_registered():
    for name in ("rmsnorm_residual", "flash_attention", "decode_attention"):
        assert name in build.KERNELS
        assert f"rt_{name}" in build._SIGNATURES
    names = [p.rsplit("/", 1)[-1] for p in build.sources()]
    assert {"flash_attention.cu", "decode_attention.cu", "rmsnorm.cu"} <= set(names)
