"""The port's Mamba2 path (K7's plain version, ``ssd_chunked``, the Mamba
block, its prefill and its decode) against the JAX reference on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
model tests take the reference's ``init_params`` of the zamba2 SMOKE
config through ``params_from_jax``.

Tolerances, each relative to the largest |value| compared:
  * float32, 2e-5: the port and the reference compute the same float32
    chunked scan and differ only in the order of their sums (observed
    ≤ 4e-6 of the largest value, which reaches ~180 over 256 steps);
  * bfloat16 inputs against the Pallas kernel, 2e-5: both take the inputs
    to float32 before any product;
  * bfloat16 inputs against the jnp reference, tests/test_kernels.py's
    bf16 tolerance (rtol 5e-2, atol 1e-1): the jnp scan forms C·Bᵀ in
    bfloat16, the port (as the Pallas kernel) in float32;
  * the Mamba block, prefill and decode in float32, 2e-5: the same
    float32 math through a projection, a conv and an RMSNorm of 64–128
    wide rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_scan as pallas_ssd
from repro.models import init_params as j_init_params
from repro.models.decode import _mamba_prefill as j_mamba_prefill
from repro.models.ssm import mamba_block as j_mamba_block
from repro.models.ssm import mamba_decode as j_mamba_decode
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref
from repro_torch.models.decode import _mamba_prefill
from repro_torch.models.ssm import mamba_block, mamba_decode, mamba_init_cache, ssd_chunked

F32_REL = 2e-5
BF16_REF_TOL = dict(rtol=5e-2, atol=1e-1)  # tests/test_kernels.py's bf16 tolerance
KERNEL_SHAPES = [  # tests/test_kernels.py:115-123
    (1, 64, 2, 32, 16, 16),
    (2, 128, 4, 64, 64, 32),
    (1, 256, 2, 64, 128, 128),
]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float32)


def _assert_rel(got, want, rel=F32_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    limit = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= limit, f"max |err| {err} above {limit} ({rel} of max |want|)"


def _ssd_inputs(b, s, nh, p, n, seed=7):
    g = np.random.default_rng(seed)
    return dict(
        xh=g.standard_normal((b, s, nh, p)).astype(np.float32),
        dt=np.log1p(np.exp(g.standard_normal((b, s, nh)))).astype(np.float32),
        a=-np.exp(0.5 * g.standard_normal(nh)).astype(np.float32),
        B=g.standard_normal((b, s, n)).astype(np.float32),
        C=g.standard_normal((b, s, n)).astype(np.float32),
        h0=g.standard_normal((b, nh, n, p)).astype(np.float32),
    )


def _jax_args(d, dtype):
    lo = lambda v: jnp.asarray(v).astype(jnp.dtype(dtype))  # noqa: E731
    return lo(d["xh"]), jnp.asarray(d["dt"]), jnp.asarray(d["a"]), lo(d["B"]), lo(d["C"])


def _torch_args(d, dtype):
    lo = lambda v: torch.from_numpy(v).to(getattr(torch, dtype))  # noqa: E731
    return lo(d["xh"]), torch.from_numpy(d["dt"]), torch.from_numpy(d["a"]), lo(d["B"]), lo(d["C"])


# -- K7's plain version ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,p,n,chunk", KERNEL_SHAPES)
def test_ssd_scan_plain_matches_pallas_and_reference(b, s, nh, p, n, chunk, dtype):
    d = _ssd_inputs(b, s, nh, p, n)
    got_y, got_h = ref.ssd_scan_ref(*_torch_args(d, dtype), chunk)
    assert got_y.dtype == got_h.dtype == torch.float32
    pal_y, pal_h = pallas_ssd(*_jax_args(d, dtype), chunk=chunk, interpret=True)
    _assert_rel(got_y, pal_y)
    _assert_rel(got_h, pal_h)
    want_y, want_h = jref.ssd_scan_ref(*_jax_args(d, dtype), chunk=chunk)
    if dtype == "float32":
        _assert_rel(got_y, want_y)
        _assert_rel(got_h, want_h)
    else:
        np.testing.assert_allclose(_np(got_y), _np(want_y), **BF16_REF_TOL)
        np.testing.assert_allclose(_np(got_h), _np(want_h), **BF16_REF_TOL)


@pytest.mark.parametrize("dtype,chunk,n,p", [
    ("float32", 128, 128, 128),   # the SIMT build does not fit: the tiled build on the card
    ("float32", 256, 192, 160),   # chunk, N and P above 128: the tiled build
    ("bfloat16", 256, 192, 160),  # beyond the tensor-core build's tiles: the tiled build
])
def test_ssd_scan_plain_at_the_tiled_builds_shapes_matches_pallas(dtype, chunk, n, p):
    """K7's plain version at the shapes only the tiled build takes on the
    card, against the Pallas kernel in interpret mode (whose only limit is
    S % chunk == 0): B 1, 2 heads, S 512."""
    d = _ssd_inputs(1, 512, 2, p, n, seed=chunk + n)
    got_y, got_h = ref.ssd_scan_ref(*_torch_args(d, dtype), chunk)
    pal_y, pal_h = pallas_ssd(*_jax_args(d, dtype), chunk=chunk, interpret=True)
    _assert_rel(got_y, pal_y)
    _assert_rel(got_h, pal_h)


@pytest.mark.parametrize("s,chunk", [(37, 8), (100, 32), (7, 16), (1, 8)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_masks_a_ragged_chunk(s, chunk, with_h0):
    # the reference shrinks the chunk to a divisor of S (37 → 1, 100 → 25);
    # the port keeps it and masks the ragged last chunk
    d = _ssd_inputs(2, s, 3, 32, 16, seed=s)
    h0 = d["h0"] if with_h0 else None
    want_y, want_h = j_ssd_chunked(*_jax_args(d, "float32"), chunk=chunk,
                                   h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = ssd_chunked(*_torch_args(d, "float32"), chunk=chunk,
                               h0=None if h0 is None else torch.from_numpy(h0))
    assert tuple(got_y.shape) == (2, s, 3, 32)
    _assert_rel(got_y, want_y)
    _assert_rel(got_h, want_h)


# -- the Mamba block on the zamba2 SMOKE config -------------------------------------


def _mixer(seed=0, layer=1):
    jcfg = jconfigs.get_smoke_config("zamba2_2_7b")
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    jm = jax.tree.map(lambda a: a[layer], jp["mamba_blocks"]["mixer"])
    tm = params_from_jax(jax.tree.map(np.asarray, jm))
    return jcfg, configs.get_smoke_config("zamba2_2_7b"), jm, tm


def _x(cfg, shape, seed=3):
    x = np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("s", [12, 37])
def test_mamba_block_matches_reference(s):
    jcfg, tcfg, jm, tm = _mixer()
    xj, xt = _x(jcfg, (2, s))
    _assert_rel(mamba_block(tm, xt, tcfg), j_mamba_block(jm, xj, jcfg))


@pytest.mark.parametrize("s", [2, 3, 12, 37])
def test_mamba_prefill_fills_the_cache_as_the_reference(s):
    jcfg, tcfg, jm, tm = _mixer()
    xj, xt = _x(jcfg, (2, s))
    want_y, want_cl = j_mamba_prefill(jm, xj, jcfg)
    cl = mamba_init_cache(tcfg, 2, torch.float32, "cpu")
    cl["conv"].fill_(7.0)  # stale entries of an earlier prompt: overwritten, never read
    cl["h"].fill_(7.0)
    got_y = _mamba_prefill(tm, xt, tcfg, cl)
    _assert_rel(got_y, want_y)
    _assert_rel(cl["h"], want_cl["h"])
    k = tcfg.ssm.d_conv - 1
    rows = min(s, k)  # the reference keeps only the prompt's rows of the tail
    _assert_rel(cl["conv"][:, k - rows :], want_cl["conv"])
    assert torch.equal(cl["conv"][:, : k - rows], torch.zeros_like(cl["conv"][:, : k - rows]))


def test_mamba_decode_continues_the_reference():
    jcfg, tcfg, jm, tm = _mixer()
    xj, xt = _x(jcfg, (2, 9))
    _, jcl = j_mamba_prefill(jm, xj, jcfg)
    cl = mamba_init_cache(tcfg, 2, torch.float32, "cpu")
    _mamba_prefill(tm, xt, tcfg, cl)
    conv, h = cl["conv"], cl["h"]
    for step in range(3):
        xj1, xt1 = _x(jcfg, (2, 1), seed=10 + step)
        want, jcl = j_mamba_decode(jm, xj1, jcl, jcfg)
        got, out_cl = mamba_decode(tm, xt1, cl, tcfg)
        assert out_cl["conv"] is conv and out_cl["h"] is h  # written in place
        _assert_rel(got, want)
        _assert_rel(cl["conv"], jcl["conv"])
        _assert_rel(cl["h"], jcl["h"])
