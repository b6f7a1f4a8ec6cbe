"""The port's kernels: plain versions against the reference, wrappers, dispatch.

On the CPU the kernel entry points run the plain PyTorch versions, which
are held here to ``repro.kernels.ref`` and to the Pallas kernels in
interpret mode (as tests/test_kernels.py runs them), at the f32 precedent
of that file (2e-5; 2e-2 for bf16). The CUDA kernels themselves run only
on the card: tests/test_torch_gpu.py (marked ``gpu``) and ``chip_smoke.py``
hold every kernel to its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused import affine_rmsnorm as pallas_affine_rmsnorm
from repro.kernels.fused import map_chain as pallas_map_chain
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import build, fused, kalman, mlstm, ops, ref, rmsnorm, slstm, ssd

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
STAGES = ((2.0, 0.5), (0.7, -0.1))


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _inputs(shape, dtype="float32", seed=0):
    g = np.random.default_rng(seed)
    x32 = g.standard_normal(shape).astype(np.float32) * 3.0
    scale = (1.0 + 0.1 * g.standard_normal(shape[-1:])).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    return xj, xt, jnp.asarray(scale), torch.from_numpy(scale)


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 5), (4, 128), (2, 7, 256), (1, 33, 512)])
def test_rmsnorm_plain_matches_reference(shape, dtype):
    xj, xt, sj, st = _inputs(shape, dtype)
    got = ref.rmsnorm_ref(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(jref.rmsnorm_ref(xj, sj)), **_tol(dtype))
    pallas = pallas_rmsnorm(xj, sj, block_rows=8, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("shape", [(17, 5), (33, 8)])
def test_fused_plain_match_reference(shape):
    xj, xt, sj, st = _inputs(shape, seed=3)
    got_map = ref.map_chain_ref(xt, STAGES)
    got_norm = ref.affine_rmsnorm_ref(xt, st, STAGES)
    np.testing.assert_allclose(_np(got_map), _np(jref.map_chain_ref(xj, STAGES)), **F32_TOL)
    np.testing.assert_allclose(
        _np(got_norm), _np(jref.affine_rmsnorm_ref(xj, sj, STAGES)), **F32_TOL
    )
    pallas_map = pallas_map_chain(xj, stages=STAGES, block_rows=8, interpret=True)
    pallas_norm = pallas_affine_rmsnorm(xj, sj, stages=STAGES, block_rows=8, interpret=True)
    np.testing.assert_allclose(_np(got_map), _np(pallas_map), **F32_TOL)
    np.testing.assert_allclose(_np(got_norm), _np(pallas_norm), **F32_TOL)


# The Pallas kernels take a bf16 x to float32, run the stages and the norm
# there and round once to bf16; so do the plain versions. The two compute
# the same float32 values up to the order of the norm's sum (and any
# contraction into an FMA on XLA's side), so they agree to one rounding of
# bf16: 2**-8 of the value, held at rtol 2**-7 (a bf16 ulp).
BF16_ONE_ROUNDING = dict(rtol=2.0**-7, atol=1e-6)


@pytest.mark.parametrize("shape", [(17, 5), (33, 8), (9, 128)])
def test_fused_plain_in_bf16_match_pallas(shape):
    xj, xt, sj, st = _inputs(shape, "bfloat16", seed=9)
    got_map = ref.map_chain_ref(xt, STAGES)
    got_norm = ref.affine_rmsnorm_ref(xt, st, STAGES)
    assert got_map.dtype == got_norm.dtype == torch.bfloat16
    pallas_map = pallas_map_chain(xj, stages=STAGES, block_rows=8, interpret=True)
    pallas_norm = pallas_affine_rmsnorm(xj, sj, stages=STAGES, block_rows=8, interpret=True)
    np.testing.assert_allclose(_np(got_map), _np(pallas_map), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(got_norm), _np(pallas_norm), **BF16_ONE_ROUNDING)
    # one rounding, not one per product and sum: the float32 stages rounded
    f32 = ref.map_chain_ref(xt.float(), STAGES)
    assert torch.equal(got_map, f32.to(torch.bfloat16))


def test_fused_plain_is_bitwise_the_op_sequence():
    # the contract the CUDA kernels keep on the card, here for the CPU path
    _, xt, _, st = _inputs((64, 8), seed=5)
    view = xt[:, 1:6]  # the stream path's strided view
    y = view
    for s, o in STAGES:
        y = y * s + o
    assert torch.equal(ref.map_chain_ref(view, STAGES), y)
    assert torch.equal(ref.affine_rmsnorm_ref(view, st[:5], STAGES), ref.rmsnorm_ref(y, st[:5]))


def test_rmsnorm_plain_layout_independent():
    _, xt, _, st = _inputs((40, 8), seed=6)
    view = xt[:, 1:6]
    assert torch.equal(ref.rmsnorm_ref(view, st[:5]), ref.rmsnorm_ref(view.contiguous(), st[:5]))


def test_kalman_plain_matches_reference_scan():
    from repro.core.graph import Task
    from repro.ops import operator_for_task

    g = np.random.default_rng(4)
    x = (g.standard_normal((48, 8)) * 5.0).astype(np.float32)
    op = operator_for_task(Task.make("k", "kalman", {"q": 0.3, "r": 1.5}), 48)
    state, y = op.apply(op.init_state(48), jnp.asarray(x))
    vals, xe, p = ref.kalman_scan_ref(
        torch.from_numpy(x)[:, 1:6], torch.zeros(5), torch.ones(5), 0.3, 1.5
    )
    np.testing.assert_allclose(vals.numpy(), np.asarray(y)[:, 1:6], **F32_TOL)
    np.testing.assert_allclose(xe.numpy(), np.asarray(state["x"]), **F32_TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(state["p"]), **F32_TOL)


def test_kalman_plain_empty_batch():
    vals, xe, p = ref.kalman_scan_ref(torch.zeros((0, 5)), torch.zeros(5), torch.ones(5), 0.1, 1.0)
    assert vals.shape == (0, 5) and torch.equal(p, torch.ones(5))


# -- dispatch ---------------------------------------------------------------------


def test_cpu_dispatch_runs_plain_versions_and_counts_no_launch():
    build.reset_launch_counts()
    _, xt, _, st = _inputs((12, 5), seed=8)
    assert torch.equal(ops.rmsnorm(xt, st), ref.rmsnorm_ref(xt, st))
    assert torch.equal(ops.map_chain(xt, stages=STAGES), ref.map_chain_ref(xt, STAGES))
    assert torch.equal(
        ops.affine_rmsnorm(xt, st, stages=STAGES), ref.affine_rmsnorm_ref(xt, st, STAGES)
    )
    got = ops.kalman_scan(xt, torch.zeros(5), torch.ones(5), 0.1, 1.0)
    for a, b in zip(got, ref.kalman_scan_ref(xt, torch.zeros(5), torch.ones(5), 0.1, 1.0)):
        assert torch.equal(a, b)
    ssd_args = (xt.reshape(1, 12, 1, 5), xt[None, :, :1].abs(), -torch.ones(1), xt[None], xt[None])
    for a, b in zip(ops.ssd_scan(*ssd_args, chunk=8), ref.ssd_scan_ref(*ssd_args, 8)):
        assert torch.equal(a, b)
    mlstm_args = (xt.reshape(1, 12, 1, 5),) * 3 + (xt[None, :, :1], xt[None, :, 1:2])
    got, want = ops.mlstm_scan(*mlstm_args, chunk=8), ref.mlstm_scan_ref(*mlstm_args, 8)
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(a, b)
    got, want = ops.slstm_scan(xt[None, :, :4], st[:4].reshape(4, 1, 1, 1)), ref.slstm_scan_ref(
        xt[None, :, :4], st[:4].reshape(4, 1, 1, 1))
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(a, b)
    assert ops.launch_counts() == {name: 0 for name in build.KERNELS}


def test_meta_dispatch_gives_shapes_only():
    z = torch.empty((16384, 5), device="meta")
    vals, xe, p = ops.kalman_scan(z, torch.empty(5, device="meta"), torch.empty(5, device="meta"), 0.1, 1.0)
    assert vals.shape == (16384, 5) and vals.device.type == "meta"
    assert ops.rmsnorm(z, torch.empty(5, device="meta")).shape == (16384, 5)


@pytest.mark.parametrize("call", [
    lambda x, s: rmsnorm.rmsnorm(x, s),
    lambda x, s: fused.map_chain(x, STAGES),
    lambda x, s: fused.affine_rmsnorm(x, s, STAGES),
    lambda x, s: kalman.kalman_scan(x, s, s, 0.1, 1.0),
    lambda x, s: ssd.ssd_scan(x[None, :, None], x[None, :, :1], s[:1], x[None], x[None], chunk=4),
    lambda x, s: mlstm.mlstm_scan(*[x[None, :, None]] * 3, x[None, :, :1], x[None, :, :1], chunk=4),
    lambda x, s: slstm.slstm_scan(x[None, :, :4], s[:4].reshape(4, 1, 1, 1)),
], ids=["rmsnorm", "map_chain", "affine_rmsnorm", "kalman_scan", "ssd_scan", "mlstm_scan",
        "slstm_scan"])
def test_cuda_wrappers_reject_cpu_tensors(call):
    # a CUDA wrapper launches on CUDA tensors or raises; it has no CPU fallback
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros((4, 5)), torch.ones(5))


def test_stage_count_is_bounded():
    with pytest.raises(ValueError, match="at most"):
        fused._stage_arrays([(1.0, 0.0)] * (fused.MAX_STAGES + 1))


def test_build_is_lazy_and_keyed_by_source():
    # importing the kernels built nothing; the build key covers every source
    assert build._lib is None
    names = [p.rsplit("/", 1)[-1] for p in build.sources()]
    assert names == [
        "decode_attention.cu", "flash_attention.cu", "fused.cu", "kalman.cu", "mlstm.cu",
        "rmsnorm.cu", "slstm.cu", "ssd.cu",
    ]
    assert len(build._digest()) == 16


# -- K5/K6 at head dims the kernels are not built for ------------------------------------


def _attn_pair(g, shape, dtype):
    x = g.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [24, 96])
def test_attention_plain_at_unbuilt_head_dims_matches_pallas(hd, dtype):
    """The plain versions at head dims 24 and 96 against the Pallas kernels
    in interpret mode, and the padded route the CUDA wrappers take (zero
    columns up to the next built head dim, the true head dim's scale, the
    padding sliced off) computes the same function."""
    from repro.kernels.decode_attention import decode_attention as pallas_decode
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    from repro_torch.kernels.flash_attention import pad_head_dim, padded_head_dim

    g = np.random.default_rng(hd)
    b, s, h, kv = 1, 96, 4, 2
    qj, qt = _attn_pair(g, (b, s, h, hd), dtype)
    kj, kt = _attn_pair(g, (b, s, kv, hd), dtype)
    vj, vt = _attn_pair(g, (b, s, kv, hd), dtype)
    width = padded_head_dim(hd)
    assert width == {24: 32, 96: 128}[hd]
    qp, kp, vp = pad_head_dim((qt, kt, vt), width)
    assert qp.shape[-1] == width and not qp[..., hd:].any()

    got = ref.flash_attention_ref(qt, kt, vt, causal=True)
    pal = pallas_flash(qj, jnp.repeat(kj, h // kv, axis=2), jnp.repeat(vj, h // kv, axis=2),
                       causal=True, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pal), **_tol(dtype))
    padded = ref.flash_attention_ref(qp, kp, vp, causal=True, scale=hd ** -0.5)
    np.testing.assert_allclose(_np(padded[..., :hd]), _np(got), **_tol(dtype))
    assert not padded[..., hd:].any()

    clen = 70
    got = ref.decode_attention_ref(qt[:, :1], kt, vt, clen)
    pal = pallas_decode(qj[:, :1], kj, vj, jnp.asarray(clen, jnp.int32), block_s=64,
                        interpret=True)
    np.testing.assert_allclose(_np(got), _np(pal), **_tol(dtype))
    padded = ref.decode_attention_ref(qp[:, :1], kp, vp, clen, scale=hd ** -0.5)
    np.testing.assert_allclose(_np(padded[..., :hd]), _np(got), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [256, 320])
def test_attention_plain_above_the_built_head_dims_matches_pallas(hd, dtype):
    """The plain versions at head dims 256 (Gemma-class) and 320 (no
    multiple of 64: the pieces kernel's last piece is ragged), which the
    CUDA wrappers run through the pieces kernel unpadded, against the Pallas
    kernels in interpret mode: causal, a window, GQA, and decode with and
    without a window."""
    from repro.kernels.decode_attention import decode_attention as pallas_decode
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    from repro_torch.kernels.flash_attention import PIECES_KERNEL, route

    assert route(getattr(torch, dtype), hd) == PIECES_KERNEL
    g = np.random.default_rng(hd + 1)
    b, s, h, kv = 1, 128, 2, 1
    qj, qt = _attn_pair(g, (b, s, h, hd), dtype)
    kj, kt = _attn_pair(g, (b, s, kv, hd), dtype)
    vj, vt = _attn_pair(g, (b, s, kv, hd), dtype)
    kr, vr = jnp.repeat(kj, h // kv, axis=2), jnp.repeat(vj, h // kv, axis=2)
    for window in (0, 48):
        got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
        pal = pallas_flash(qj, kr, vr, causal=True, window=window, block_q=64, block_k=64,
                           interpret=True)
        np.testing.assert_allclose(_np(got), _np(pal), **_tol(dtype))
        clen = 100
        got = ops.decode_attention(qt[:, :1], kt, vt, clen, window=window)
        pal = pallas_decode(qj[:, :1], kj, vj, jnp.asarray(clen, jnp.int32), block_s=64,
                            window=window, interpret=True)
        np.testing.assert_allclose(_np(got), _np(pal), **_tol(dtype))


def test_built_head_dims_take_no_padding_copy():
    from repro_torch.kernels.flash_attention import HEAD_DIMS, pad_head_dim, padded_head_dim

    for hd in HEAD_DIMS:
        assert padded_head_dim(hd) == hd
        ts = tuple(torch.zeros((1, 2, 1, hd)) for _ in range(3))
        assert all(a is b for a, b in zip(pad_head_dim(ts, hd), ts))
    assert [padded_head_dim(hd) for hd in (1, 17, 65, 81, 129, 191)] == [16, 32, 80, 128, 192, 192]
    # above the largest built head dim no padding applies: the wrappers take
    # the pieces kernel there (test_attention_plain_above_the_built_head_dims...)
    with pytest.raises(ValueError, match="above 192"):
        padded_head_dim(193)


# -- the ssm scans' launch plans (csrc/slstm.cu, csrc/mlstm.cu) ----------------------------


@pytest.mark.parametrize("hd,dtype,want", [
    (512, torch.bfloat16, (16, 32, True, 21632)),   # xlstm-1.3b: R^T in registers
    (512, torch.float32, (16, 32, False, 16512)),   # R in f32: streamed into f32 FMAs
    (1024, torch.bfloat16, (16, 64, False, 32896)),
    (16, torch.bfloat16, (1, 16, True, 2432)),
    (40, torch.float32, (2, 20, False, 8960)),
])
def test_slstm_plan(hd, dtype, want):
    pl = slstm.plan(hd, dtype)
    assert (pl.cluster, pl.cols, pl.tensor, pl.smem) == want


def test_slstm_plan_covers_every_column_with_no_empty_block():
    for hd in range(1, slstm.MAX_HEAD_DIM + 1):
        pl = slstm.plan(hd, torch.bfloat16)
        assert pl.cluster <= slstm.MAX_CLUSTER and pl.cols <= 64
        assert (pl.cluster - 1) * pl.cols < hd <= pl.cluster * pl.cols
        assert pl.tensor == (hd <= 512) and (not pl.tensor or pl.cols <= 32)
        assert not slstm.plan(hd, torch.float32).tensor
    with pytest.raises(ValueError, match="head dim"):
        slstm.plan(slstm.MAX_HEAD_DIM + 1, torch.bfloat16)


def test_mlstm_plan():
    # 32 rows of C a block where the f32 tile and the staged tiles fit, else 16
    assert [mlstm.rows_per_block(1024, d) for d in (torch.bfloat16, torch.float32)] == [32, 32]
    assert [mlstm.rows_per_block(2048, d) for d in (torch.bfloat16, torch.float32)] == [16, 16]
    assert mlstm.rows_per_block(8, torch.float32) == 32
    assert mlstm.carry_smem(1024, 32, torch.bfloat16) == 195080
    assert mlstm.carry_smem(1024, 32, torch.float32) == 217096 <= mlstm.MAX_SMEM
    assert mlstm.n_blocks(1024) == 8 and mlstm.n_blocks(40) == 1
    assert mlstm.launch_plan(1, 2048, 4, 1024, 64, torch.bfloat16).startswith(
        "3 launches per call: 128 chunk blocks; 256 blocks for n (128 columns x 4 chunks each); "
        "128 blocks of 32 rows of C over tiles of 128 columns")
    with pytest.raises(ValueError, match="above 3072"):
        mlstm.rows_per_block(4096, torch.bfloat16)
    assert mlstm.rows_per_block(2816, torch.bfloat16) == 16
    with pytest.raises(ValueError, match="do not fit"):
        mlstm.rows_per_block(2880, torch.bfloat16)
