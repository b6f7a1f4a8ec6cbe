"""K5's backward at head dim 192 and with v's own head dim, on the CPU.

* The plain version ``ref.flash_attention_bwd_ref``, the yardstick the
  card's kernel (``csrc/flash_attention_bwd.cu``) is held to, against
  ``jax.vjp`` of the reference's ``chunked_attention``, the function that
  the reference's nemotron-4-340b and deepseek-v2 (MLA) layers train
  through: hd 192 with a GQA group of 12 (nemotron's 96 over 8, cut to 12
  over 1 and 24 over 2), and q/k 192 against v 128 at MLA's scale
  (192 ** -0.5), causal and windowed, f32, each gradient within 1e-4 of its
  largest |value| (the two sum in another order).
* The host plan of the backward: each build's shared memory a block within
  the card's 232448 bytes, the launch plan pinned at the two full shapes.
* The wrapper's dispatch through stand-ins for the CUDA calls (the library
  records what it is given): (192, 192) and (192, 128) reach their own
  builds, v, o and dO unpadded at (192, 128); unbuilt pairs are padded;
  above 192 it raises; ``with_lse`` on route (a) returns the padded call's
  log-sum-exp.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attention
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

REL = 1e-4


def _inputs(seed, b, sq, sk, h, kv, hd, hd_v):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, sk, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, sk, kv, hd_v), dtype=np.float32)
    do = rng.standard_normal((b, sq, h, hd_v), dtype=np.float32)
    return q, k, v, do


@pytest.mark.parametrize("b,sq,h,kv,hd,hd_v,window,scale", [
    (1, 150, 12, 1, 192, 192, 0, None),      # nemotron's head dim and GQA group of 12
    (2, 77, 24, 2, 192, 192, 40, None),      # two KV heads, a window inside a chunk
    (1, 150, 4, 4, 192, 128, 0, 192 ** -0.5),  # deepseek-v2's MLA: q/k 192, v 128, no GQA
    (1, 97, 3, 3, 192, 128, 33, 192 ** -0.5),  # MLA's pair under a window
])
def test_plain_backward_matches_jax_vjp_of_the_reference(b, sq, h, kv, hd, hd_v, window, scale):
    q, k, v, do = _inputs(sq + h, b, sq, sq, h, kv, hd, hd_v)

    def attend(q, k, v):
        return j_attention.chunked_attention(q, k, v, causal=True, window=window, chunk=64, scale=scale)

    _, vjp = jax.vjp(attend, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = ref.flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)), causal=True, window=window,
                                      scale=scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= REL * float(np.abs(w).max())


# -- the host plan -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pair", fa.BWD_HEAD_DIM_PAIRS)
def test_every_build_fits_a_blocks_shared_memory(dtype, pair):
    dkdv, dq = fa.bwd_smem(*pair, dtype)
    assert 0 < dq and 0 < dkdv <= fa.SMEM_PER_BLOCK and dq <= fa.SMEM_PER_BLOCK


def test_shared_memory_of_the_builds_at_128_and_192():
    # 128: two sets double-buffering q and dO (10 tiles of 64 x 136 and lse/D),
    # dq 6 tiles; 192 (the wide build on wgmma): 1 KB of alignment slack, the
    # fixed 64 rows of both head dims, the ring's steps of 32 rows (dk/dv with
    # each step's lse and D; dq with its 64 once) and 128 B of barriers: at two
    # blocks an SM 3 steps at MLA's pair and 2 at 192's, and a dk/dv block of
    # two consumers (a GQA group) 9 and 7 with the SM to itself; f32 at 192 1
    # KB under the limit
    assert fa.bwd_smem(128, 128, torch.bfloat16) == (176128, 104448)
    # the dq block: q and dO of 128 rows, their lse and D, steps of 64 keys (3
    # at MLA's pair, 2 at 192's)
    assert fa.bwd_smem(192, 192, torch.bfloat16) == (1024 + 49152 + 2 * (24576 + 256) + 128,
                                                     1024 + 98304 + 1024 + 2 * 49152 + 128)
    assert fa.bwd_smem(192, 192, torch.bfloat16) == (99968, 198784)
    assert fa.bwd_smem(192, 192, torch.bfloat16, group=12) == (1024 + 49152 + 7 * (24576 + 256) + 128, 198784)
    assert fa.bwd_smem(192, 192, torch.bfloat16, group=12) == (224128, 198784)
    assert fa.bwd_smem(192, 128, torch.bfloat16) == (1024 + 40960 + 3 * (20480 + 256) + 128,
                                                     1024 + 81920 + 1024 + 3 * 40960 + 128)
    assert fa.bwd_smem(192, 128, torch.bfloat16) == (104320, 206976)
    assert fa.bwd_smem(192, 128, torch.bfloat16, group=2) == (228736, 206976)
    assert fa.bwd_stages(192, 128) == (3, 3) and fa.bwd_stages(192, 192) == (2, 2)
    assert fa.bwd_stages(192, 128, 2) == (9, 3) and fa.bwd_stages(192, 192, 12) == (7, 2)
    assert fa.bwd_smem(192, 192, torch.float32) == (231424, 231424)
    assert fa.bwd_smem(192, 128, torch.float32) == (198656, 198656)
    with pytest.raises(ValueError, match="no build"):
        fa.bwd_smem(160, 128, torch.bfloat16)


def test_launch_plans_at_the_two_full_shapes():
    nemotron = fa.bwd_launch_plan(1, 2048, 2048, 96, 8, 192, 192, torch.bfloat16)
    assert nemotron == (
        "3 launches at (192, 192): D and lse 16 threads a row; dk/dv 256 blocks of a TMA producer warpgroup "
        "and two consumers of 64 keys taking alternate steps (32 q rows a step, a 7-stage ring), 224128 B, "
        "1 an SM; dq 1536 blocks of a producer and two consumers of 64 q rows sharing the K/V ring (64 keys "
        "a step, a 2-stage ring), 198784 B, 1 an SM; wgmma bf16")
    mla = fa.bwd_launch_plan(1, 2048, 2048, 128, 128, 192, 128, torch.bfloat16)
    assert mla == (
        "3 launches at (192, 128): D and lse 16 threads a row; dk/dv 4096 blocks of a TMA producer warpgroup "
        "and a consumer of 64 keys (32 q rows a step, a 3-stage ring), 104320 B, 2 an SM; dq 2048 blocks of "
        "a producer and two consumers of 64 q rows sharing the K/V ring (64 keys a step, a 3-stage ring), "
        "206976 B, 1 an SM; wgmma bf16")
    qwen3 = fa.bwd_launch_plan(1, 2048, 2048, 32, 8, 128, 128, torch.bfloat16)
    assert "dk/dv 256 blocks of 8 warps (two sets of 4 taking alternate steps), 176128 B, 1 an SM" in qwen3
    assert "dq 1024 blocks of 4 warps (K/V double-buffered), 104448 B, 2 an SM" in qwen3


@pytest.mark.parametrize("hd,hd_v,widths", [
    (192, 192, (192, 192)), (192, 128, (192, 128)), (128, 128, (128, 128)),
    (96, 96, (128, 128)), (64, 32, (64, 64)), (160, 160, (192, 192)), (160, 100, (192, 128)),
    (192, 160, (192, 192)), (24, 16, (32, 32)),
])
def test_bwd_widths_pad_to_a_built_pair(hd, hd_v, widths):
    assert fa.bwd_widths(hd, hd_v) == widths and widths in fa.BWD_HEAD_DIM_PAIRS
    assert fa.bwd_route(torch.bfloat16, hd, hd_v).startswith(
        "fa_bwd_dkdv_wide" if widths[0] == 192 else "fa_bwd_dkdv_mma")
    assert ("zero-padded" in fa.bwd_route(torch.bfloat16, hd, hd_v)) == ((hd, hd_v) != widths)


# -- the wrapper's dispatch, through stand-ins for the CUDA calls ---------------------------


class _FakeLibrary:
    """Stands in for the kernel library: records each call's head dims and
    the strides it was given; the outputs stay as the wrapper allocated them."""

    def __init__(self):
        self.bwd, self.fwd = [], []

    def rt_flash_attention_bwd(self, *args):
        strides = [args[11][i] for i in range(24)]
        self.bwd.append(dict(hd=args[17], hd_v=args[18], scale=args[19], is_bf16=args[22],
                             plan=args[7], v_strides=strides[6:9], dv_strides=strides[21:24]))
        return 0

    def rt_flash_attention(self, *args):
        strides = [args[6][i] for i in range(12)]
        self.fwd.append(dict(hd=args[12], hd_v=args[13], lse=args[5], is_bf16=args[17],
                             v_strides=strides[6:9], o_strides=strides[9:12]))
        return 0


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(fa, "check_heads", lambda *a, **k: None)  # CPU tensors stand in for the card's
    monkeypatch.setattr(fa, "stream_ptr", lambda t: 0)
    return lib


def _bwd_args(h, kv, hd, hd_v, s=70, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, s, h, hd), generator=g).to(dtype)
    k = torch.randn((1, s, kv, hd), generator=g).to(dtype)
    v = torch.randn((1, s, kv, hd_v), generator=g).to(dtype)
    o, do = (torch.randn((1, s, h, hd_v), generator=g).to(dtype) for _ in range(2))
    return q, k, v, o, torch.zeros((1, h, s)), do


@pytest.mark.parametrize("hd,hd_v,built", [
    (192, 192, (192, 192)),   # nemotron-4-340b: its own build
    (192, 128, (192, 128)),   # deepseek-v2's MLA: its own build, v unpadded
    (96, 96, (128, 128)),     # an unbuilt head dim up to 128: padded, as before
    (160, 160, (192, 192)),   # an unbuilt head dim up to 192 with v's equal: padded to 192
    (160, 112, (192, 128)),   # both below their build: padded to MLA's pair
])
def test_the_wrapper_reaches_the_build_of_its_pair(fake_library, hd, hd_v, built):
    q, k, v, o, lse, do = _bwd_args(12, 1, hd, hd_v)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    (call,) = fake_library.bwd
    assert (call["hd"], call["hd_v"]) == built and call["is_bf16"] == 1 and call["plan"]
    assert call["scale"] == pytest.approx(hd ** -0.5)  # the true head dim's, also when padded
    assert call["v_strides"] == [70 * built[1], built[1], built[1]]  # v at the build's v width
    assert call["dv_strides"] == call["v_strides"]
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)


def test_the_wrapper_raises_above_192(fake_library):
    with pytest.raises(NotImplementedError, match="above head dim 192"):
        fa.flash_attention_bwd(*_bwd_args(2, 1, 256, 256, s=8))
    with pytest.raises(NotImplementedError, match="above head dim 192"):
        fa.flash_attention_bwd(*_bwd_args(2, 1, 128, 192, s=8))  # v wider than q
    assert not fake_library.bwd


def test_the_wrapper_refuses_an_o_at_the_wrong_head_dim(fake_library):
    q, k, v, o, lse, do = _bwd_args(4, 4, 192, 128, s=8)
    with pytest.raises(ValueError, match="v's head dim 128"):
        fa.flash_attention_bwd(q, k, v, torch.zeros_like(q), lse, do)


def test_with_lse_on_route_a_returns_the_padded_calls_lse(fake_library):
    q, k, v, _, _, _ = _bwd_args(4, 4, 192, 128, s=70)
    o, lse = fa.flash_attention(q, k, v, causal=True, with_lse=True)
    (call,) = fake_library.fwd
    assert call["hd"] == 192 and call["lse"] == lse.data_ptr()  # the padded call's own buffer
    assert o.shape == (1, 70, 4, 128) and o.is_contiguous()
    assert lse.shape == (1, 4, 70) and lse.dtype == torch.float32


def test_with_lse_above_192_raises_naming_the_pieces_route(fake_library):
    q, k, v, _, _, _ = _bwd_args(2, 1, 256, 256, s=8)
    with pytest.raises(NotImplementedError, match="attention_pieces"):
        fa.flash_attention(q, k, v, with_lse=True)
    assert not fake_library.fwd



@pytest.mark.parametrize("dtype,hd,hd_v,called", [
    (torch.bfloat16, 192, 128, (192, 128)),  # deepseek-v2's MLA: flash_fwd_wide at v's own head dim
    (torch.bfloat16, 192, 192, (192, 192)),  # nemotron-4-340b
    (torch.float32, 192, 128, (192, 192)),   # f32: route (a), v zero-padded to 192
    (torch.bfloat16, 192, 96, (192, 192)),   # an unbuilt v head dim: route (a)
    (torch.bfloat16, 128, 64, (128, 128)),   # below 192: route (a) into flash_fwd_wg
])
def test_the_forward_reaches_the_build_of_its_pair(fake_library, dtype, hd, hd_v, called):
    q, k, v, _, _, _ = _bwd_args(4, 2, hd, hd_v, s=70, dtype=dtype)
    o, lse = fa.flash_attention(q, k, v, causal=True, with_lse=True)
    (call,) = fake_library.fwd
    assert (call["hd"], call["hd_v"]) == called and call["is_bf16"] == int(dtype == torch.bfloat16)
    assert call["v_strides"] == [70 * 2 * called[1], 2 * called[1], called[1]]  # v as the build takes it
    assert call["o_strides"] == [70 * 4 * called[1], 4 * called[1], called[1]]
    assert call["lse"] == lse.data_ptr() and lse.shape == (1, 4, 70)
    assert o.shape == (1, 70, 4, hd_v)
    assert fa.route(dtype, hd, hd_v).startswith("flash_fwd_wide") == (dtype == torch.bfloat16 and hd == 192)
    assert ("route (a)" in fa.route(dtype, hd, hd_v)) == (called[1] != hd_v)
