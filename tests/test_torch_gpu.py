"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture, never at import). This file imports no JAX, so it also runs on a
machine that has only PyTorch and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 2e-5, bf16 2e-2 (the precedent of tests/test_kernels.py),
with atol 2e-3 for K5/K6 in bf16: their outputs are weighted means, small
beside 2e-2, and two bf16 roundings of one value differ by at most one ulp,
which rtol covers. K2/K3 and the kalman scan are held bitwise, as their
contract says. The K5/K6 cases are tests/test_kernels.py's sweep plus
qwen3's head dim and zamba2's (80), and the edges of the kernels' tiling:
lengths of 1, 127, 129 and 2047 against K5's 128-row q tiles and 64-key
K/V tiles, windows that start inside a tile, GQA groups of 1 to 48, and
cache lengths of 1, 63, 65 and 2048 against K6's split plan. K7 returns float32 whatever its inputs
and its plain version computes in float32 from the same inputs, so they
differ only in the order of their sums: held at 1e-4 of the largest |value|.
"""
import pytest
import torch

from repro_torch.kernels import build, decode_attention, flash_attention, fused, kalman, ref, rmsnorm, ssd

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ATTN_BF16_TOL = dict(rtol=2e-2, atol=2e-3)
SSD_REL = 1e-4
STAGES = ((2.0, 0.5), (0.7, -0.1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn((4096, 8), generator=g) * 4.0).to(cuda)
    x = batch[:, 1:6]
    scale = torch.full((5,), 1.5, device=cuda)
    torch.testing.assert_close(rmsnorm.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale), **F32_TOL)
    eager = ref.map_chain_ref(x, STAGES)
    assert torch.equal(fused.map_chain(x, STAGES), eager)
    assert torch.equal(fused.affine_rmsnorm(x, scale, STAGES), rmsnorm.rmsnorm(eager, scale))
    got = kalman.kalman_scan(x, torch.zeros(5, device=cuda), torch.ones(5, device=cuda), 0.1, 1.0)
    want = ref.kalman_scan_ref(x, torch.zeros(5, device=cuda), torch.ones(5, device=cuda), 0.1, 1.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_wide(cuda, dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((64, 8192), generator=g).to(cuda, dtype)
    scale = (1.0 + 0.1 * torch.randn((8192,), generator=g)).to(cuda)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(
        rmsnorm.rmsnorm(x, scale).float(), ref.rmsnorm_ref(x, scale).float(), **tol
    )


@pytest.mark.gpu
def test_stream_path_on_the_card_matches_cpu(cuda):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    def run(device):
        system = StreamSystem(base_batch=256, device=device)
        flows = riot_workload() + kernel_flows()
        for df in flows:
            system.submit(df)
        system.run(2)
        assert system.fuse()
        system.run(2)
        return {df.name: system.sink_digests(df.name) for df in flows}

    reset_launch_counts()
    on_card = run(cuda)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ("rmsnorm", "map_chain", "affine_rmsnorm", "kalman_scan"))
    on_cpu = run("cpu")
    for sub, sinks in on_cpu.items():
        for sink, dg in sinks.items():
            assert on_card[sub][sink]["count"] == dg["count"] == 4
            assert on_card[sub][sink]["checksum"] == pytest.approx(dg["checksum"], rel=1e-4)


def _tol(dtype, bf16=BF16_TOL):
    return bf16 if dtype == torch.bfloat16 else F32_TOL


def _randn(g, shape, dev, dtype):
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 17, 2560), (64, 5), (2, 7, 256)])
def test_cuda_rmsnorm_residual(cuda, dtype, shape):
    g = torch.Generator().manual_seed(2)
    x, r = _randn(g, shape, cuda, dtype), _randn(g, shape, cuda, dtype)
    scale = (1.0 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda)
    got_y, got_h = rmsnorm.rmsnorm_residual(x, r, scale)
    want_y, want_h = ref.rmsnorm_residual_ref(x, r, scale)
    torch.testing.assert_close(got_h.float(), want_h.float(), **_tol(dtype))
    torch.testing.assert_close(got_y.float(), want_y.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window", [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 96, 96, 2, 1, 64, True, 0),
    (1, 128, 128, 2, 2, 64, False, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (2, 33, 77, 2, 2, 16, False, 0),
    (1, 300, 300, 32, 8, 128, True, 0),
    (1, 200, 200, 8, 2, 128, True, 50),
    (1, 333, 333, 32, 32, 80, True, 4096),
    (2, 70, 70, 4, 4, 80, True, 16),
    # the tensor-core kernel's edges: 128-row q tiles, 64-key K/V tiles
    (1, 1, 1, 4, 4, 64, True, 0),
    (2, 1, 129, 4, 2, 32, False, 0),
    (1, 127, 127, 8, 2, 128, True, 0),       # G = 4
    (1, 129, 129, 8, 1, 128, True, 0),       # G = 8
    (2, 2047, 2047, 4, 4, 128, True, 0),     # G = 1, batch 2
    (1, 127, 129, 4, 4, 80, False, 0),       # Sq != Sk, not causal
    (1, 129, 2047, 2, 1, 64, False, 0),
    (1, 127, 300, 4, 2, 64, True, 0),
    (1, 300, 300, 4, 4, 64, True, 100),      # windows that start inside a tile
    (1, 129, 129, 4, 4, 16, True, 33),
    (1, 2047, 2047, 8, 8, 80, True, 200),
    (1, 2047, 2047, 8, 4, 128, False, 300),  # a window without the causal mask
])
def test_cuda_flash_attention(cuda, dtype, b, sq, sk, h, kv, hd, causal, window):
    g = torch.Generator().manual_seed(3)
    q = _randn(g, (b, sq, h, hd), cuda, dtype)
    k, v = _randn(g, (b, sk, kv, hd), cuda, dtype), _randn(g, (b, sk, kv, hd), cuda, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd", [(32, 8, 128), (32, 32, 80), (4, 1, 64)])
def test_cuda_flash_attention_reads_strided_views(cuda, dtype, h, kv, hd):
    # q, k, v as slices of one fused projection, (batch, seq, head) strides
    # of the wide row: the model may hand over such views
    g = torch.Generator().manual_seed(7)
    b, s = 2, 200
    qkv = _randn(g, (b, s, (h + 2 * kv) * hd), cuda, dtype)
    q = qkv[..., : h * hd].view(b, s, h, hd)
    k = qkv[..., h * hd : (h + kv) * hd].view(b, s, kv, hd)
    v = qkv[..., (h + kv) * hd :].view(b, s, kv, hd)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))
    packed = flash_attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, packed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_gives_zeros_where_a_row_sees_no_key(cuda, dtype):
    # causal with a window of 50 over 100 keys: rows 149 and up see none. Both
    # builds give them zeros (the plain version gives the mean of V, a row the
    # serving path never makes); the other rows match the plain version
    g = torch.Generator().manual_seed(9)
    sq, sk, window = 300, 100, 50
    q = _randn(g, (2, sq, 4, 64), cuda, dtype)
    k, v = _randn(g, (2, sk, 2, 64), cuda, dtype), _randn(g, (2, sk, 2, 64), cuda, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=True, window=window)
    blind = sk + window - 1
    assert torch.equal(got[:, blind:], torch.zeros_like(got[:, blind:]))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got[:, :blind].float(), want[:, :blind].float(),
                               **_tol(dtype, ATTN_BF16_TOL))


@pytest.mark.gpu
def test_cuda_flash_attention_refuses_unaligned_bf16_rows(cuda):
    x = torch.zeros((1, 16, 2, 68), device=cuda, dtype=torch.bfloat16)[..., 2:66]
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_attention(x, x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,smax,clen,h,kv,hd,window", [
    (2, 128, 100, 4, 4, 64, 0),
    (2, 128, 128, 4, 2, 64, 0),
    (1, 256, 200, 8, 1, 32, 0),
    (1, 256, 250, 4, 2, 64, 64),
    (3, 96, 1, 2, 2, 16, 0),
    (1, 4096, 2048, 32, 8, 128, 0),
    (1, 64, 0, 4, 2, 16, 0),
    (1, 4096, 2048, 32, 32, 80, 4096),
    (2, 16, 13, 4, 4, 80, 16),
    # the split plan's and the row groups' edges
    (1, 4096, 1, 32, 8, 128, 0),
    (1, 4096, 63, 32, 8, 128, 0),
    (1, 4096, 65, 32, 8, 128, 0),
    (2, 2048, 2048, 16, 2, 128, 0),      # G = 8, the whole cache
    (1, 4096, 2048, 32, 32, 80, 100),    # hd 80, G = 1, a window
    (1, 512, 300, 48, 1, 64, 0),         # G = 48: six head groups of 8
    (1, 512, 300, 12, 2, 64, 37),        # G = 6: groups of 2
])
def test_cuda_decode_attention(cuda, dtype, b, smax, clen, h, kv, hd, window):
    g = torch.Generator().manual_seed(4)
    q = _randn(g, (b, 1, h, hd), cuda, dtype)
    # one layer of a stacked (L, B, S, KV, hd) cache: a strided view
    kc = _randn(g, (2, b, smax, kv, hd), cuda, dtype)[1]
    vc = _randn(g, (2, b, smax, kv, hd), cuda, dtype)[1]
    got = decode_attention.decode_attention(q, kc, vc, clen, window=window)
    want = ref.decode_attention_ref(q, kc, vc, clen, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


@pytest.mark.gpu
def test_cuda_decode_attention_reuses_its_scratch(cuda):
    # two calls in a row on the cached partials and counters, then a call at
    # a new, larger shape (the scratch grows); the counters end at 0
    g = torch.Generator().manual_seed(8)
    dtype = torch.bfloat16
    for b, smax, clen, h, kv, hd in ((1, 4096, 2048, 32, 8, 128), (1, 4096, 2048, 32, 8, 128),
                                     (1, 4096, 1500, 32, 8, 128), (3, 4096, 4000, 16, 16, 80)):
        q = _randn(g, (b, 1, h, hd), cuda, dtype)
        kc, vc = _randn(g, (b, smax, kv, hd), cuda, dtype), _randn(g, (b, smax, kv, hd), cuda, dtype)
        got = decode_attention.decode_attention(q, kc, vc, clen)
        want = ref.decode_attention_ref(q, kc, vc, clen)
        torch.testing.assert_close(got.float(), want.float(), **ATTN_BF16_TOL)
        key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
        assert int(decode_attention._scratch[key][1].abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("swa", [0, 8])
def test_dense_serving_path_on_the_card_matches_cpu(cuda, swa):
    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map

    cfg = configs.get_smoke_config("qwen3-4b").replace(swa_window=swa)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    caches = {"cpu": init_cache(cfg, 2, 32), "cuda": init_cache(cfg, 2, 32, device=cuda)}
    want, _ = prefill(params, cfg, toks, caches["cpu"])
    got, _ = prefill(on_card, cfg, toks.to(cuda), caches["cuda"])
    for _ in range(3):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = want.argmax(-1)[:, None]
        want, _ = decode_step(params, cfg, tok, caches["cpu"])
        got, _ = decode_step(on_card, cfg, tok.to(cuda), caches["cuda"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    counts = launch_counts()
    for name in ("rmsnorm", "rmsnorm_residual", "flash_attention", "decode_attention"):
        assert counts[name] > 0, name


def _assert_rel(got, want, rel=SSD_REL):
    limit = rel * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= limit, f"max |err| {err} above {limit}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,p,n,chunk", [
    (1, 64, 2, 32, 16, 16),      # tests/test_kernels.py's three shapes
    (2, 128, 4, 64, 64, 32),
    (1, 256, 2, 64, 128, 128),   # W in row tiles: a whole W does not fit
    (1, 1109, 8, 64, 64, 128),   # zamba2's widths, a prime (ragged) S
    (2, 37, 3, 32, 16, 8),       # zamba2 SMOKE's widths, ragged
    (1, 100, 2, 16, 8, 48),
])
def test_cuda_ssd_scan(cuda, dtype, b, s, nh, p, n, chunk):
    g = torch.Generator().manual_seed(5)
    xh = _randn(g, (b, s, nh, p), cuda, dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=g)).to(cuda)
    a = -torch.exp(0.5 * torch.randn((nh,), generator=g)).to(cuda)
    bm, cm = _randn(g, (b, s, n), cuda, dtype), _randn(g, (b, s, n), cuda, dtype)
    h0 = torch.randn((b, nh, n, p), generator=g).to(cuda) if s % 2 else None
    got_y, got_h = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk, h0=h0)
    want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk, h0)
    assert got_y.dtype == got_h.dtype == torch.float32
    _assert_rel(got_y, want_y)
    _assert_rel(got_h, want_h)


@pytest.mark.gpu
def test_cuda_ssd_scan_reads_strided_slices(cuda):
    # the Mamba block hands over xh, B and C as slices of one conv output
    g = torch.Generator().manual_seed(6)
    b, s, nh, p, n = 2, 50, 4, 32, 16
    xbc = _randn(g, (b, s, nh * p + 2 * n), cuda, torch.bfloat16)
    xh = xbc[..., : nh * p].reshape(b, s, nh, p)
    bm, cm = xbc[..., nh * p : nh * p + n], xbc[..., nh * p + n :]
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=g)).to(cuda)
    a = -torch.exp(torch.randn((nh,), generator=g)).to(cuda)
    got = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=16)
    want = ssd.ssd_scan(xh.contiguous(), dt, a, bm.contiguous(), cm.contiguous(), chunk=16)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_hybrid_serving_path_on_the_card_matches_cpu(cuda):
    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map

    cfg = configs.get_smoke_config("zamba2-2.7b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    torch.testing.assert_close(forward(on_card, cfg, toks.to(cuda)).cpu(), forward(params, cfg, toks),
                               rtol=1e-4, atol=1e-4)
    caches = {"cpu": init_cache(cfg, 2, 32), "cuda": init_cache(cfg, 2, 32, device=cuda)}
    want, _ = prefill(params, cfg, toks, caches["cpu"])
    got, _ = prefill(on_card, cfg, toks.to(cuda), caches["cuda"])
    for _ in range(3):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = want.argmax(-1)[:, None]
        want, _ = decode_step(params, cfg, tok, caches["cpu"])
        got, _ = decode_step(on_card, cfg, tok.to(cuda), caches["cuda"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in ("conv", "h"):
        torch.testing.assert_close(caches["cuda"]["mamba"][name].cpu(), caches["cpu"]["mamba"][name],
                                   rtol=1e-4, atol=1e-4)
    counts = launch_counts()
    for name in ("rmsnorm", "rmsnorm_residual", "flash_attention", "decode_attention", "ssd_scan"):
        assert counts[name] > 0, name


def _ssd_case(g, b, s, nh, p, n, dev, dtype, with_h0):
    xh = _randn(g, (b, s, nh, p), dev, dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=g)).to(dev)
    a = -torch.exp(0.5 * torch.randn((nh,), generator=g)).to(dev)
    bm, cm = _randn(g, (b, s, n), dev, dtype), _randn(g, (b, s, n), dev, dtype)
    h0 = torch.randn((b, nh, n, p), generator=g).to(dev) if with_h0 else None
    return xh, dt, a, bm, cm, h0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,p,n,chunk,with_h0", [
    (1, 1, 4, 64, 64, 128, False),       # S = 1
    (1, 77, 4, 64, 64, 128, True),       # S < chunk
    (1, 128, 4, 64, 64, 128, False),     # S = chunk
    (1, 129, 4, 64, 64, 128, True),      # S one past a chunk
    (1, 4096, 4, 32, 16, 16, False),     # 256 chunks: more blocks than one wave
    (2, 300, 6, 64, 64, 128, True),      # batch 2 with h0
    (1, 257, 3, 64, 128, 128, True),     # N = 128
    (1, 50, 3, 18, 12, 24, True),        # widths that are not multiples of 8: plain staging
])
def test_cuda_ssd_scan_edges(cuda, dtype, b, s, nh, p, n, chunk, with_h0):
    g = torch.Generator().manual_seed(9)
    xh, dt, a, bm, cm, h0 = _ssd_case(g, b, s, nh, p, n, cuda, dtype, with_h0)
    got_y, got_h = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk, h0=h0)
    want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk, h0)
    _assert_rel(got_y, want_y)
    _assert_rel(got_h, want_h)


@pytest.mark.gpu
def test_cuda_ssd_scan_one_stage_layout(cuda):
    # N = P = 128: two stages of a head's tiles do not fit beside C and C·Bᵀ,
    # so the tensor-core build copies each head in after the last one's
    # products (the f32 SIMT build does not fit this shape at all and raises)
    g = torch.Generator().manual_seed(14)
    xh, dt, a, bm, cm, h0 = _ssd_case(g, 1, 200, 2, 128, 128, cuda, torch.bfloat16, True)
    got_y, got_h = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=128, h0=h0)
    want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, 128, h0)
    _assert_rel(got_y, want_y)
    _assert_rel(got_h, want_h)


@pytest.mark.gpu
def test_cuda_ssd_scan_refuses_f32_where_it_does_not_fit(cuda):
    # L = N = P = 128 in f32: the SIMT build's tiles need more shared memory
    # than a block has even with W in row tiles of one row: the wrapper no
    # longer refuses the shape, it runs the tiled build (one launch)
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(15)
    xh, dt, a, bm, cm, h0 = _ssd_case(g, 1, 200, 2, 128, 128, cuda, torch.float32, True)
    assert ssd.route(torch.float32, 128, 128, 128) == "tiles"
    reset_launch_counts()
    got_y, got_h = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=128, h0=h0)
    assert launch_counts()["ssd_scan"] == 1
    want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, 128, h0)
    _assert_rel(got_y, want_y)
    _assert_rel(got_h, want_h)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,p,n,chunk,with_h0", [
    (1, 512, 2, 128, 128, 128, True),   # f32: the SIMT build does not fit
    (1, 512, 2, 160, 192, 256, True),   # chunk, N and P above 128
    (2, 300, 3, 129, 130, 131, False),  # ragged everywhere: S, the 32-wide tiles
    (1, 64, 2, 200, 8, 16, True),       # P alone above 128
])
def test_cuda_ssd_scan_tiled_build(cuda, dtype, b, s, nh, p, n, chunk, with_h0):
    g = torch.Generator().manual_seed(21)
    xh, dt, a, bm, cm, h0 = _ssd_case(g, b, s, nh, p, n, cuda, dtype, with_h0)
    if max(chunk, n, p) > 128:
        assert ssd.route(dtype, chunk, n, p) == "tiles"
    got_y, got_h = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk, h0=h0)
    want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk, h0)
    assert got_y.dtype == got_h.dtype == torch.float32
    _assert_rel(got_y, want_y)
    _assert_rel(got_h, want_h)


@pytest.mark.gpu
def test_cuda_ssd_scan_counts_each_launch(cuda):
    # one count per kernel launched: three for bf16, one for f32
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(16)
    for dtype, want in ((torch.bfloat16, 3), (torch.float32, 1)):
        xh, dt, a, bm, cm, h0 = _ssd_case(g, 1, 300, 4, 64, 64, cuda, dtype, True)
        reset_launch_counts()
        ssd.ssd_scan(xh, dt, a, bm, cm, chunk=128, h0=h0)
        assert launch_counts()["ssd_scan"] == want


@pytest.mark.gpu
def test_cuda_ssd_scan_head_group_that_does_not_divide_the_heads(cuda):
    # zamba2's widths with 81 heads: the plan's group of heads per block
    # leaves a last group with fewer heads
    g = torch.Generator().manual_seed(10)
    b, s, nh, p, n, chunk = 1, 2048, 81, 64, 64, 128
    xh, dt, a, bm, cm, h0 = _ssd_case(g, b, s, nh, p, n, cuda, torch.bfloat16, True)
    assert nh % ssd._plan(xh.device, b, s // chunk, nh, chunk, n, p) != 0
    got_y, got_h = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk, h0=h0)
    want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk, h0)
    _assert_rel(got_y, want_y)
    _assert_rel(got_h, want_h)


@pytest.mark.gpu
def test_cuda_ssd_scan_reuses_its_scratch(cuda):
    # two calls in a row on the cached chunk states give the same bits, then
    # a new, larger shape grows the scratch, then the first shape again
    g = torch.Generator().manual_seed(11)
    first = _ssd_case(g, 1, 1109, 8, 64, 64, cuda, torch.bfloat16, False)
    second = _ssd_case(g, 2, 2048, 16, 64, 64, cuda, torch.bfloat16, True)
    runs = []
    for xh, dt, a, bm, cm, h0 in (first, first, second, first):
        got = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=128, h0=h0)
        want = ref.ssd_scan_ref(xh, dt, a, bm, cm, 128, h0)
        for x, y in zip(got, want):
            _assert_rel(x, y)
        runs.append(got)
    for i, j in ((0, 1), (0, 3)):
        for x, y in zip(runs[i], runs[j]):
            assert torch.equal(x, y)


def _kalman_fixed_point(q, r, rows=4096):
    # p after `rows` rows of the gain chain, which never reads the data
    _, _, p = ref.kalman_scan_ref(torch.zeros((rows, 1)), torch.zeros(1), torch.ones(1), q, r)
    return float(p[0])


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [0, 1, 31, 33, 16384])
@pytest.mark.parametrize("q,r", [(0.1, 1.0), (0.3, 1.5), (1e-6, 1e3)])
@pytest.mark.parametrize("p_start", ["ones", "fixed"])
def test_cuda_kalman_scan_is_bitwise_the_plain_version(cuda, rows, q, r, p_start):
    # a column slice of the (N, 8) event batch, as the stream path passes it;
    # (0.3, 1.5) settles into a gain cycle of period 2, (1e-6, 1e3) not
    # within 16384 rows
    g = torch.Generator().manual_seed(12)
    batch = torch.randn((rows, 8), generator=g) * 4.0 + 1.0
    z = batch[:, 1:6]
    xe = torch.randn((5,), generator=g)
    p = torch.ones(5) if p_start == "ones" else torch.full((5,), _kalman_fixed_point(q, r))
    want = ref.kalman_scan_ref(z, xe, p, q, r)
    got = kalman.kalman_scan(batch.to(cuda)[:, 1:6], xe.to(cuda), p.to(cuda), q, r)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert torch.equal(x.cpu(), y)


@pytest.mark.gpu
def test_cuda_kalman_scan_many_channels(cuda):
    # 40 channels: three blocks of up to 16, the last one partial
    g = torch.Generator().manual_seed(13)
    z = torch.randn((1000, 40), generator=g)
    xe, p = torch.randn((40,), generator=g), torch.rand((40,), generator=g) + 0.5
    want = ref.kalman_scan_ref(z, xe, p, 0.2, 0.8)
    got = kalman.kalman_scan(z.to(cuda), xe.to(cuda), p.to(cuda), 0.2, 0.8)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


# -- K1's routes, K2/K3 in bf16, K5/K6 at head dim 192 ---------------------------------

def _rows(g, rows, d, dev, dtype, layout):
    """(rows, d): packed, or a view whose rows start 2 or 4 bytes off a
    16-byte boundary and have an odd stride (the scalar-load route)."""
    if layout == "packed":
        return _randn(g, (rows, d), dev, dtype)
    return _randn(g, (rows, d + 1), dev, dtype)[:, 1:]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "unaligned view"])
@pytest.mark.parametrize("rows,d", [(65536, 128), (16384, 128), (2048, 2560), (2048, 5120),
                                    (32, 128)])
def test_cuda_rmsnorm_serving_shapes(cuda, rows, d, layout):
    # qwen3-4b's q- and k-norm at 2048 tokens, its layer-0 norm, zamba2's
    # out_norm and a decode step's q-norm, in bf16, on both load routes
    g = torch.Generator().manual_seed(14)
    x = _rows(g, rows, d, cuda, torch.bfloat16, layout)
    scale = (1.0 + 0.1 * torch.randn((d,), generator=g)).to(cuda)
    torch.testing.assert_close(rmsnorm.rmsnorm(x, scale).float(),
                               ref.rmsnorm_ref(x, scale).float(), **BF16_TOL)
    assert torch.equal(rmsnorm.rmsnorm(x, scale), rmsnorm.rmsnorm(x.contiguous(), scale))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [9, 31, 100, 128, 130, 264, 1000, 2560, 4100, 8192, 16384, 18432])
def test_cuda_rmsnorm_every_route(cuda, dtype, d):
    # widths on every route and at ragged chunk counts: the two load routes
    # give the same bits
    g = torch.Generator().manual_seed(15)
    x = _rows(g, 37, d, cuda, dtype, "unaligned view")
    scale = (1.0 + 0.1 * torch.randn((d,), generator=g)).to(cuda)
    got = rmsnorm.rmsnorm(x, scale)
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, scale).float(), **_tol(dtype))
    assert torch.equal(got, rmsnorm.rmsnorm(x.contiguous(), scale))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [5, 128, 5120])
def test_cuda_affine_rmsnorm_is_bitwise_rmsnorm_of_map_chain(cuda, d):
    # K3 reads the caller's unaligned view, K1 the packed output of K2: the
    # plan fixes the order of the sums whatever the load route
    g = torch.Generator().manual_seed(16)
    x = (torch.randn((300, d + 3), generator=g) * 4.0 + 1.0).to(cuda)[:, 1:1 + d]
    scale = (1.0 + 0.1 * torch.randn((d,), generator=g)).to(cuda)
    chained = fused.map_chain(x, STAGES)
    assert torch.equal(chained, ref.map_chain_ref(x, STAGES))
    assert torch.equal(fused.affine_rmsnorm(x, scale, STAGES), rmsnorm.rmsnorm(chained, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 5), (300, 128), (64, 5120)])
def test_cuda_fused_kernels_in_bf16(cuda, shape):
    # stages and norm in f32, one rounding to bf16 at the end, as the Pallas
    # kernels and the plain versions: K2 gives the plain version's bits
    g = torch.Generator().manual_seed(17)
    x = (torch.randn(shape, generator=g) * 4.0 + 1.0).to(cuda, torch.bfloat16)
    scale = (1.0 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda)
    got = fused.map_chain(x, STAGES)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.map_chain_ref(x, STAGES))
    got = fused.affine_rmsnorm(x, scale, STAGES)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.affine_rmsnorm_ref(x, scale, STAGES).float(),
                               **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,layout", [((1, 2048, 2560), "packed"), ((1, 1, 2560), "packed"),
                                          ((64, 2560), "unaligned view")])
def test_cuda_rmsnorm_residual_serving_shapes(cuda, dtype, shape, layout):
    g = torch.Generator().manual_seed(18)
    d = shape[-1]
    if layout == "packed":
        x, r = _randn(g, shape, cuda, dtype), _randn(g, shape, cuda, dtype)
    else:
        x, r = (_rows(g, shape[0], d, cuda, dtype, layout) for _ in range(2))
    scale = (1.0 + 0.1 * torch.randn((d,), generator=g)).to(cuda)
    got_y, got_h = rmsnorm.rmsnorm_residual(x, r, scale)
    want_y, want_h = ref.rmsnorm_residual_ref(x, r, scale)
    torch.testing.assert_close(got_h.float(), want_h.float(), **_tol(dtype))
    torch.testing.assert_close(got_y.float(), want_y.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", [
    (1, 2048, 2048, 96, 8, True, 0),   # nemotron-4-340b's heads, 12 per KV head
    (2, 129, 129, 12, 1, True, 0),
    (1, 300, 300, 4, 4, True, 64),
    (1, 127, 200, 8, 2, False, 0),
    (1, 333, 333, 12, 1, True, 100),
])
def test_cuda_flash_attention_head_dim_192(cuda, dtype, b, sq, sk, h, kv, causal, window):
    g = torch.Generator().manual_seed(19)
    q = _randn(g, (b, sq, h, 192), cuda, dtype)
    k, v = _randn(g, (b, sk, kv, 192), cuda, dtype), _randn(g, (b, sk, kv, 192), cuda, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


# -- K5's wide bf16 build at head dim 192 (flash_fwd_wide), at v's own head dim ----------

@pytest.mark.gpu
@pytest.mark.parametrize("hd_v", [192, 128])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", [
    (1, 2048, 2048, 16, 2, True, 0),   # causal, whole tiles
    (2, 129, 129, 12, 1, True, 0),     # ragged q and K/V tiles, a GQA group of 12
    (1, 300, 300, 4, 4, True, 64),     # a window inside a tile
    (1, 127, 200, 8, 2, False, 0),     # no mask, Sq != Sk
    (1, 333, 70, 6, 3, True, 0),       # Sq > Sk, causal
])
def test_cuda_flash_attention_wide(cuda, hd_v, b, sq, sk, h, kv, causal, window):
    # the wide build at (192, hd_v) against the plain version, and its lse
    # against the padded route's (v zero-padded to 192, the same scores)
    g = torch.Generator().manual_seed(sq + hd_v)
    q = _randn(g, (b, sq, h, 192), cuda, torch.bfloat16)
    k = _randn(g, (b, sk, kv, 192), cuda, torch.bfloat16)
    v = _randn(g, (b, sk, kv, hd_v), cuda, torch.bfloat16)
    scale = 192 ** -0.5 * 0.9
    before = build.launch_counts()["flash_attention"]
    got, lse = flash_attention.flash_attention(q, k, v, causal=causal, window=window, scale=scale, with_lse=True)
    assert build.launch_counts()["flash_attention"] == before + 1
    assert got.shape == (b, sq, h, hd_v) and lse.shape == (b, h, sq)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_BF16_TOL)
    padded, lse_padded = flash_attention.attend_padded_value(
        flash_attention.flash_attention, q, k, v, causal=causal, window=window, scale=scale, with_lse=True)
    torch.testing.assert_close(lse, lse_padded, **F32_TOL)
    torch.testing.assert_close(got.float(), padded.float(), **ATTN_BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("hd_v", [192, 128])
def test_cuda_flash_attention_wide_reads_strided_views_and_blind_rows(cuda, hd_v):
    # q, k, v as slices of one fused projection; causal with a window of 50
    # over 100 keys, so rows 149 and up see no key: zeros and lse +inf
    g = torch.Generator().manual_seed(hd_v)
    b, sq, sk, h, kv, window = 2, 300, 100, 4, 2, 50
    qx = _randn(g, (b, sq, h * 192 + 64), cuda, torch.bfloat16)
    kvx = _randn(g, (b, sk, kv * (192 + hd_v)), cuda, torch.bfloat16)
    q = qx[..., : h * 192].view(b, sq, h, 192)
    k = kvx[..., : kv * 192].view(b, sk, kv, 192)
    v = kvx[..., kv * 192:].view(b, sk, kv, hd_v)
    got, lse = flash_attention.flash_attention(q, k, v, causal=True, window=window, with_lse=True)
    packed = flash_attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                             window=window)
    assert torch.equal(got, packed)
    blind = sk + window - 1
    assert torch.equal(got[:, blind:], torch.zeros_like(got[:, blind:]))
    assert bool(torch.isinf(lse[:, :, blind:]).all()) and bool(torch.isfinite(lse[:, :, :blind]).all())
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got[:, :blind].float(), want[:, :blind].float(), **ATTN_BF16_TOL)


@pytest.mark.gpu
def test_cuda_flash_attention_at_mla_takes_the_wide_build_not_route_a(cuda, monkeypatch):
    # bf16 at (192, 128) launches flash_fwd_wide once; route (a) is not reached
    def refuse(*args, **kwargs):
        raise AssertionError("route (a) reached")

    g = torch.Generator().manual_seed(1)
    q = _randn(g, (1, 200, 8, 192), cuda, torch.bfloat16)
    k, v = _randn(g, (1, 200, 8, 192), cuda, torch.bfloat16), _randn(g, (1, 200, 8, 128), cuda, torch.bfloat16)
    monkeypatch.setattr(flash_attention, "attend_padded_value", refuse)
    before = build.launch_counts()["flash_attention"]
    out = flash_attention.flash_attention(q, k, v, causal=True)
    assert build.launch_counts()["flash_attention"] == before + 1 and out.shape == (1, 200, 8, 128)
    assert flash_attention.route(torch.bfloat16, 192, 128).startswith("flash_fwd_wide")


@pytest.mark.gpu
def test_cuda_flash_attention_smem_matches_the_source(cuda):
    lib = build.library()
    pairs = [(hd, hd) for hd in flash_attention.HEAD_DIMS] + list(flash_attention.WIDE_PAIRS)
    for hd, hd_v in pairs:
        for dtype in (torch.bfloat16, torch.float32):
            if hd != hd_v and dtype == torch.float32:
                assert lib.rt_flash_attention_smem(hd, hd_v, 0) == -1
                continue
            want = flash_attention.fwd_smem(hd, hd_v, dtype)
            assert lib.rt_flash_attention_smem(hd, hd_v, int(dtype == torch.bfloat16)) == want, (hd, hd_v, dtype)
    assert lib.rt_flash_attention_smem(192, 96, 1) == -1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,smax,clen,h,kv,window", [
    (1, 4096, 2048, 96, 8, 0),
    (2, 300, 257, 12, 1, 0),
    (1, 512, 500, 8, 8, 128),
    (1, 64, 1, 24, 2, 0),
    (1, 4096, 4096, 16, 2, 0),   # G = 8: two head groups of 4 at hd 192
])
def test_cuda_decode_attention_head_dim_192(cuda, dtype, b, smax, clen, h, kv, window):
    g = torch.Generator().manual_seed(20)
    q = _randn(g, (b, 1, h, 192), cuda, dtype)
    kc = _randn(g, (2, b, smax, kv, 192), cuda, dtype)[1]
    vc = _randn(g, (2, b, smax, kv, 192), cuda, dtype)[1]
    got = decode_attention.decode_attention(q, kc, vc, clen, window=window)
    want = ref.decode_attention_ref(q, kc, vc, clen, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


def nemotron_width_cut():
    """nemotron-4-340b cut in width: head dim 192 and 12 q heads per KV head
    kept (d_model 2304 = 12 x 192, one KV head), 2 layers, d_ff 4 x d_model,
    a 4096-token vocabulary; layernorm and squared ReLU as configured."""
    from repro_torch import configs

    return configs.get_config("nemotron-4-340b").replace(
        n_layers=2, d_model=2304, n_heads=12, n_kv_heads=1, d_ff=9216, vocab_size=4096,
        dtype="float32", param_dtype="float32")


@pytest.mark.gpu
def test_nemotron_width_cut_on_the_card_matches_cpu(cuda):
    # prefill of 60 tokens into a 62-slot cache, then 4 decode steps: the
    # last two write past the last slot, as the reference's clamped write
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map

    cfg = nemotron_width_cut()
    assert cfg.head_dim_ == 192
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (1, 60), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    caches = {"cpu": init_cache(cfg, 1, 62), "cuda": init_cache(cfg, 1, 62, device=cuda)}
    want, _ = prefill(params, cfg, toks, caches["cpu"])
    got, _ = prefill(on_card, cfg, toks.to(cuda), caches["cuda"])
    for _ in range(4):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
        tok = want.argmax(-1)[:, None]
        want, _ = decode_step(params, cfg, tok, caches["cpu"])
        got, _ = decode_step(on_card, cfg, tok.to(cuda), caches["cuda"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    assert caches["cuda"]["len"] == 64
    counts = launch_counts()
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0


# -- K5/K6 above the built head dims: the pieces kernel -------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [256, 320])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", [
    (1, 300, 300, 8, 2, True, 0),
    (2, 129, 129, 4, 4, True, 64),
    (1, 127, 200, 6, 1, False, 0),
])
def test_cuda_flash_attention_above_the_built_head_dims(cuda, dtype, hd, b, sq, sk, h, kv,
                                                        causal, window):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(hd + sq)
    q = _randn(g, (b, sq, h, hd), cuda, dtype)
    k, v = _randn(g, (b, sk, kv, hd), cuda, dtype), _randn(g, (b, sk, kv, hd), cuda, dtype)
    assert flash_attention.route(dtype, hd) == flash_attention.PIECES_KERNEL
    reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    assert launch_counts()["flash_attention"] == 1 and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [256, 320])
@pytest.mark.parametrize("b,smax,clen,h,kv,window", [
    (1, 512, 500, 16, 8, 0),
    (2, 300, 257, 40, 1, 0),     # 40 q heads of one KV head: two blocks of rows
    (1, 512, 300, 8, 8, 128),
    (1, 64, 0, 4, 2, 0),         # an empty cache: zeros
])
def test_cuda_decode_attention_above_the_built_head_dims(cuda, dtype, hd, b, smax, clen, h, kv,
                                                         window):
    g = torch.Generator().manual_seed(hd + clen)
    q = _randn(g, (b, 1, h, hd), cuda, dtype)
    kc = _randn(g, (2, b, smax, kv, hd), cuda, dtype)[1]  # a strided view, as a layer's cache
    vc = _randn(g, (2, b, smax, kv, hd), cuda, dtype)[1]
    got = decode_attention.decode_attention(q, kc, vc, clen, window=window)
    if clen == 0:
        assert not got.any()
        return
    want = ref.decode_attention_ref(q, kc, vc, clen, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


# -- K5/K6 at head dims the kernels are not built for ------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [24, 96])
def test_cuda_attention_at_unbuilt_head_dims(cuda, dtype, hd):
    # zero-padded to the next built head dim (32, 128), scaled by the true one
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(hd)
    q = _randn(g, (2, 200, 8, hd), cuda, dtype)
    k, v = _randn(g, (2, 200, 2, hd), cuda, dtype), _randn(g, (2, 200, 2, hd), cuda, dtype)
    reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=True, window=0)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v).float(),
                               **_tol(dtype, ATTN_BF16_TOL))
    kc = _randn(g, (2, 2, 300, 2, hd), cuda, dtype)[1]
    vc = _randn(g, (2, 2, 300, 2, hd), cuda, dtype)[1]
    got = decode_attention.decode_attention(q[:, :1], kc, vc, 257)
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q[:, :1], kc, vc, 257).float(),
                               **_tol(dtype, ATTN_BF16_TOL))
    counts = launch_counts()
    assert counts["flash_attention"] == counts["decode_attention"] == 1


# -- the session's checkpoints on the card -------------------------------------------------

CPU_RTOL = 1e-4  # card vs CPU checksums (chip_smoke.py): reduction order, sin/log1p ulps


def _stream_system(device, **kw):
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    if device is not None:
        kw["device"] = device
    system = StreamSystem(base_batch=256, **kw)
    for df in riot_workload() + kernel_flows():
        system.submit(df)
    return system


def _digests(system):
    return {n: system.sink_digests(n) for n in sorted(system.manager.submitted)}


def _assert_close_digests(got, want, rel=CPU_RTOL):
    assert got.keys() == want.keys()
    for sub, sinks in want.items():
        for sink, dg in sinks.items():
            assert got[sub][sink]["count"] == dg["count"], (sub, sink)
            assert got[sub][sink]["checksum"] == pytest.approx(dg["checksum"], rel=rel), (sub, sink)


@pytest.mark.gpu
def test_cuda_checkpoint_round_trips_bit_exact(cuda):
    from repro_torch.runtime.system import StreamSystem

    system = _stream_system(cuda)
    system.run(2)
    system.fuse()
    system.run(1)
    payload = system.checkpoint_payload()
    restored = StreamSystem.from_payload(payload, device=cuda)
    assert restored.checkpoint_payload() == payload
    assert restored.backend.template_fallbacks == 0
    system.run(2)
    restored.run(2)
    assert _digests(restored) == _digests(system)


@pytest.mark.gpu
def test_cuda_checkpoints_restore_across_devices(cuda):
    from repro_torch.runtime.system import StreamSystem

    for src, dst in ((cuda, "cpu"), ("cpu", cuda)):
        system = _stream_system(src)
        system.run(2)
        system.fuse()
        restored = StreamSystem.from_payload(system.checkpoint_payload(), device=dst)
        assert restored.backend.template_fallbacks == 0
        system.run(2)
        restored.run(2)
        _assert_close_digests(_digests(restored), _digests(system))


@pytest.mark.gpu
def test_cuda_defragment_after_fuse_keeps_fused_equal_unfused(cuda):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    def run(fuse):
        system = _stream_system(cuda)
        system.run(2)
        if fuse:
            system.fuse()
        system.run(1)
        system.remove("urban_etl")
        system.defragment()
        system.run(2)
        return _digests(system)

    reset_launch_counts()
    fused = run(True)
    assert launch_counts()["map_chain"] > 0 and launch_counts()["affine_rmsnorm"] > 0
    assert fused == run(False)


@pytest.mark.gpu
def test_cuda_background_checkpoints_hold_the_state_of_their_step(cuda, tmp_path):
    # the writer copies each step's state to the host after that step ran,
    # while later steps go on; every checkpoint restores to its step's digests
    from repro_torch.runtime.checkpoint import CheckpointStore
    from repro_torch.runtime.system import StreamSystem

    system = _stream_system(cuda, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                            checkpoint_background=True)
    at_step = {}
    for _ in range(5):
        system.step()
        at_step[system.backend.step_count] = _digests(system)
    system.close()
    store = CheckpointStore(str(tmp_path))
    assert store.list_ids() == [1, 2, 3, 4, 5]
    for cid in store.list_ids():
        restored = StreamSystem.restore(store.path_of(cid), device=cuda)
        assert restored.backend.step_count == cid
        assert _digests(restored) == at_step[cid]


# -- the captured step: CUDA graphs of each segment against the eager step -----------------

REMOVED = ("urban_etl", "taxi_pred_lr", "FA")  # chip_smoke.py's removals


def _phase3(cuda, capture, fuse, batch=1024, **stepping):
    """chip_smoke.py's phase-3 script: 3 steps, [fuse()], 3 steps, remove
    three flows, 2 steps; ``stepping`` are StreamSystem's step_mode and
    max_workers. Returns (digests, system)."""
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    system = StreamSystem(backend=TorchBackend(cuda, capture=capture), base_batch=batch,
                          **stepping)
    flows = riot_workload() + kernel_flows()
    for df in flows:
        system.submit(df)
    system.run(3)
    if fuse:
        assert system.fuse()
    system.run(3)
    for name in REMOVED:
        system.remove(name)
    system.run(2)
    return {df.name: system.sink_digests(df.name) for df in flows if df.name not in REMOVED}, system


def _sink_states(system):
    """(count, checksum) of every deployed sink, paused ones included."""
    out = {}
    for seg in system.backend.segments.values():
        for tid, op in seg.operators.items():
            if op.is_sink:
                st = seg.states[tid]
                out[tid] = (int(st["count"]), float(st["checksum"]))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_captured_step_is_bitwise_the_eager_step(cuda, fuse):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    captured, system = _phase3(cuda, capture=True, fuse=fuse)
    captured_launches = launch_counts()
    reset_launch_counts()
    eager, eager_system = _phase3(cuda, capture=False, fuse=fuse)
    assert captured == eager
    # replays count the launches their capture recorded: the same kernels ran
    assert captured_launches == launch_counts()
    assert captured_launches["kalman_scan"] > 0
    assert (captured_launches["map_chain"] > 0) == fuse
    stats = system.backend.capture_stats
    assert stats.graphs > 0 and stats.replays > 0
    for name, seg in system.backend.segments.items():
        assert seg.graphs.graphs, f"segment {name} never replayed a graph"
    assert all(seg.graphs is None for seg in eager_system.backend.segments.values())
    assert eager_system.backend.capture_stats.graphs == 0


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["signature", "none"])
def test_pause_resume_and_kill_under_capture_keep_the_eager_digests(cuda, strategy):
    # signature: remove() pauses, and a later resume picks the graph of the
    # earlier flags again; none (Default): remove() kills the segments
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    def run(capture):
        system = StreamSystem(strategy=strategy, backend=TorchBackend(cuda, capture=capture),
                              base_batch=256)
        for df in riot_workload() + kernel_flows():
            system.submit(df)
        system.run(3)
        terminated = set()
        for name in REMOVED:
            terminated |= set(system.remove(name).terminated_tasks)
        system.run(2)
        graphs = system.backend.capture_stats.graphs
        if strategy == "signature":
            system.backend.resume(terminated)
        system.run(2)
        return _sink_states(system), graphs, system

    captured, graphs_before, system = run(True)
    eager, _, _ = run(False)
    assert captured == eager
    if strategy == "signature":
        # the resumed flags are the first pattern's: its graph, not a new one
        assert system.backend.capture_stats.graphs == graphs_before


@pytest.mark.gpu
def test_restore_on_a_capturing_backend_captures_afresh(cuda):
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.runtime.system import StreamSystem

    captured = _stream_system(cuda)
    eager = _stream_system(None, backend=TorchBackend(cuda, capture=False))
    for system in (captured, eager):
        system.run(2)
        system.fuse()
        system.run(1)
    restored = StreamSystem.from_payload(captured.checkpoint_payload(), device=cuda)
    for system in (restored, eager):
        system.run(3)
    assert _digests(restored) == _digests(eager)
    assert restored.backend.capture_stats.graphs == len(restored.backend.segments)


@pytest.mark.gpu
def test_donation_report_on_the_card_updates_states_in_place(cuda):
    from repro_torch.runtime.segment import donation_report

    system = _stream_system(cuda)
    system.run(2)
    assert system.fuse()
    system.run(2)
    seg = next(s for s in system.backend.segments.values() if s.spec.fused)
    inputs = {t: system.backend.broker.fetch(t) for t in seg.boundary_topics}
    states = {t: int(st["count"]) for t, st in seg.states.items() if isinstance(st, dict)
              and "count" in st}
    report = donation_report(seg, inputs)
    assert report["fused"] and report["donation_holds"]
    assert report["alias_size_in_bytes"] > 0
    assert report["total_allocation_size"] < (
        report["argument_size_in_bytes"] + report["output_size_in_bytes"]
        + report["temp_size_in_bytes"])
    # the report captures without running: the states keep their values
    assert states == {t: int(st["count"]) for t, st in seg.states.items()
                      if isinstance(st, dict) and "count" in st}
    system.run(1)


@pytest.mark.gpu
def test_a_failed_capture_names_the_segment_and_the_task(cuda):
    # a host sync inside an operator cannot be captured: the step raises
    # and never falls back to the eager step
    from repro_torch.runtime.graphs import CaptureError

    system = _stream_system(cuda)
    system.run(1)  # the eager warm-up
    seg = next(s for s in system.backend.segments.values()
               if any(system.backend.task_defs[t].type == "kalman" for t in s.spec.task_ids))
    tid = next(t for t in seg.spec.task_ids if system.backend.task_defs[t].type == "kalman")
    op = seg.operators[tid]
    inner = op.apply
    op.apply = lambda st, x: (float(x.sum()), inner(st, x))[1]
    with pytest.raises(CaptureError, match=f"segment {seg.name!r}.*task {tid!r}.*'kalman'"):
        system.step()
    op.apply = inner
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_a_cuda_graph_collected_inside_a_capture_does_not_fail_it(cuda):
    # a CUDA graph destroyed inside another graph's capture invalidates it;
    # here one turns into cyclic garbage inside a segment's capture, with the
    # collector set to run at every allocation: the capture holds it off
    import gc

    system = _stream_system(cuda)
    system.run(1)  # the eager warm-up: the next step captures
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    spare = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        x = torch.ones(64, device=cuda)
        spare.capture_begin()
        y = x * 2
        spare.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    spare.replay()
    held = [spare, y]
    del spare, y
    seg = next(s for s in system.backend.segments.values()
               if any(system.backend.task_defs[t].type == "kalman" for t in s.spec.task_ids))
    tid = next(t for t in seg.spec.task_ids if system.backend.task_defs[t].type == "kalman")
    op = seg.operators[tid]
    inner = op.apply
    dropped = []

    def apply(st, x):
        if held and torch.cuda.is_current_stream_capturing():
            cycle = [held.pop(), held.pop()]
            cycle.append(cycle)
            del cycle
            dropped.extend([] for _ in range(64))  # allocations: the collector's turns
        return inner(st, x)

    op.apply = apply
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        system.step()
    finally:
        gc.set_threshold(*threshold)
        op.apply = inner
    assert not held and dropped  # the cycle was made inside the capture
    gc.collect()
    system.run(1)
    torch.cuda.synchronize()


# -- concurrent stepping: segments of a wave on several streams at once ---------------------


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("capture", [True, False])
def test_concurrent_step_is_bitwise_the_sync_step(cuda, capture, fuse):
    # each wave's segments step on several streams at once (on the card
    # issued from the stepping thread); digests and kernel launches are the
    # sync run's, at any width
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    sync, _ = _phase3(cuda, capture=capture, fuse=fuse)
    sync_launches = launch_counts()
    for workers in (None, 4):
        reset_launch_counts()
        waves = []
        conc, system = _phase3(cuda, capture=capture, fuse=fuse, step_mode="concurrent",
                               max_workers=workers, on_wave=waves.append)
        assert conc == sync
        assert launch_counts() == sync_launches
        assert max(len(e.segments) for e in waves) > 1
        if capture:
            for name, seg in system.backend.segments.items():
                assert seg.graphs.graphs, f"segment {name} never replayed a graph"
        system.close()


def _with_gemm(apply):
    """``apply`` whose output batch also carries a product of itself: the
    batch as a (rows, 64) matrix, its (64, rows) by (rows, 64) product, a
    shape cuBLAS may reduce split-K through its workspace. The output
    moves by at most 1e-3, through a ratio of the product's sums."""

    def wrapped(state, *x):
        state, y = apply(state, *x)
        if y is None or y.numel() % 64:
            return state, y
        a = y.reshape(-1, 64)
        p = a.t() @ a
        return state, y + p.trace() / (p.abs().sum() + 1.0) * 1e-3

    return wrapped


@pytest.mark.gpu
def test_concurrent_replays_of_cublas_products_are_bitwise_the_sync_step(cuda):
    # graphs of several segments, each with cuBLAS products, replayed at
    # once on several streams: each graph holds a cuBLAS workspace of its
    # own (runtime/graphs.py); one shared workspace would be raced on
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    def run(**stepping):
        system = StreamSystem(backend=TorchBackend(cuda), base_batch=16384, **stepping)
        for df in riot_workload() + kernel_flows():
            system.submit(df)
        wrapped = {}
        for seg in system.backend.segments.values():
            for op in seg.operators.values():
                if id(op) not in wrapped:
                    wrapped[id(op)] = op
                    op.apply = _with_gemm(op.apply)
        system.run(6)
        system.close()
        return _sink_states(system), system.backend

    sync, backend = run()
    assert backend.capture_stats.graphs >= len(backend.segments)
    for workers in (None, 4):
        conc, backend = run(step_mode="concurrent", max_workers=workers)
        assert max(len(w) for w in backend.segment_waves()) > 1
        assert conc == sync


@pytest.mark.gpu
def test_launch_counts_equal_in_the_four_modes(cuda):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    counts = {}
    for capture in (True, False):
        for mode in ("sync", "concurrent"):
            reset_launch_counts()
            _, system = _phase3(cuda, capture=capture, fuse=True, batch=256, step_mode=mode)
            counts[(capture, mode)] = launch_counts()
            system.close()
    first = next(iter(counts.values()))
    assert all(c == first for c in counts.values()), counts
    assert all(first[k] > 0 for k in ("rmsnorm", "map_chain", "affine_rmsnorm", "kalman_scan"))


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["signature", "none"])
def test_pause_resume_and_kill_in_concurrent_mode_keep_the_sync_digests(cuda, strategy):
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    def run(step_mode):
        system = StreamSystem(strategy=strategy, backend=TorchBackend(cuda), base_batch=256,
                              step_mode=step_mode, max_workers=4)
        for df in riot_workload() + kernel_flows():
            system.submit(df)
        system.run(3)
        terminated = set()
        for name in REMOVED:
            terminated |= set(system.remove(name).terminated_tasks)
        system.run(2)
        if strategy == "signature":
            system.backend.resume(terminated)
        system.run(2)
        system.close()
        return _sink_states(system)

    assert run("concurrent") == run("sync")


@pytest.mark.gpu
def test_a_failed_capture_in_concurrent_mode_names_its_task(cuda):
    import re

    from repro_torch.runtime.graphs import CaptureError

    system = _stream_system(cuda, step_mode="concurrent", max_workers=4)
    system.run(1)  # the eager warm-ups
    backend = system.backend
    seg = next(s for s in backend.segments.values()
               if any(backend.task_defs[t].type == "kalman" for t in s.spec.task_ids))
    tid = next(t for t in seg.spec.task_ids if backend.task_defs[t].type == "kalman")
    op = seg.operators[tid]  # shared by every segment of this structure
    inner = op.apply
    op.apply = lambda st, x: (float(x.sum()), inner(st, x))[1]
    with pytest.raises(CaptureError) as info:
        system.step()
    op.apply = inner
    torch.cuda.synchronize()
    found = re.search(r"segment '([^']+)' failed in task '([^']+)' \(operator 'kalman'\)",
                      str(info.value))
    assert found, str(info.value)
    name, task = found.groups()
    assert task in backend.segments[name].spec.task_ids
    assert backend.segments[name].operators[task] is op
    system.close()


# -- the worker-process plane on the card ---------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("step_mode,workers,chains", [("sync", 2, False), ("concurrent", 3, True)])
def test_multiproc_workers_on_the_card_are_bitwise_the_torch_backend(cuda, step_mode, workers,
                                                                    chains):
    # the RIoT and kernel flows at base_batch 256: 3 steps, fuse() (every
    # chain accepted, so both fuse the same segments), 2 steps; the workers
    # step through CUDA graphs on the card, boundary batches over shm
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.runtime.worker import MultiprocBackend

    runs = {}
    for plane in ("torch", "multiproc"):
        reset_launch_counts()
        if plane == "torch":
            system = _stream_system(cuda, step_mode=step_mode)
        else:
            backend = MultiprocBackend(workers=workers, chain_batching=chains, device=str(cuda))
            system = _stream_system(None, backend=backend, step_mode=step_mode)
        system.run(3)
        assert system.fuse(overhead_ms=1e9)
        system.run(2)
        counts = launch_counts() if plane == "torch" else system.backend.launch_counts()
        runs[plane] = (_digests(system), counts)
        if plane == "multiproc":
            memory = system.backend.worker_memory()
            assert sorted(memory) == list(range(workers))
            assert all(m["graphs"] > 0 and m["reserved"] > 0 for m in memory.values())
        system.close()
    assert runs["multiproc"] == runs["torch"]
    assert runs["torch"][1]["kalman_scan"] > 0 and runs["torch"][1]["affine_rmsnorm"] > 0


# -- the cluster plane, the host transports and the sharded backend on the card --------------


def _riot_script(system, fuse_overhead=None):
    """The RIoT and kernel flows at base_batch 256: 3 steps, fuse(), 2 steps."""
    system.run(3)
    assert system.fuse() if fuse_overhead is None else system.fuse(overhead_ms=fuse_overhead)
    system.run(2)
    return _digests(system)


@pytest.mark.gpu
@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_torch_backend_over_host_transports_is_bitwise_inproc(cuda, transport):
    # each boundary batch crosses the host through pinned staging; the
    # captured graphs still read it from their static input buffers
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    runs = {}
    for t in ("inproc", transport):
        reset_launch_counts()
        system = _stream_system(cuda, transport=t)
        runs[t] = (_riot_script(system), launch_counts())
        assert system.backend.capture_stats.graphs > 0
        system.close()
    assert runs[transport] == runs["inproc"]


@pytest.mark.gpu
@pytest.mark.parametrize("step_mode", ["sync", "concurrent"])
def test_sharded_over_two_slots_of_one_card_is_bitwise_torch(cuda, step_mode):
    from repro_torch.runtime.sharded import ShardedBackend

    want = _riot_script(_stream_system(cuda, step_mode=step_mode))
    backend = ShardedBackend(devices=[cuda, cuda], step_mode=step_mode)
    system = _stream_system(None, backend=backend)
    assert _riot_script(system) == want
    assert set(backend.device_of.values()) == {0, 1}
    # a move between two slots of one card keeps the captured graphs
    name = next(iter(backend.segments))
    seg = backend.segments[name]
    graphs = seg.graphs
    old = backend.device_of[name]
    backend._move_segment(seg, old, 1 - old)
    backend.device_of[name] = 1 - old
    assert seg.graphs is graphs
    system.run(1)
    system.close()


@pytest.mark.gpu
def test_sharded_without_devices_takes_every_card(cuda):
    from repro_torch.runtime.sharded import ShardedBackend

    backend = ShardedBackend()
    assert backend.devices == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.gpu
@pytest.mark.parametrize("snapshot_mode", ["spill", "wire"])
def test_supervised_pool_on_the_card_survives_a_kill_bitwise(cuda, snapshot_mode):
    # a worker killed between two steps: the next step's RPC fails and the
    # in-step path respawns it and redeploys its segments from the spill
    # file (or the wire snapshot); the digests are the uninterrupted run's
    import os
    import signal

    from repro_torch.cluster.events import WORKER_RESPAWNED
    from repro_torch.runtime.worker import MultiprocBackend

    runs = {}
    for kill in (False, True):
        backend = MultiprocBackend(workers=2, device=str(cuda))
        system = _stream_system(None, backend=backend,
                                supervise={"heartbeat_interval": 30.0,
                                           "snapshot_mode": snapshot_mode})
        system.run(3)
        assert system.fuse(overhead_ms=1e9)
        system.run(1)
        if kill:
            os.kill(backend._procs[1].pid, signal.SIGKILL)
        system.run(2)
        runs[kill] = _digests(system)
        if kill:
            assert backend.respawns and WORKER_RESPAWNED in [e.kind for e in backend.worker_events]
        system.close()
    assert runs[True] == runs[False]


# -- the moe family and LM reuse-serving on the card -------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_at_mixtrals_layout_with_a_window_that_masks(cuda, dtype):
    # mixtral-8x22b's heads (48 over 8 KV heads of 128: a GQA group of 6)
    # with a window of 1024, which masks at a prompt of 2048 and a cache
    # holding 3000 (mixtral's own 4096 window never bites at 2048)
    g = torch.Generator().manual_seed(11)
    q = _randn(g, (1, 2048, 48, 128), cuda, dtype)
    k, v = _randn(g, (1, 2048, 8, 128), cuda, dtype), _randn(g, (1, 2048, 8, 128), cuda, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=True, window=1024)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=1024)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))
    q1 = _randn(g, (1, 1, 48, 128), cuda, dtype)
    kc = _randn(g, (2, 1, 4096, 8, 128), cuda, dtype)[1]
    vc = _randn(g, (2, 1, 4096, 8, 128), cuda, dtype)[1]
    got = decode_attention.decode_attention(q1, kc, vc, 3000, window=1024)
    want = ref.decode_attention_ref(q1, kc, vc, 3000, window=1024)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


def _moe_cfg():
    from repro_torch import configs
    from repro_torch.models import MoEConfig

    return configs.get_smoke_config("mixtral-8x22b").replace(
        d_model=256, n_heads=8, n_kv_heads=2,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=512, capacity_factor=1.25))


@pytest.mark.gpu
def test_moe_layer_on_the_card_matches_cpu_with_drops(cuda):
    from repro_torch.models import mlp
    from repro_torch.models.transformer import tree_map

    cfg = _moe_cfg()
    g = torch.Generator().manual_seed(5)
    p = tree_map(lambda t: t[0], mlp.moe_params(g, cfg, torch.float32, 1))
    # inputs and a router that send most tokens to experts 0 and 1, so the
    # capacity of C = 2·T/8·1.25 slots drops tokens
    v = torch.randn((cfg.d_model,), generator=g)
    v /= v.norm()
    x = torch.randn((2, 96, cfg.d_model), generator=g) + 2.0 * v
    p["router"][:, 0] += 4.0 * v
    p["router"][:, 1] += 3.2 * v
    on_card = tree_map(lambda t: t.to(cuda), p)
    want = mlp.moe_layer(p, x, cfg)
    got = mlp.moe_layer(on_card, x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    routes = {}
    for name, params, xs in (("cpu", p, x), ("cuda", on_card, x.to(cuda))):
        _, _, idx = mlp._route(params, xs.reshape(-1, cfg.d_model), cfg.moe.top_k)
        routes[name] = (idx.cpu(), mlp.dispatch(cfg, idx)[1].cpu())
    assert torch.equal(routes["cpu"][0], routes["cuda"][0])
    assert torch.equal(routes["cpu"][1], routes["cuda"][1]) and not routes["cpu"][1].all()


@pytest.mark.gpu
def test_moe_serving_path_on_the_card_matches_cpu(cuda):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map

    cfg = _moe_cfg().replace(swa_window=16)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    caches = {"cpu": init_cache(cfg, 1, 64), "cuda": init_cache(cfg, 1, 64, device=cuda)}
    want, _ = prefill(params, cfg, toks, caches["cpu"])
    got, _ = prefill(on_card, cfg, toks.to(cuda), caches["cuda"])
    for _ in range(3):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = want.argmax(-1)[:, None]
        want, _ = decode_step(params, cfg, tok, caches["cpu"])
        got, _ = decode_step(on_card, cfg, tok.to(cuda), caches["cuda"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    counts = launch_counts()
    for name in ("rmsnorm", "rmsnorm_residual", "flash_attention", "decode_attention"):
        assert counts[name] > 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("type_name,cfg,width", [
    ("lm_embed", {"model": "m", "d": 256}, 8),
    ("lm_stage", {"model": "m", "layers": "0-3", "d": 256}, 256),
    ("lm_head", {"model": "m", "adapter": "a", "d": 256}, 256),
])
def test_lm_operators_on_the_card_match_cpu(cuda, type_name, cfg, width):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.ops.base import make_operator
    from repro_torch.serve import model_ops  # noqa: F401 — registers the lm_* types

    x = torch.randn((64, width), generator=torch.Generator().manual_seed(6))
    ops = {d: make_operator(type_name, cfg, d) for d in ("cpu", cuda)}
    assert ops[cuda].type == type_name
    reset_launch_counts()
    _, got = ops[cuda].apply((), x.to(cuda))
    _, want = ops["cpu"].apply((), x)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    counts = launch_counts()
    assert counts["rmsnorm"] > 0
    if type_name != "lm_embed":  # the residual adds that feed a norm run K4
        assert counts["rmsnorm_residual"] == (3 if type_name == "lm_stage" else 1)


@pytest.mark.gpu
def test_reuse_serving_on_the_card_is_bitwise_across_strategies(cuda):
    from repro_torch.serve import ReuseServing, TenantPipeline

    runs = {}
    for strategy in ("none", "signature"):
        rs = ReuseServing(strategy=strategy, base_batch=32, device=cuda)
        for i in range(4):
            rs.add_tenant(TenantPipeline(tenant=f"t{i}", stream=("urban", "meter")[i % 2],
                                         shared_stages=2, n_stages=3, d=256,
                                         layers_per_stage=2))
        rs.run(3)
        rs.remove_tenant("t1")
        rs.run(2)
        runs[strategy] = {t: rs.tenant_output(t) for t in sorted(rs.tenants)}
        rs.system.close()
    assert runs["none"] == runs["signature"]
    cpu = ReuseServing(strategy="signature", base_batch=32, device="cpu")
    for i in range(4):
        cpu.add_tenant(TenantPipeline(tenant=f"t{i}", stream=("urban", "meter")[i % 2],
                                      shared_stages=2, n_stages=3, d=256, layers_per_stage=2))
    cpu.run(3)
    cpu.remove_tenant("t1")
    cpu.run(2)
    for t, sinks in runs["signature"].items():
        for sink, dg in cpu.tenant_output(t).items():
            assert sinks[sink]["count"] == dg["count"]
            assert abs(sinks[sink]["checksum"] - dg["checksum"]) <= 1e-4 * max(1.0, abs(dg["checksum"]))
    cpu.system.close()


# -- the MLA, vlm and audio families: K5's routes (a)-(c), K6's cross decode -----------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,h,hd,hd_v", [
    (300, 8, 192, 128),    # MLA's head dims (deepseek-v2: 128 heads)
    (129, 4, 24, 16),      # the SMOKE config's: v padded to 24, then all to 32
    (2047, 16, 192, 128),
])
def test_cuda_flash_attention_route_a_smaller_v_head_dim(cuda, dtype, sq, h, hd, hd_v):
    g = torch.Generator().manual_seed(sq)
    q = _randn(g, (1, sq, h, hd), cuda, dtype)
    k = _randn(g, (1, sq, h, hd), cuda, dtype)
    v = _randn(g, (1, sq, h, hd_v), cuda, dtype)
    scale = hd ** -0.5 * 0.9  # passed, as MLA passes (nope + rope)^-0.5
    got = flash_attention.flash_attention(q, k, v, causal=True, scale=scale)
    assert got.shape == (1, sq, h, hd_v)
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,h,kv,hd", [
    (1024, 1024, 16, 16, 64),  # (b) the seamless encoder, no mask
    (300, 1000, 4, 4, 64),     # (c) Sk not a multiple of 64, a ragged q tile
    (159, 1024, 64, 8, 128),   # (c) llama's cross-attention, a 159-token prompt
    (2048, 1024, 16, 2, 128),
    (1000, 77, 8, 8, 64),      # more queries than keys, a ragged K/V tile
])
def test_cuda_flash_attention_without_a_mask(cuda, dtype, sq, sk, h, kv, hd):
    g = torch.Generator().manual_seed(sq + sk)
    q = _randn(g, (1, sq, h, hd), cuda, dtype)
    k, v = _randn(g, (1, sk, kv, hd), cuda, dtype), _randn(g, (1, sk, kv, hd), cuda, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sm,h,kv,hd", [(1024, 64, 8, 128), (1000, 16, 16, 64), (16, 4, 2, 16)])
def test_cuda_decode_attention_over_a_cross_memory(cuda, dtype, sm, h, kv, hd):
    # one decoded token against the whole memory: cache_len = Sm
    g = torch.Generator().manual_seed(sm)
    q = _randn(g, (1, 1, h, hd), cuda, dtype)
    kc, vc = _randn(g, (1, sm, kv, hd), cuda, dtype), _randn(g, (1, sm, kv, hd), cuda, dtype)
    got = decode_attention.decode_attention(q, kc, vc, sm)
    want = ref.decode_attention_ref(q, kc, vc, sm)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, ATTN_BF16_TOL))
    lib = ref.flash_attention_ref(q, kc, vc, causal=False)  # the same function
    torch.testing.assert_close(got.float(), lib.float(), **_tol(dtype, ATTN_BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama-3.2-vision-90b", "seamless-m4t-medium"])
def test_attention_families_on_the_card_match_cpu(cuda, arch):
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map

    cfg = configs.get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    if cfg.family == "vlm":  # 0 at init: the cross blocks would add nothing
        params["cross_blocks"]["attn"]["gate"].fill_(0.8)
    on_card = tree_map(lambda t: t.to(cuda), params)
    ml = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(cfg.family, 0)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 40))).long()
    mem = torch.from_numpy(rng.standard_normal((1, ml, cfg.d_model)).astype(np.float32)) if ml else None
    reset_launch_counts()
    caches = {d: init_cache(cfg, 1, 64, memory_len=ml, device=d) for d in ("cpu", cuda)}
    want, _ = prefill(params, cfg, toks, caches["cpu"], memory=mem)
    got, _ = prefill(on_card, cfg, toks.to(cuda), caches[cuda],
                     memory=None if mem is None else mem.to(cuda))
    for _ in range(3):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = want.argmax(-1)[:, None]
        want, _ = decode_step(params, cfg, tok, caches["cpu"])
        got, _ = decode_step(on_card, cfg, tok.to(cuda), caches[cuda])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    counts = launch_counts()
    # MLA decodes in the absorbed form, plain products over the latent
    # cache: no K6 on its path
    needed = ("flash_attention",) + (("decode_attention",) if cfg.mla is None else ()) + (
        ("rmsnorm", "rmsnorm_residual") if cfg.norm == "rmsnorm" else ())
    for name in needed:
        assert counts[name] > 0, name


# -- the ssm family's scans (mlstm.cu, slstm.cu) -------------------------------------------
# Both sum in float32, as their plain versions do from the same inputs; their
# tensor-core products take each float32 operand as bf16 terms (2^-16 or
# about 2^-24 relative): held at 1e-4 of the largest |value| of each output,
# as K7.


def _mlstm_case(g, b, s, nh, p, dev, dtype, with_state):
    q, k, v = (_randn(g, (b, s, nh, p), dev, dtype) for _ in range(3))
    ig, fg = (torch.randn((b, s, nh), generator=g).to(dev) for _ in range(2))
    state = None
    if with_state:  # the state of 9 positions of the plain scan
        pre = [_randn(g, (b, 9, nh, p), dev, torch.float32) for _ in range(3)]
        pre += [torch.randn((b, 9, nh), generator=g).to(dev) for _ in range(2)]
        state = ref.mlstm_scan_ref(*pre, chunk=4)[1]
    return q, k, v, ig, fg, state


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,p,chunk,with_state", [
    (1, 1, 1, 8, 8, False),        # one position
    (2, 37, 4, 16, 8, False),      # xlstm SMOKE's widths, ragged
    (2, 37, 4, 16, 8, True),
    (1, 64, 2, 40, 16, False),     # P no multiple of the 32-column tiles
    (1, 130, 4, 1024, 64, True),   # xlstm-1.3b's widths: 32 blocks a head
    (3, 100, 2, 64, 64, False),
    (1, 50, 2, 2048, 32, False),   # wider than a block of 32 rows of C fits
])
def test_cuda_mlstm_scan(cuda, dtype, b, s, nh, p, chunk, with_state):
    from repro_torch.kernels import mlstm

    g = torch.Generator().manual_seed(s + p)
    q, k, v, ig, fg, state = _mlstm_case(g, b, s, nh, p, cuda, dtype, with_state)
    got_y, got_state = mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk, state=state)
    want_y, want_state = ref.mlstm_scan_ref(q, k, v, ig, fg, chunk, state)
    assert got_y.dtype == torch.float32 and got_y.shape == (b, s, nh, p)
    _assert_rel(got_y, want_y)
    for got, want in zip(got_state, want_state):
        _assert_rel(got, want)


@pytest.mark.gpu
def test_cuda_mlstm_scan_takes_strided_gates_and_counts_one_launch(cuda):
    # the mLSTM block hands over the gates as the two halves of one product
    from repro_torch.kernels import mlstm
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(21)
    q, k, v, _, _, _ = _mlstm_case(g, 2, 70, 4, 32, cuda, torch.bfloat16, False)
    gates = torch.randn((2, 70, 8), generator=g).to(cuda, torch.bfloat16)
    reset_launch_counts()
    got = mlstm.mlstm_scan(q, k, v, gates[..., :4], gates[..., 4:], chunk=16)
    assert launch_counts()["mlstm_scan"] == 1
    want = mlstm.mlstm_scan(q, k, v, gates[..., :4].contiguous(), gates[..., 4:].contiguous(),
                            chunk=16)
    assert torch.equal(got[0], want[0])
    with pytest.raises(ValueError, match="chunk"):  # every chunk from 1 up runs (the general route)
        mlstm.mlstm_scan(q, k, v, gates[..., :4], gates[..., 4:], chunk=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hd,with_state", [
    (1, 1, 1, 16, False),
    (2, 37, 4, 16, True),          # xlstm SMOKE's widths
    (2, 29, 3, 40, False),         # hd no multiple of a warp
    (1, 300, 4, 512, True),        # xlstm-1.3b's widths
])
def test_cuda_slstm_scan(cuda, dtype, b, s, nh, hd, with_state):
    from repro_torch.kernels import slstm
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(s + hd)
    xg = _randn(g, (b, s, 4 * nh * hd), cuda, dtype)
    r = (torch.randn((4, nh, hd, hd), generator=g) * hd ** -0.5).to(cuda, dtype)
    state = None
    if with_state:
        state = tuple(torch.randn((b, nh, hd), generator=g).to(cuda) for _ in range(2))
        state += (torch.rand((b, nh, hd), generator=g).to(cuda) + 0.5,
                  torch.randn((b, nh), generator=g).to(cuda))
    reset_launch_counts()
    got_h, got_state = slstm.slstm_scan(xg, r, state=state)
    assert launch_counts()["slstm_scan"] == 1
    want_h, want_state = ref.slstm_scan_ref(xg, r, state)
    assert got_h.dtype == torch.float32 and got_h.shape == (b, s, nh, hd)
    _assert_rel(got_h, want_h)
    for got, want in zip(got_state, want_state):
        _assert_rel(got, want)


# the routes of the cluster build (kernels/slstm.py:plan): hd 1024 streams R
# from L2 in either dtype; B nh = 32 clusters of 16 blocks on the tensor
# route run in waves; R in f32 at hd 512 streams beside bf16 xg
@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,xg_dtype,r_dtype,route", [
    (1, 40, 2, 1024, torch.float32, torch.float32, "streaming"),
    (1, 40, 2, 1024, torch.bfloat16, torch.bfloat16, "streaming"),
    (4, 24, 8, 512, torch.bfloat16, torch.bfloat16, "tensor"),
    (1, 64, 4, 512, torch.bfloat16, torch.float32, "streaming"),
])
def test_cuda_slstm_scan_routes(cuda, b, s, nh, hd, xg_dtype, r_dtype, route):
    from repro_torch.kernels import slstm

    assert slstm.plan(hd, r_dtype).route == route
    if b * nh > 8:  # more clusters than the card places at once: waves
        assert b * nh > slstm.max_active_clusters(hd, xg_dtype, r_dtype) >= 1
    g = torch.Generator().manual_seed(hd + b)
    xg = _randn(g, (b, s, 4 * nh * hd), cuda, xg_dtype)
    r = (torch.randn((4, nh, hd, hd), generator=g) * hd ** -0.5).to(cuda, r_dtype)
    state = tuple(torch.randn((b, nh, hd), generator=g).to(cuda) for _ in range(2))
    state += (torch.rand((b, nh, hd), generator=g).to(cuda) + 0.5,
              torch.randn((b, nh), generator=g).to(cuda))
    got_h, got_state = slstm.slstm_scan(xg, r, state=state)
    want_h, want_state = ref.slstm_scan_ref(xg, r, state)
    _assert_rel(got_h, want_h)
    for got, want in zip(got_state, want_state):
        _assert_rel(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mlstm_scan_short_chunk_wide_from_a_state(cuda, dtype):
    # a chunk below 64 at xlstm-1.3b's P: 16-row tiles half used, ragged S
    from repro_torch.kernels import mlstm

    g = torch.Generator().manual_seed(77)
    q, k, v, ig, fg, state = _mlstm_case(g, 1, 77, 2, 1024, cuda, dtype, True)
    got_y, got_state = mlstm.mlstm_scan(q, k, v, ig, fg, chunk=24, state=state)
    want_y, want_state = ref.mlstm_scan_ref(q, k, v, ig, fg, 24, state)
    _assert_rel(got_y, want_y)
    for got, want in zip(got_state, want_state):
        _assert_rel(got, want)


# The shapes the scans' first builds refused, each now on a kernel route and
# held to its plain version at SSD_REL: the sLSTM above hd 1024 (the
# streaming route with 4 and 8 columns a lane), the mLSTM above the tensor
# route's shared memory (P 2304 in f32 still fits it; 2560 in f32 and
# 2880, 3200 in bf16 take the general route) and with chunks above 64 (one
# stabilizer a chunk), S no multiple of the chunk, forget gates biased open;
# above hd 4096 the sLSTM
# still raises, with no fallback to the plain version.
@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    ("slstm", 1040, torch.float32), ("slstm", 2048, torch.bfloat16), ("slstm", 4097, torch.float32),
    ("mlstm_p", 2304, torch.float32), ("mlstm_p", 2560, torch.float32),
    ("mlstm_p", 2880, torch.bfloat16), ("mlstm_p", 3200, torch.bfloat16),
    ("mlstm_chunk", 96, torch.float32), ("mlstm_chunk", 128, torch.bfloat16),
])
def test_cuda_scans_refuse_shapes_they_do_not_take(cuda, case):
    from repro_torch.kernels import mlstm, slstm

    kind, size, dtype = case
    g = torch.Generator().manual_seed(size)
    if kind == "slstm":
        if size > slstm.MAX_HEAD_DIM:
            with pytest.raises(ValueError, match="head dim"):
                slstm.slstm_scan(torch.zeros((1, 2, 4 * size), device=cuda),
                                 torch.zeros((4, 1, size, size), device=cuda))
            return
        xg = _randn(g, (1, 24, 4 * size), cuda, dtype)
        r = (torch.randn((4, 1, size, size), generator=g) * size ** -0.5).to(cuda, dtype)
        assert slstm.plan(size, dtype).route == "streaming"
        got_h, got_state = slstm.slstm_scan(xg, r)
        want_h, want_state = ref.slstm_scan_ref(xg, r)
    else:
        p, chunk, s = (size, 64, 100) if kind == "mlstm_p" else (256, size, 3 * size - 17)
        q, k, v, ig, fg, state = _mlstm_case(g, 1, s, 2, p, cuda, dtype, True)
        # forget gates biased open, as xLSTM initialises them: log sigmoid of
        # N(0, 1) sums to about -100 over 128 positions, past which exp(-m)
        # underflows f32 and both versions give 0 / 0 at a chunk's first rows
        fg = fg + 3.0
        assert mlstm.route(p, chunk, dtype) == ("tensor cores" if (p, dtype) == (2304, torch.float32)
                                                else "general")
        got_h, got_state = mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk, state=state)
        want_h, want_state = ref.mlstm_scan_ref(q, k, v, ig, fg, chunk, state)
    _assert_rel(got_h, want_h)
    for got, want in zip(got_state, want_state):
        _assert_rel(got, want)


@pytest.mark.gpu
def test_cuda_scan_plans_match_the_sources(cuda):
    # the host's plans size shared memory as the CUDA sources do
    from repro_torch.kernels import build, mlstm, slstm

    lib = build.library()
    for hd in (16, 40, 300, 512, 640, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            pl = slstm.plan(hd, dtype)
            assert lib.rt_slstm_smem(hd, pl.cols, int(pl.tensor)) == pl.smem
    for p in (8, 40, 1024, 2048):
        for dtype in (torch.float32, torch.bfloat16):
            tp = mlstm.rows_per_block(p, dtype)
            assert lib.rt_mlstm_scan_smem(p, tp, int(dtype == torch.bfloat16)) == mlstm.carry_smem(p, tp, dtype)
    for hd in (16, 40, 200, 512, 700, 1040, 2048, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            pl = slstm.bwd_plan(hd, dtype)
            assert lib.rt_slstm_bwd_smem(hd, pl.cols, int(pl.tensor)) == pl.smem
    for p in (8, 40, 1024, 3200):
        for dtype in (torch.float32, torch.bfloat16):
            pl = mlstm.bwd_plan(p, 64, dtype)
            assert lib.rt_mlstm_bwd_smem(int(dtype == torch.bfloat16), 0) == pl.walk_smem
            assert lib.rt_mlstm_bwd_smem(int(dtype == torch.bfloat16), 1) == pl.state_smem
            assert lib.rt_mlstm_bwd_smem(int(dtype == torch.bfloat16), 2) == pl.intra_smem
    for chunk, n, p in ((128, 64, 64), (16, 3, 5), (8, 16, 32), (100, 40, 64), (128, 1, 1)):
        assert tuple(lib.rt_ssd_bwd_mma_smem(w, chunk, n, p) for w in (0, 1)) == ssd.bwd_smem(chunk, n, p)
    assert lib.rt_ssd_bwd_blocks_per_sm(128, 64, 64) >= 1
    # xlstm-1.3b's sLSTM: 16-block clusters, all 4 heads of a prefill at once, both ways
    assert slstm.max_active_clusters(512, torch.bfloat16, torch.bfloat16) >= 4
    for dtype in (torch.float32, torch.bfloat16):
        assert slstm._bwd_active_clusters(cuda.index or 0, 512, dtype == torch.bfloat16) >= 4
    out = slstm.chain_floor(1, 100, 4, 512, torch.bfloat16, cuda)
    torch.cuda.synchronize()
    assert out.shape == (1, 64, 32) and bool(torch.isfinite(out).all())


@pytest.mark.gpu
def test_ssm_serving_path_on_the_card_matches_cpu(cuda):
    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map

    cfg = configs.get_smoke_config("xlstm-1.3b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    torch.testing.assert_close(forward(on_card, cfg, toks.to(cuda)).cpu(), forward(params, cfg, toks),
                               rtol=1e-4, atol=1e-4)
    caches = {"cpu": init_cache(cfg, 2, 32), "cuda": init_cache(cfg, 2, 32, device=cuda)}
    want, _ = prefill(params, cfg, toks, caches["cpu"])
    got, _ = prefill(on_card, cfg, toks.to(cuda), caches["cuda"])
    for _ in range(3):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = want.argmax(-1)[:, None]
        want, _ = decode_step(params, cfg, tok, caches["cpu"])
        got, _ = decode_step(on_card, cfg, tok.to(cuda), caches["cuda"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for stack in ("mlstm", "slstm"):
        for name, t in caches["cpu"][stack].items():
            _assert_rel(caches["cuda"][stack][name].cpu(), t)
    counts = launch_counts()
    for name in ("rmsnorm", "rmsnorm_residual", "mlstm_scan", "slstm_scan"):
        assert counts[name] > 0, name


# -- training: the backward kernels (csrc/rmsnorm_bwd.cu, csrc/flash_attention_bwd.cu) --------
#
# Each is held to its plain version, torch.autograd.grad of the forward's
# plain version on the same inputs. Both sum in float32 in another order
# than autograd's ops, so a gradient is held at a share of its largest
# |value|: 1e-4 in f32 (SSD_REL), 2e-2 in bf16, where the kernel rounds
# its f32 result once to bf16 and the plain version rounds its forward's
# output and its grads along the way.
BWD_REL = {torch.float32: SSD_REL, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,view", [
    ((2048, 2560), False),     # qwen3-4b's seams at a 2048-token step
    ((1, 64, 32, 128), True),  # its q-norm rows, a strided view of a wider row
    ((1, 2048, 8, 128), False),  # its k-norm rows at a 2048-token step: 16384 rows of 128
    ((3, 17, 100), False),     # odd widths
    ((5, 7), True),            # narrow
])
def test_cuda_rmsnorm_bwd(cuda, dtype, shape, view):
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(sum(shape))
    wide = _randn(g, shape[:-1] + (shape[-1] + 3,), cuda, dtype)
    x = wide[..., 1:shape[-1] + 1] if view else wide[..., :shape[-1]].contiguous()
    res = _randn(g, shape, cuda, dtype)
    gy, gh = _randn(g, shape, cuda, dtype), _randn(g, shape, cuda, dtype)
    scale = (1.0 + 0.1 * torch.randn((shape[-1],), generator=g)).to(cuda)
    reset_launch_counts()
    dx, ds = rmsnorm.rmsnorm_bwd(x, gy, scale)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, gy)
    _assert_rel(dx.float(), want_dx.float(), BWD_REL[dtype])
    _assert_rel(ds, want_ds, BWD_REL[dtype])
    for with_gh in (False, True):  # K4: the gradient through h and y, or y's alone
        dx, ds = rmsnorm.rmsnorm_bwd(x, gy, scale, res=res, gh=gh if with_gh else None)
        want_dx, want_dres, want_ds = ref.rmsnorm_residual_bwd_ref(x, res, scale, gy,
                                                                   gh if with_gh else None)
        _assert_rel(dx.float(), want_dx.float(), BWD_REL[dtype])
        _assert_rel(dx.float(), want_dres.float(), BWD_REL[dtype])
        _assert_rel(ds, want_ds, BWD_REL[dtype])
    assert launch_counts()["rmsnorm_bwd"] == 3
    # a call repeats bit for bit (no atomics)
    again = rmsnorm.rmsnorm_bwd(x, gy, scale, res=res, gh=gh)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window", [
    (1, 256, 256, 8, 2, 128, True, 0),     # qwen3-4b's heads, cut in length
    (1, 300, 300, 4, 1, 128, True, 96),    # a window that starts inside a tile
    (2, 77, 130, 4, 4, 64, False, 0),      # no mask, Sq != Sk (seamless's head dim)
    (1, 129, 129, 6, 3, 80, True, 0),      # zamba2's head dim, a ragged tile
    (1, 65, 65, 2, 1, 96, True, 0),        # an unbuilt head dim, zero-padded to 128
    (1, 33, 33, 2, 2, 32, False, 0),
    (1, 2048, 2048, 32, 8, 128, True, 0),  # qwen3-4b's training layer, whole
    (1, 200, 200, 48, 8, 128, True, 0),    # a GQA group of 6 (mixtral's 48 q heads over 8)
    (1, 150, 150, 4, 2, 16, True, 0),      # head dim 16
    (2, 200, 200, 4, 2, 64, True, 50),     # a window, Sq not a multiple of 64
    (1, 2048, 2048, 96, 8, 192, True, 0),  # nemotron-4-340b's training layer, whole (its own build)
    (1, 300, 300, 12, 1, 192, True, 96),   # head dim 192 in ragged tiles under a window
    (1, 2048, 2048, 128, 128, (192, 128), True, 0),  # deepseek-v2's MLA layer: q/k 192, v 128
    (2, 177, 250, 8, 8, (192, 128), False, 0),       # MLA's pair, ragged, Sq != Sk
    (1, 129, 129, 4, 2, (160, 100), True, 0),        # an unbuilt pair, padded to (192, 128)
])
def test_cuda_flash_attention_bwd(cuda, dtype, b, sq, sk, h, kv, hd, causal, window):
    hd, hd_v = hd if isinstance(hd, tuple) else (hd, hd)  # q/k's head dim and v's
    g = torch.Generator().manual_seed(sq + hd)
    q = _randn(g, (b, sq, h, hd), cuda, dtype)
    k = _randn(g, (b, sk, kv, hd), cuda, dtype)
    v = _randn(g, (b, sk, kv, hd_v), cuda, dtype)
    do = _randn(g, (b, sq, h, hd_v), cuda, dtype)
    _hold_flash_attention_bwd(q, k, v, do, causal, window, None)


def _hold_flash_attention_bwd(q, k, v, do, causal, window, scale):
    """K5's output and lse, then its backward: each gradient within BWD_REL
    of the plain version's, in q's dtype and its input's shape, and bitwise
    on a repeat."""
    dtype = q.dtype
    o, lse = flash_attention.flash_attention(q, k, v, causal=causal, window=window, scale=scale, with_lse=True)
    assert torch.equal(o, flash_attention.flash_attention(q, k, v, causal=causal, window=window, scale=scale))
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window, scale=scale)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        _assert_rel(a.float(), w.float(), BWD_REL[dtype])
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2048, 333])
def test_cuda_flash_attention_bwd_on_mla_projections(cuda, dtype, s):
    # deepseek-v2's q, k (nope 128 + rope 64, concatenated) and v (128) as
    # mla_qkv builds them from one layer's weights at the published widths,
    # at MLA's scale: the (192, 128) build on the tensors the training path
    # hands it
    from repro_torch import configs
    from repro_torch.models import attention

    cfg = configs.get_config("deepseek-v2-236b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {k: w[0] for k, w in attention.mla_params(gen, cfg, dtype, 1).items()}
    x = torch.randn((1, s, cfg.d_model), generator=gen, device=cuda).to(dtype)
    positions = torch.arange(s, device=cuda)[None]
    q, k, v, _, _ = attention.mla_qkv(p, x, positions, cfg)
    assert (q.shape[-1], k.shape[-1], v.shape[-1]) == (192, 192, 128)
    do = torch.randn(v.shape, generator=gen, device=cuda).to(dtype)
    _hold_flash_attention_bwd(q, k, v, do, True, 0, attention.mla_scale(cfg))


@pytest.mark.gpu
def test_cuda_flash_attention_bwd_smem_matches_the_source(cuda):
    from repro_torch.kernels.build import library

    lib = library()
    for hd, hd_v in flash_attention.BWD_HEAD_DIM_PAIRS:
        for dtype in (torch.bfloat16, torch.float32):
            want = flash_attention.bwd_smem(hd, hd_v, dtype)
            got = tuple(lib.rt_flash_attention_bwd_smem(hd, hd_v, int(dtype == torch.bfloat16), p)
                        for p in (0, 1))
            assert got == want, (hd, hd_v, dtype)
    for hd, hd_v in flash_attention.BWD_HEAD_DIM_PAIRS:  # the wide dk/dv block of two consumers: pass 2
        if hd > flash_attention.BWD_WIDE:
            want = flash_attention.bwd_smem(hd, hd_v, torch.bfloat16, group=2)[0]
            assert lib.rt_flash_attention_bwd_smem(hd, hd_v, 1, 2) == want, (hd, hd_v)
    assert lib.rt_flash_attention_bwd_smem(160, 128, 1, 0) == -1


@pytest.mark.gpu
def test_cuda_training_step_matches_cpu_through_the_backward_kernels(cuda):
    from repro_torch import configs
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import tree_map
    from repro_torch.train import AdamWConfig, make_train_step, train_state_init

    cfg = configs.get_smoke_config("qwen3-4b")
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    states = {"cpu": train_state_init(cfg, opt, torch.Generator().manual_seed(0))}
    states["cuda"] = tree_map(lambda t: t.to(cuda), states["cpu"])
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, opt)
    reset_launch_counts()
    losses = {}
    for dev, st in states.items():
        for _ in range(2):
            st, m = step(st, {k: t.to(dev) for k, t in batch.items()})
        states[dev], losses[dev] = st, float(m["loss"])
    counts = launch_counts()
    for name in ("rmsnorm", "rmsnorm_residual", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd"):
        assert counts[name] > 0, name
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for a, w in zip(_leaves(states["cuda"]["params"]), _leaves(states["cpu"]["params"])):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-5)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.gpu
def test_cuda_inference_path_launches_what_it_did_without_grad(cuda):
    # without a gradient to take the forward launches K1, K4, K5 as before,
    # no backward kernel, and the same counts with grad enabled but no
    # parameter requiring it
    from repro_torch import configs
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.models import forward, init_params
    from repro_torch.models.transformer import tree_map

    cfg = configs.get_smoke_config("qwen3-4b")
    params = tree_map(lambda t: t.to(cuda), init_params(cfg, torch.Generator().manual_seed(0)))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1)).to(cuda)
    runs = []
    for grad in (False, True):
        reset_launch_counts()
        with torch.set_grad_enabled(grad):
            logits = forward(params, cfg, toks)
        runs.append((launch_counts(), logits))
    (counts, logits), (counts_grad, logits_grad) = runs
    assert counts == counts_grad and torch.equal(logits, logits_grad)
    # the first norm, then q- and k-norm in every layer; two K4 seams a layer
    assert counts["rmsnorm"] == 1 + 2 * cfg.n_layers and counts["rmsnorm_residual"] == 2 * cfg.n_layers
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["rmsnorm_bwd"] == counts["flash_attention_bwd"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["decode_attention", "flash_attention_hd256",
                                    "flash_attention_route_a_hd256"])
def test_cuda_kernels_without_a_backward_raise_under_grad(cuda, kernel):
    # K5 trains up to head dim 192, on route (a) too; above, the pieces
    # kernel writes no lse
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(3)

    def leaf(shape, dtype=torch.float32):
        return _randn(g, shape, cuda, dtype).requires_grad_(True)

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if kernel == "decode_attention":
            ops.decode_attention(leaf((1, 1, 2, 64)), leaf((1, 8, 1, 64)), leaf((1, 8, 1, 64)), 4)
        elif kernel == "flash_attention_hd256":
            ops.flash_attention(leaf((1, 8, 2, 256), torch.bfloat16), leaf((1, 8, 1, 256), torch.bfloat16),
                                leaf((1, 8, 1, 256), torch.bfloat16))
        else:
            ops.flash_attention(leaf((1, 8, 2, 256)), leaf((1, 8, 1, 256)), leaf((1, 8, 1, 192)))


# -- training the hybrid and ssm families: the scans' backward kernels -------------------
# (csrc/ssd_bwd.cu, csrc/mlstm_bwd.cu, csrc/slstm_bwd.cu), each held to its
# plain version (torch.autograd.grad of the forward's plain version) at
# BWD_REL: 1e-4 of the largest |value| in f32, 2e-2 in bf16.


def _rel_all(got, want, dtype):
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert (a is None) == (w is None)
        if a is not None:
            assert a.dtype == w.dtype and a.shape == w.shape
            _assert_rel(a.float(), w.float(), BWD_REL[dtype])


def _bitwise(got, again):
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,p,n,chunk,with_state,view", [
    (1, 512, 8, 64, 64, 128, False, False),   # zamba2-2.7b's head and state widths, 8 of its 80 heads
    (1, 333, 4, 64, 64, 128, True, False),    # a ragged last chunk, from a state, d h_final
    (2, 37, 3, 32, 16, 8, False, False),      # zamba2 SMOKE's widths
    (1, 40, 2, 5, 3, 16, True, False),
    (1, 2048, 80, 64, 64, 128, False, False),  # zamba2-2.7b's training step: 80 heads, groups of 10
    (1, 300, 81, 64, 64, 128, False, False),   # a head count the group does not divide
    (2, 333, 8, 64, 64, 128, True, False),     # batch 2
    (1, 1109, 80, 64, 64, 128, False, True),   # xh, B and C slices of one conv output, as models/ssm.py
])
def test_cuda_ssd_scan_bwd(cuda, dtype, b, s, nh, p, n, chunk, with_state, view):
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(s + p)
    if view:  # the Mamba block's conv output (B, S, nh P + 2 N), split without a copy
        xbc = _randn(g, (b, s, nh * p + 2 * n), cuda, dtype)
        xh = xbc[..., : nh * p].unflatten(-1, (nh, p))
        bm, cm = xbc[..., nh * p: nh * p + n], xbc[..., nh * p + n:]
    else:
        xh = _randn(g, (b, s, nh, p), cuda, dtype)
    dt = (0.05 + 0.45 * torch.rand((b, s, nh), generator=g)).to(cuda)
    a = (-0.2 - torch.rand((nh,), generator=g)).to(cuda)
    if not view:
        bm, cm = _randn(g, (b, s, n), cuda, dtype), _randn(g, (b, s, n), cuda, dtype)
    dy = _randn(g, (b, s, nh, p), cuda, torch.float32)
    h0 = _randn(g, (b, nh, n, p), cuda, torch.float32) if with_state else None
    dh = _randn(g, (b, nh, n, p), cuda, torch.float32) if with_state else None
    reset_launch_counts()
    got = ssd.ssd_scan_bwd(xh, dt, a, bm, cm, dy, dh, chunk=chunk, h0=h0)
    assert launch_counts()["ssd_scan_bwd"] == 1
    _rel_all(got, ref.ssd_scan_bwd_ref(xh, dt, a, bm, cm, dy, dh, chunk, h0), dtype)
    _bitwise(got, ssd.ssd_scan_bwd(xh, dt, a, bm, cm, dy, dh, chunk=chunk, h0=h0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,p,chunk,with_state", [
    (1, 256, 2, 1024, 64, False),  # xlstm-1.3b's head width, 2 of its 4 heads
    (1, 130, 2, 64, 64, True),     # a ragged last chunk, from a state, the final state's grads
    (2, 37, 4, 32, 8, False),      # xlstm SMOKE's widths
    (1, 50, 2, 40, 16, True),      # P no multiple of the 64-column tiles
    (1, 100, 1, 3200, 64, False),  # the forward's general route, 50 tiles of the states a side
])
def test_cuda_mlstm_scan_bwd(cuda, dtype, b, s, nh, p, chunk, with_state):
    from repro_torch.kernels import mlstm
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(s + p)
    q, k, v, ig, fg, state = _mlstm_case(g, b, s, nh, p, cuda, dtype, with_state)
    fg = fg + 3.0  # forget gates biased open (see test_cuda_scans_refuse_shapes_they_do_not_take)
    y, _ = mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk, state=state)
    dy = _randn(g, (b, s, nh, p), cuda, torch.float32)
    dfinal = None
    if with_state:
        dfinal = (_randn(g, (b, nh, p, p), cuda, torch.float32), _randn(g, (b, nh, p), cuda, torch.float32),
                  _randn(g, (b, nh), cuda, torch.float32))
    reset_launch_counts()
    got = mlstm.mlstm_scan_bwd(q, k, v, ig, fg, y, dy, dfinal, chunk=chunk, state=state)
    assert launch_counts()["mlstm_scan_bwd"] == 1
    _rel_all(got, ref.mlstm_scan_bwd_ref(q, k, v, ig, fg, dy, dfinal, chunk, state), dtype)
    _bitwise(got, mlstm.mlstm_scan_bwd(q, k, v, ig, fg, y, dy, dfinal, chunk=chunk, state=state))


# The mLSTM's f32 gradients at xlstm-1.3b's training shape (q/k/v (1, 2048, 4,
# 1024), chunk 64), the forward kernel's y passed in as training passes it:
# each gradient's error against float64 autograd of the cell's recurrence
# (ref.mlstm_recurrence_bwd_f64) within MLSTM_F64_FACTOR of the plain
# version's own (ref.mlstm_scan_bwd_ref), a share of float64's largest
# |value| (scripts/torch_mlstm_f64_probe.py prints the table).
MLSTM_F64_FACTOR = 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cuda_mlstm_scan_bwd_f32_error_against_float64(cuda, seed):
    from repro_torch.kernels import mlstm

    g = torch.Generator().manual_seed(seed)
    b, s, nh, p, chunk = 1, 2048, 4, 1024, 64
    q, k, v = (torch.randn((b, s, nh, p), generator=g).to(cuda) for _ in range(3))
    ig = torch.randn((b, s, nh), generator=g).to(cuda)
    fg = torch.randn((b, s, nh), generator=g).to(cuda) + 3.0
    dy = torch.randn((b, s, nh, p), generator=g).to(cuda)
    y, _ = mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk)
    got = mlstm.mlstm_scan_bwd(q, k, v, ig, fg, y, dy, chunk=chunk)[:5]
    plain = ref.mlstm_scan_bwd_ref(q, k, v, ig, fg, dy, None, chunk)[:5]
    exact = ref.mlstm_recurrence_bwd_f64(q, k, v, ig, fg, dy)
    for name, kg, pg, eg in zip(("dq", "dk", "dv", "di", "df"), got, plain, exact):
        top = float(eg.abs().max())
        err_k = float((kg.double() - eg).abs().max()) / top
        err_p = float((pg.double() - eg).abs().max()) / top
        assert err_k <= MLSTM_F64_FACTOR * err_p, f"{name}: kernel {err_k:.3e} against plain {err_p:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hd,with_state", [
    (1, 96, 4, 512, False),   # xlstm-1.3b's sLSTM heads, cut in length (bf16: the tensor route)
    (2, 19, 4, 16, True),     # xlstm SMOKE's widths, from a state, the final state's grads
    (1, 40, 2, 200, False),   # a cluster of 7 blocks of 29 columns, the last 26
    (1, 9, 1, 700, False),    # streaming in bf16 too (hd above 512), 44 columns a block
    (1, 24, 1, 1040, False),  # 65 columns a block: 3 warps of column threads
    (1, 12, 1, 2048, False),  # 128 columns a block
])
def test_cuda_slstm_scan_bwd(cuda, dtype, b, s, nh, hd, with_state):
    from repro_torch.kernels import slstm
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(s + hd)
    xg = _randn(g, (b, s, 4 * nh * hd), cuda, dtype)
    r = (torch.randn((4, nh, hd, hd), generator=g) * hd ** -0.5).to(cuda, dtype)
    state = dfinal = None
    if with_state:
        state = (_randn(g, (b, nh, hd), cuda, torch.float32), _randn(g, (b, nh, hd), cuda, torch.float32),
                 torch.rand((b, nh, hd), generator=g).to(cuda) + 0.5, _randn(g, (b, nh), cuda, torch.float32))
        dfinal = tuple(_randn(g, x.shape, cuda, torch.float32) for x in state)
    hs, _ = slstm.slstm_scan(xg, r, state=state)
    dhs = _randn(g, (b, s, nh, hd), cuda, torch.float32)
    reset_launch_counts()
    got = slstm.slstm_scan_bwd(xg, r, hs, dhs, dfinal, state=state)
    assert launch_counts()["slstm_scan_bwd"] == 1
    _rel_all(got, ref.slstm_scan_bwd_ref(xg, r, dhs, dfinal, state), dtype)
    _bitwise(got, slstm.slstm_scan_bwd(xg, r, hs, dhs, dfinal, state=state))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ssd_chunk", "ssd_state", "mlstm_chunk", "slstm_hd"])
def test_cuda_scan_bwd_refuses_shapes_outside_its_build(cuda, case):
    from repro_torch.kernels import mlstm, slstm

    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="ROADMAP"):
        if case == "ssd_chunk":
            ssd.ssd_scan_bwd(z(1, 300, 2, 64), z(1, 300, 2), z(2), z(1, 300, 64), z(1, 300, 64),
                             z(1, 300, 2, 64), chunk=256)
        elif case == "ssd_state":
            ssd.ssd_scan_bwd(z(1, 40, 2, 64), z(1, 40, 2), z(2), z(1, 40, 128), z(1, 40, 128),
                             z(1, 40, 2, 64), chunk=8)
        elif case == "mlstm_chunk":
            x = z(1, 200, 1, 32)
            mlstm.mlstm_scan_bwd(x, x, x, z(1, 200, 1), z(1, 200, 1), x, x, chunk=128)
        else:
            slstm.slstm_scan_bwd(z(1, 3, 4 * 4097), z(4, 1, 4097, 4097), z(1, 3, 1, 4097),
                                 z(1, 3, 1, 4097))


@pytest.mark.gpu
def test_cuda_scans_under_grad_launch_their_backward_kernels(cuda):
    # a CUDA call that needs a gradient goes through kernels/autograd.py:
    # the forward kernel, then the backward kernel, each counted once
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(3)

    def leaf(shape):
        return _randn(g, shape, cuda, torch.float32).requires_grad_(True)

    reset_launch_counts()
    xh, bm, cm = leaf((1, 16, 2, 8)), leaf((1, 16, 4)), leaf((1, 16, 4))
    dt = torch.rand((1, 16, 2), device=cuda).requires_grad_(True)
    a = (-torch.rand((2,), device=cuda)).requires_grad_(True)
    y, _ = ops.ssd_scan(xh, dt, a, bm, cm, chunk=8)
    q, ig = leaf((1, 8, 1, 16)), leaf((1, 8, 1))
    ym, _ = ops.mlstm_scan(q, q, q, ig, ig + 3.0, chunk=8)
    xg, r = leaf((1, 4, 64)), leaf((4, 1, 16, 16))
    hs, _ = ops.slstm_scan(xg, r)
    grads = torch.autograd.grad(y.sum() + ym.sum() + hs.sum(), (xh, dt, a, bm, cm, q, ig, xg, r))
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    counts = launch_counts()
    for name in ("ssd_scan_bwd", "mlstm_scan", "mlstm_scan_bwd", "slstm_scan", "slstm_scan_bwd"):
        assert counts[name] == 1, name
    assert counts["ssd_scan"] == ssd.launches(1, 16, 2, False)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_cuda_hybrid_and_ssm_training_steps_match_cpu(cuda, arch):
    # a 2-layer f32 cut (xlstm: one mLSTM and one sLSTM block) on the card
    # and on the CPU from one state (_training_matches_cpu)
    from repro_torch import configs

    cfg = configs.get_smoke_config(arch).replace(n_layers=2)
    scans = ("ssd_scan", "ssd_scan_bwd", "flash_attention", "flash_attention_bwd") if cfg.ssm else (
        "mlstm_scan", "mlstm_scan_bwd", "slstm_scan", "slstm_scan_bwd")
    _training_matches_cpu(cuda, cfg, ("rmsnorm", "rmsnorm_bwd") + scans)


def _training_matches_cpu(cuda, cfg, kernels, move_rel=None):
    """``cfg`` trained on the card and on the CPU from one state: the step-0
    loss and gradients (each leaf within BWD_REL of its largest |value|),
    then the parameters after two steps within rtol 1e-4, atol 1e-4 (a
    tenth of a step's largest move at lr 1e-3: AdamW's m / sqrt(v) magnifies
    a last-bit difference of a gradient near 0, as tests/test_torch_train.py
    says), or with ``move_rel`` each leaf's move on the card within
    ``move_rel`` of the CPU's move's norm (chip_smoke.py's TRAIN_MOVE_REL:
    an element whose gradient lies within the two sides' rounding of zero
    moves up to a whole step of lr either way); each of ``kernels``
    launched."""
    import numpy as np

    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import tree_map
    from repro_torch.train import AdamWConfig, make_train_step, train_state_init
    from repro_torch.train.step import loss_and_grads

    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    states = {"cpu": train_state_init(cfg, opt, torch.Generator().manual_seed(0))}
    states["cuda"] = tree_map(lambda t: t.to(cuda), states["cpu"])
    toks = torch.randint(0, cfg.vocab_size, (2, 27), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("vlm", "audio"):  # the drawn stub memory (image tokens, encoder frames)
        length = cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
        mem = np.random.default_rng(2).standard_normal((2, length, cfg.d_model), dtype=np.float32)
        batch["memory"] = torch.from_numpy(mem)
    step = make_train_step(cfg, opt)
    start = [t.clone() for t in _leaves(states["cpu"]["params"])]
    reset_launch_counts()
    grads = {dev: loss_and_grads(st["params"], cfg, batch["tokens"].to(dev), batch["labels"].to(dev),
                                 batch["memory"].to(dev) if "memory" in batch else None)
             for dev, st in states.items()}
    assert abs(float(grads["cuda"][0]) - float(grads["cpu"][0])) <= 1e-5 * abs(float(grads["cpu"][0]))
    for a, w in zip(grads["cuda"][1], grads["cpu"][1]):
        if w.numel():
            _assert_rel(a.cpu(), w, BWD_REL[torch.float32])
    losses = {}
    for dev, st in states.items():
        for _ in range(2):
            st, m = step(st, {k: x.to(dev) for k, x in batch.items()})
        states[dev], losses[dev] = st, float(m["loss"])
    counts = launch_counts()
    for name in kernels:
        assert counts[name] > 0, name
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for a, w, p0 in zip(_leaves(states["cuda"]["params"]), _leaves(states["cpu"]["params"]), start):
        if move_rel is None:
            torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-4)
        elif w.numel():
            assert float((a.cpu() - w).norm()) <= move_rel * float((w - p0).norm()), tuple(w.shape)


# the families whose attention trains through flash_attention_bwd beyond the
# dense one: deepseek-v2's MLA (its smoke head dims q/k 24, v 16, padded to
# (32, 32); and q/k 192 against v 128 as at its published widths), mixtral
# (GQA, a window), llama-3.2-vision (a gated cross block over image tokens),
# seamless (encoder-decoder over frames), nemotron (head dim 192, 4 q heads
# over 1), each at 2 layers in f32, each leaf's move held as chip_smoke.py's
# cuts hold it (1e-2 of its norm: at nemotron's smoke widths one element of
# 294912 moved 0.11 of a step of lr apart, a gradient near 0)
FAMILY_CUTS = {
    "deepseek-v2-236b": dict(),
    "deepseek-v2-236b mla 192/128": dict(mla=dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)),
    "mixtral-8x22b": dict(),
    "llama-3.2-vision-90b": dict(),
    "seamless-m4t-medium": dict(),
    "nemotron-4-340b": dict(d_model=768, n_heads=4, n_kv_heads=1, d_ff=1536),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAMILY_CUTS))
def test_cuda_family_training_steps_match_cpu(cuda, name):
    import dataclasses

    from repro_torch import configs

    base = configs.get_smoke_config(name.split()[0])
    changes = {k: dataclasses.replace(getattr(base, k), **v) if isinstance(v, dict) else v
               for k, v in FAMILY_CUTS[name].items()}
    cfg = base.replace(n_layers=2, **changes)
    kernels = ("flash_attention", "flash_attention_bwd")
    if cfg.norm == "rmsnorm":
        kernels += ("rmsnorm", "rmsnorm_residual", "rmsnorm_bwd")
    _training_matches_cpu(cuda, cfg, kernels, move_rel=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mixtral-8x22b", "llama-3.2-vision-90b", "seamless-m4t-medium",
                                  "nemotron-4-340b cut"])
def test_cuda_family_training_runs(cuda, name):
    # chip_smoke.training_run for the runs the smoke leaves to this test
    # (chip_smoke.TRAINING_TESTS): bf16 at the published widths, cut in
    # depth (or, nemotron's, in width), 4 steps (8 for mixtral and llama:
    # chip_smoke.TRAIN_STEPS_OF) with the loss finite and falling,
    # launches, peak memory, a step's device split, step 1 bitwise on a
    # repeat; and each cut in f32 against the CPU at the smoke's limits
    import gc
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    from repro_torch.train import AdamWConfig

    opt = AdamWConfig(peak_lr=chip_smoke.TRAIN_LR, warmup_steps=0, total_steps=100,
                      mu_dtype="float32", nu_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    arch, changes, needed, cut, checkpoint = chip_smoke.TRAINING_TESTS[name]
    counts = chip_smoke.training_run(cuda, arch, changes, needed, cut, opt, checkpoint)
    assert all(counts[k] > 0 for k in needed)
