"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture, never at import). This file imports no JAX, so it also runs on a
machine that has only PyTorch and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 2e-5, bf16 2e-2 (the precedent of tests/test_kernels.py);
K2/K3 and the kalman scan are held bitwise, as their contract says.
"""
import pytest
import torch

from repro_torch.kernels import fused, kalman, ref, rmsnorm

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
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
    assert all(n > 0 for n in launch_counts().values())
    on_cpu = run("cpu")
    for sub, sinks in on_cpu.items():
        for sink, dg in sinks.items():
            assert on_card[sub][sink]["count"] == dg["count"] == 4
            assert on_card[sub][sink]["checksum"] == pytest.approx(dg["checksum"], rel=1e-4)
