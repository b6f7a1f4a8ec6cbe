#!/usr/bin/env python3
"""Smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
device and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``), and exits
non-zero, printing no result, without either or outside a checkout.

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); build the kernels from
     ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
  2. every kernel against its plain PyTorch version on the card, at the
     stream path's shapes (K1 also at model widths, f32 and bf16, and at
     the serving shapes RMS_SHAPES in bf16 on a packed input and an
     unaligned view, with the route its plan took, beside F.rms_norm; K2/K3
     also in bf16, and K3 == K1 of K2's output at D = 128 and 5120; K4-K6
     at qwen3-4b's serving shapes, bf16 and f32; K7 at zamba2-2.7b's
     prefill of 2048 tokens, f32 and bf16, and at a ragged 1109; K5/K6
     also at zamba2's head dim of 80, nemotron-4-340b's of 192, an
     unbuilt 96 (run zero-padded to 128) and, on the pieces kernel, 256
     and 320, f32 and bf16, each beside its library call; K7's tiled
     build in f32 at chunk = N = P = 128 and at chunk 256, N 192, P 160 in
     f32 and bf16; which K5 and K7 build each dtype and shape ran, and
     K7's launches per call, counted; K5/K6 at mixtral-8x22b's 48 heads
     over 8 of 128 under its window of 4096 and under a window of 1024
     that masks, f32 and bf16; K5 on the routes of the MLA, vlm and audio
     families: (a) deepseek-v2's MLA prefill, q/k (1, 2048, 128, 192)
     against v of 128, v zero-padded and the output sliced, (b) the
     seamless encoder's (1, 1024, 16, 64) without a mask, (c) llama's
     cross-attention without a mask, q (1, 2048 and 159, 64, 128) against
     (1, 1024, 8, 128); K6 for one token against that memory, cache_len
     1024; f32 and bf16, each beside F.scaled_dot_product_attention);
     the ssm family's scans at xlstm-1.3b's prefill of 2048 tokens:
     mlstm_scan, q/k/v (1, 2048, 4, 1024) at chunk 64 in f32 and bf16, at
     a ragged S = 2039 and from a carried state, and slstm_scan, xg (1,
     2048, 8192) with R (4, 4, 512, 512) in f32 and bf16, each within
     SCAN_REL of its plain version, beside its bound and its launch plan,
     the sLSTM's µs a step beside the chain's floor (its clusters' h
     exchange and barrier alone);
     K2/K3 must be bitwise equal to the eager op-by-op path and the kalman
     scan to its plain version (from p0 = 1 and from the gain's fixed
     point); device time per launch (CUDA-graph replay between CUDA
     events) and host time per call beside the bound (K7's for bf16 inputs
     at the bf16 tensor-core rate, beside it the f32 rate and the
     operations it issues; the kalman scan's beside its dependent chain's
     floor), the plain version's and the one-call library time;
  3. the main path: ``StreamSystem(backend="torch", base_batch=16384)``
     runs the 21 RIoT dataflows plus the kernel flows — 3 steps, fuse(),
     3 steps, remove three dataflows, 2 steps — with launch counts reset
     just before and read just after; sink counts exact; digests bitwise
     equal to an unfused run; counts equal to a CPU run at base_batch=1024
     and checksums within CPU_RTOL; every segment steps through CUDA graphs
     after its first, eager step, and the fused script run again with
     ``TorchBackend(capture=False)`` gives bitwise the same digests and the
     same kernel launch counts; graphs captured, capture ms per graph, host
     launch calls and card operations per steady step (torch.profiler, one
     step each) and the step walls of both are printed; the fused script
     again in concurrent mode (``step_mode="concurrent"``, max_workers None
     and 4: the stepping thread issues each wave's graph replays onto that
     many CUDA streams, the widest wave's width for None, ordered by an
     event per producer), with digests bitwise equal to the sync captured
     run's, the same kernel launch counts, ``on_wave`` events covering
     every segment once a step in the waves ``segment_waves()`` gives, every
     segment stepped through a graph, and STEADY steady steps' walls and
     ``makespan_ms`` and the step_launches profile beside the sync run's;
     then the session: ``ReuseSession(execute=True, backend="torch",
     base_batch=16384)`` takes the same flows through submit_many — 3
     steps, fuse(), 2 steps, checkpoint(), defragment(), 2 steps, remove
     three dataflows, 2 steps — with launch counts reset just before and
     read just after (K1, K2, K3, kalman_scan > 0) and its hooks fired;
     ``ReuseSession.restore`` of the checkpoint on the card finishes the
     script with digests bitwise equal; at base_batch=1024 a checkpoint
     taken on the card finishes on the CPU and one taken on the CPU on the
     card, counts exact and checksums within CPU_RTOL; the OPMW rw1 trace
     (``rw_trace(seed=11)``) at base_batch=16384, one step after each event,
     checkpointed and restored at its middle event, with per-submission
     sink counts equal to the ``dryrun`` backend's after every event and
     peaks of 471 submitted and 277 running tasks; the step walls,
     checkpoint bytes, write and restore ms and rw1's wall time printed,
     with the graphs captured and their capture ms; then the session script
     in concurrent mode (digests bitwise equal to the sync session's, its
     launches counted), its checkpoint restored in sync mode and the sync
     one in concurrent mode (bitwise), telemetry on over its tail
     (``configure_obs(trace=True)``: spans counted by category, the
     Prometheus text, a Chrome trace that ``json`` loads), and rw1 in
     concurrent mode, sink counts equal to the dry run's after every event;
     then (3c) the worker-process plane: the same stream script on
     ``backend="multiproc"`` over shm, 2 workers in sync mode (an RPC a
     segment) and 4 in concurrent mode with chain batching (an RPC a
     worker), fuse() accepting every chain, with sink digests bitwise and
     kernel launches summed over the workers equal to the in-process
     captured run's; their steady step walls beside phase 3's, the
     workers' own segment ms, MiB published and RPCs a step, spawn to the
     first step, each worker's memory; a checkpoint taken on multiproc
     restored on torch and the reverse (bitwise), a worker killed between
     steps and recovered (digests unchanged), a short run over tcp;
     then (3d) the in-process backend over the host transports and the
     sharded backend: the same script on ``backend="torch"`` over shm and
     tcp (boundary batches through pinned host staging) and on
     ``backend="sharded"`` (every card, then two slots of cuda:0), sync
     and concurrent, digests bitwise and launches equal to phase 3's, the
     step walls and MiB published a step beside phase 3's, segments per
     slot; (3e) supervision and autoscaling: two pools of 2 workers, one
     supervised (spill snapshots, heartbeats), stepped in turns for the
     supervision overhead and the workers' spill ms a step, a worker
     SIGKILLed between steps (recovered inside the next step), another
     while idle (recovered by the heartbeat), the pool grown by one and
     shrunk back by the autoscaler at thresholds set from the measured
     pressure, digests bitwise the unsupervised pool's after each, the
     respawn and resize ms and the events printed; (3f) the trace CLI in
     subprocesses: riot/rw1 on the card cut and resumed with --restore
     (stitched series equal to the uninterrupted run's), riot/seq on a
     supervised, autoscaled pool with a worker killed at event 6 (exit 0,
     a respawn, sink counts of the un-killed run); (3g) the front end:
     ``ServeFrontend`` over ``ReuseSession(backend="torch",
     base_batch=16384)``, alice's 21 RIoT flows and bob's tenant copies (0
     slots), digests bitwise a direct session's, the socket verbs, a stop
     with a checkpoint restored on the card (ledgers equal), and the daemon
     (start/submit/status/stop) in a subprocess;
  4. the dense serving path at full width: qwen3-4b (36 layers, bf16,
     random weights drawn on the card from a seeded generator) through
     ``ServeEngine(slots=4, max_len=4096)``, 8 greedy requests of 16 new
     tokens, prompts of 128-2048 tokens; launch counts reset just before
     and read just after (K1, K4, K5, K6 > 0); prefill ms per prompt
     length, decode ms per token, tokens/s, peak memory; prefill/decode
     consistency (in f32 at full width and depth, and in bf16); the
     configuration cut to 2 layers on the card against the CPU, in f32
     (logits within 1e-3, greedy tokens equal) and in bf16 (every kernel
     against its plain version at full width);
  5. the hybrid serving path the same way: zamba2-2.7b (54 Mamba2 layers
     and one shared attention block applied 9 times, bf16) with K1, K4,
     K5, K6 and K7 > 0 and K7 called 54 times per prefill (3 launches
     each); bf16 checks on a second weight seed too; its card against CPU
     cut is 6 layers (one group, the shared block included);
  5b. the moe family the same way: mixtral-8x22b at full width (d_model
     6144, 48 heads over 8 of 128, 8 experts of 16384, top-2, window 4096,
     bf16) cut to 8 of its 56 layers (one card holds about 41 GB of them),
     with K1, K4, K5, K6 > 0, the tokens dropped by capacity at a prefill
     and the launches per decoded token printed; prefill/decode consistency
     at a capacity that drops no token (f32 at 4 layers, bf16 on seeds 0
     and 1); the card against the CPU at 1 layer, with the experts each
     token chose compared call by call (a differing choice only at a
     near-tie of the router's probabilities, named);
  5c. LM reuse-serving at full width: ``ReuseServing(backend="torch")``,
     6 tenants over urban/meter/taxi, 4 stages of 9 blocks at d_model 2560
     (3 shared), base_batch 256: 5 steps, tenant1 removed, 3 steps, with
     launch counts reset just before and read just after (K1, K4 > 0); the
     weights deployed against the no-reuse sum, step walls and the card's
     busy ms; strategy "none" gives each tenant bitwise the same sink
     digests; one tenant at 1 stage of 2 blocks on the card against the
     CPU; ``python -m repro_torch.launch.serve --reuse`` prints the
     reference's line;
  5d-5f. the MLA, vlm and audio families as phase 5b, each ServeEngine
     run with K5 > 0, K6 > 0 but for MLA's absorbed decode, and K1, K4 > 0
     for the first two:
     deepseek-v2-236b at full width (MLA: ranks 1536/512, q/k head dim
     128 + 64, v 128; 160 experts of 1536, top-6, 2 shared) cut from 60 to
     6 layers (1 dense + 5 MoE), its dropped tokens and experts chosen as
     mixtral's; llama-3.2-vision-90b (64 over 8 KV heads of 128, gated
     cross-attention every 5th layer to 1024 image tokens) cut from 100 to
     10 layers, its gates opened (0 at init); seamless-m4t-medium whole (12
     + 12 layers, 1024 frames, prompts of 128-1024 tokens), and its CLI on
     the card. A vlm or audio request carries a memory drawn with numpy,
     and the logits with it must differ from those with a zero memory; the
     card-vs-CPU cuts are 2 layers (1 dense + 1 MoE; 1 self + 1 cross at
     cross_attn_every 2; 2 + 2 encoder/decoder layers);
  5g. the ssm family the same way: xlstm-1.3b whole (42 mLSTM and 6
     sLSTM blocks, d_model 2048, 4 heads, bf16), K1, K4, mlstm_scan and
     slstm_scan > 0, each scan launched once per block and prefill;
     prefill/decode consistency in f32 at full depth and in bf16; the
     card-vs-CPU cut at 2 layers, one mLSTM and one sLSTM block
     (slstm_every 2), at full width; ``python -m repro_torch.launch.serve
     --arch xlstm-1.3b`` on the card;
  6. nemotron-4-340b cut in width (NEMOTRON_CUT: head dim 192, 12 q heads
     per KV head) on the card against the CPU in f32, with decode steps
     past the cache's last slot;
  7. a ``{"kernels": [...]}`` line (launches summed over the counted runs
     of phases 3-5g, the session's, the concurrent ones, the workers' of
     phases 3c and 3e and the in-process runs of 3d and 3g included; each
     must be > 0), the card line as nvidia-smi gives
     it, and as the last line ``{"ok": true, "device": {...}}``.

``--phase kernels`` stops after phase 2 (a first check of new kernels).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # bf16 dense tensor-core peak
MAIN_BATCH = 16384  # events per source per step (elasticity_bench's compute-bound batch)
CPU_BATCH = 1024
F32_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py precedent
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# K5/K6 outputs in bf16 are softmax-weighted means of many values, with a
# spread of about 0.04 at the serving shapes, so atol 2e-2 would pass a
# dropped split; two
# roundings of one f32 value differ by at most one bf16 ulp (2**-7 relative),
# which rtol covers at any size, so atol only has to cover values near zero.
ATTN_BF16_TOL = dict(rtol=2e-2, atol=2e-3)
CPU_RTOL = 1e-4  # card vs CPU checksums: reduction order, sin/log1p ulps
REMOVED = ("urban_etl", "taxi_pred_lr", "FA")
SERVE_PROMPT = 2048  # longest prompt of the serving phase
KALMAN_SETTLE = 4096  # rows after which the gain chain from p = 1 sits at its fixed point
CHAIN_CYCLES = 12  # latency of kalman's dependent fsub, fmul and fadd: 4 cycles each
K7_LAUNCHES = 3  # kernels one bf16 ssd_scan call launches


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz():
    """The card's maximum SM clock in Hz (nvidia-smi), or None."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        return None


def call_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Median ms per call from CUDA events around each call: what a caller
    on the host waits for one call, launch overhead included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, per_graph: int = 20, reps: int = 21) -> float:
    """Median device ms per call: ``per_graph`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so host overhead
    drops out and back-to-back launches remain."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(name, got, want, tol) -> float:
    import torch

    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: max |err| {err} outside {tol}")
    return err


def check_bitwise(name, got, want) -> float:
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise equal (max |err| {max_err(got, want)})")
    return max_err(got, want)


# -- phase 2: kernels against their plain versions ----------------------------------

def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import fused, kalman, ref, rmsnorm

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows, d = MAIN_BATCH, 5
    batch = (torch.randn((rows, 8), generator=gen) * 4.0 + 1.0).to(dev)
    x = batch[:, 1:6]  # the stream path's strided view, row stride 8
    scale = torch.full((d,), 1.5, device=dev)
    stages = ((2.0, 0.5), (0.7, -0.1))
    eps = 1e-6
    io_bytes = 2 * rows * d * 4  # each element read once and written once
    out = []

    # K1 rmsnorm at the stream path's (16384, 5)
    got = rmsnorm.rmsnorm(x, scale, eps)
    err = check_close("rmsnorm (16384,5) f32", got, ref.rmsnorm_ref(x, scale, eps), F32_TOL)
    lib_fn = getattr(F, "rms_norm", None)
    b, by = bound_ms(io_bytes + d * 4, 4 * rows * d)
    out.append(dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:55", max_abs_err=err,
        ms=device_ms(lambda: rmsnorm.rmsnorm(x, scale, eps)),
        plain_ms=device_ms(lambda: ref.rmsnorm_ref(x, scale, eps)),
        bound_ms=b, bound_by=by,
        library_ms=device_ms(lambda: lib_fn(x, (d,), scale, eps)) if lib_fn else None,
        call_ms=call_ms(lambda: rmsnorm.rmsnorm(x, scale, eps)),
    ))
    log(f"K1 rmsnorm (16384,5) f32 strided: max|err| {err:.3g} (tol {F32_TOL})")

    # K1 at model widths (LM-serving shapes), f32 and bf16
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        xw = torch.randn((4096, 8192), generator=gen).to(dev, dtype)
        gw = (1.0 + 0.1 * torch.randn((8192,), generator=gen)).to(dev)
        errw = check_close(f"rmsnorm (4096,8192) {dtype}", rmsnorm.rmsnorm(xw, gw, eps),
                           ref.rmsnorm_ref(xw, gw, eps), tol)
        ms = device_ms(lambda: rmsnorm.rmsnorm(xw, gw, eps))
        bw, _ = bound_ms(2 * xw.numel() * xw.element_size() + 8192 * 4, 4 * xw.numel())
        gw_t = gw.to(dtype)
        lib_ms = device_ms(lambda: lib_fn(xw, (8192,), gw_t, eps)) if lib_fn else None
        log(f"K1 rmsnorm (4096,8192) {dtype}: max|err| {errw:.3g} (tol {tol}); "
            f"{ms * 1e3:.1f} us/launch, bound {bw * 1e3:.1f} us, "
            f"plain {device_ms(lambda: ref.rmsnorm_ref(xw, gw, eps)) * 1e3:.1f} us, "
            f"library F.rms_norm {'n/a' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}")
    rms_shape_lines(dev, gen)

    # K2 map_chain: bitwise the eager x*s+o stages on the same card
    def eager_chain(v):
        for s, o in stages:
            v = v * s + o
        return v

    err = check_bitwise("map_chain", fused.map_chain(x, stages), eager_chain(x))
    b, by = bound_ms(io_bytes, 2 * len(stages) * rows * d)
    out.append(dict(
        name="map_chain", route="cuda", source="src/repro_torch/kernels/csrc/fused.cu",
        replaces="src/repro/kernels/fused.py:78", max_abs_err=err,
        ms=device_ms(lambda: fused.map_chain(x, stages)),
        plain_ms=device_ms(lambda: ref.map_chain_ref(x, stages)),
        bound_ms=b, bound_by=by, library_ms=None,
        call_ms=call_ms(lambda: fused.map_chain(x, stages)),
    ))
    log("K2 map_chain (16384,5): bitwise equal to eager stages")

    # K3 affine_rmsnorm: bitwise eager stages followed by K1
    err = check_bitwise("affine_rmsnorm", fused.affine_rmsnorm(x, scale, stages, eps),
                        rmsnorm.rmsnorm(eager_chain(x), scale, eps))
    b, by = bound_ms(io_bytes + d * 4, (2 * len(stages) + 4) * rows * d)
    out.append(dict(
        name="affine_rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/fused.cu",
        replaces="src/repro/kernels/fused.py:103", max_abs_err=err,
        ms=device_ms(lambda: fused.affine_rmsnorm(x, scale, stages, eps)),
        plain_ms=device_ms(lambda: ref.affine_rmsnorm_ref(x, scale, stages, eps)),
        bound_ms=b, bound_by=by, library_ms=None,
        call_ms=call_ms(lambda: fused.affine_rmsnorm(x, scale, stages, eps)),
    ))
    log("K3 affine_rmsnorm (16384,5): bitwise equal to eager stages + K1")
    fused_widths(dev, gen, stages, eps)

    # kalman scan (a helper of the path, not a TPU-kernel port), bitwise the
    # plain version, from p0 = 1 and from the gain chain's fixed point (the
    # stream's state from its second step on)
    xe0 = torch.zeros(d, device=dev)
    p0 = torch.ones(d, device=dev)
    p_fix = ref.kalman_scan_ref(torch.zeros((KALMAN_SETTLE, d), device=dev), xe0, p0, 0.1, 1.0)[2]
    k_err = 0.0
    for name, pin in (("p0 = 1", p0), ("p0 at its fixed point", p_fix)):
        got = kalman.kalman_scan(x, xe0, pin, 0.1, 1.0)
        want = ref.kalman_scan_ref(x, xe0, pin, 0.1, 1.0)
        for part, g_, w_ in zip(("y", "xe", "p"), got, want):
            k_err = max(k_err, check_bitwise(f"kalman_scan {part}, {name}", g_, w_))
        ms = device_ms(lambda: kalman.kalman_scan(x, xe0, pin, 0.1, 1.0), per_graph=5, reps=5)
        host = call_ms(lambda: kalman.kalman_scan(x, xe0, pin, 0.1, 1.0), iters=20)
        log(f"kalman_scan (16384,5) {name}: bitwise equal to the plain version; "
            f"{ms * 1e3:.2f} us/launch on the device ({host * 1e3:.2f} us per call from the "
            f"host), 1 launch per call, kernel kalman_scan_kernel (chain, gain and copy warps)")
        if name == "p0 = 1":
            k_ms, k_host = ms, host
    b, by = bound_ms(io_bytes + 4 * d * 4, 8 * rows * d)
    clock = sm_clock_hz()
    floor = rows * CHAIN_CYCLES / clock * 1e3 if clock else None
    out.append(dict(
        name="kalman_scan", route="cuda", source="src/repro_torch/kernels/csrc/kalman.cu",
        replaces="src/repro/ops/riot.py:222 (lax.scan, not a Pallas kernel)",
        max_abs_err=k_err, ms=k_ms,
        # ~8 launches per row: too many to capture, timed as one call
        plain_ms=call_ms(lambda: ref.kalman_scan_ref(x, xe0, p0, 0.1, 1.0), iters=1, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None, call_ms=k_host,
    ))
    log(f"kalman_scan (16384,5): bound {b * 1e3:.3f} us ({by}); the bitwise chain's floor, "
        f"16384 rows x {CHAIN_CYCLES} cycles (dependent fsub, fmul, fadd) at the SM's "
        + (f"{clock / 1e9:.3f} GHz: {floor * 1e3:.2f} us" if clock else "clock: not read"))
    out += model_kernel_phase(dev, gen)
    out += hybrid_kernel_phase(dev, gen)
    out += xlstm_kernel_phase(dev, gen)
    mixtral_attention_checks(dev, gen)
    attention_family_checks(dev, gen)
    for k in out:
        log(f"  {k['name']}: {k['ms'] * 1e3:.2f} us/launch on the device "
            f"({k['call_ms'] * 1e3:.2f} us per call from the host), plain {k['plain_ms'] * 1e3:.2f} us, "
            f"bound {k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), library "
            + ("n/a" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.2f} us"))
    return out


# K1 at the serving path's shapes, bf16: qwen3-4b's qk-norm at a 2048-token
# prefill (q: 2048 x 32 heads of 128; k: x 8 heads), its layer-0 norm,
# zamba2-2.7b's gated out_norm (d_inner 5120), and a decode step's q-norm
RMS_SHAPES = (
    ((65536, 128), "qwen3-4b q-norm, 2048 tokens"),
    ((16384, 128), "qwen3-4b k-norm, 2048 tokens"),
    ((2048, 2560), "qwen3-4b layer-0 norm, 2048 tokens"),
    ((2048, 5120), "zamba2-2.7b out_norm, 2048 tokens"),
    ((32, 128), "qwen3-4b q-norm, one decode token"),
)


def rms_shape_lines(dev, gen):
    """K1 at RMS_SHAPES in bf16 against its plain version, on a packed input
    and on a view whose rows start 2 bytes off and have an odd stride;
    device us per launch (packed) beside the bound, the plain version and
    F.rms_norm."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, rmsnorm

    eps = 1e-6
    for (rows, d), what in RMS_SHAPES:
        wide = torch.randn((rows, d + 1), generator=gen).to(dev, torch.bfloat16)
        view = wide[:, 1:]  # unaligned rows
        x = view.contiguous()
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        err = max(check_close(f"rmsnorm {(rows, d)} bf16", rmsnorm.rmsnorm(x, g, eps),
                              ref.rmsnorm_ref(x, g, eps), BF16_TOL),
                  check_close(f"rmsnorm {(rows, d)} bf16 view", rmsnorm.rmsnorm(view, g, eps),
                              ref.rmsnorm_ref(view, g, eps), BF16_TOL))
        plan = rmsnorm.row_plan(d, 2, True)
        ms = device_ms(lambda: rmsnorm.rmsnorm(x, g, eps))
        b, by = bound_ms(2 * rows * d * 2 + d * 4, 4 * rows * d)
        g16 = g.to(torch.bfloat16)
        lib = device_ms(lambda: F.rms_norm(x, (d,), g16, eps))
        plain = device_ms(lambda: ref.rmsnorm_ref(x, g, eps))
        log(f"K1 rmsnorm ({rows},{d}) bf16, {what}: max|err| {err:.3g} packed and unaligned view "
            f"(tol {BF16_TOL}); route {plan.route}, {plan.threads} threads a row, {plan.chunks} "
            f"16-byte chunk(s) a thread; {ms * 1e3:.2f} us/launch on the device, bound "
            f"{b * 1e3:.2f} us ({by}), plain {plain * 1e3:.2f} us, library F.rms_norm "
            f"{lib * 1e3:.2f} us")


def fused_widths(dev, gen, stages, eps):
    """K3 == K1 of K2's output, bitwise in f32, at D = 128 and 5120 with K3
    reading an unaligned view and K1 K2's packed rows (D = 5 is the stream
    shape's check above); K2/K3 in bf16 against their plain versions (K2's
    bits; K3 within BF16_TOL: the norm's sum runs in another order) at the
    stream shape and at 128 and 5120."""
    import torch

    from repro_torch.kernels import fused, ref, rmsnorm

    for rows, d in ((4096, 128), (2048, 5120)):
        x = (torch.randn((rows, d + 3), generator=gen) * 4.0 + 1.0).to(dev)[:, 1:1 + d]
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        check_bitwise(f"affine_rmsnorm ({rows},{d}) f32", fused.affine_rmsnorm(x, g, stages, eps),
                      rmsnorm.rmsnorm(fused.map_chain(x, stages), g, eps))
        log(f"K3 affine_rmsnorm ({rows},{d}) f32, unaligned view: bitwise equal to K1 of K2's "
            f"output (route {rmsnorm.row_plan(d, 4, False).route}, "
            f"{rmsnorm.row_plan(d, 4, False).threads} threads a row)")
    batch = (torch.randn((MAIN_BATCH, 8), generator=gen) * 4.0 + 1.0).to(dev, torch.bfloat16)
    for name, x in (("(16384,5) strided", batch[:, 1:6]),
                    ("(4096,128)", torch.randn((4096, 128), generator=gen).to(dev, torch.bfloat16)),
                    ("(2048,5120)", torch.randn((2048, 5120), generator=gen).to(dev, torch.bfloat16))):
        d = x.shape[-1]
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        check_bitwise(f"map_chain {name} bf16", fused.map_chain(x, stages), ref.map_chain_ref(x, stages))
        err = check_close(f"affine_rmsnorm {name} bf16", fused.affine_rmsnorm(x, g, stages, eps),
                          ref.affine_rmsnorm_ref(x, g, stages, eps), BF16_TOL)
        log(f"K2 map_chain {name} bf16: bitwise equal to the plain version (f32 stages, one "
            f"rounding); K3 affine_rmsnorm {name} bf16: max|err| {err:.3g} (tol {BF16_TOL}); "
            f"{device_ms(lambda: fused.map_chain(x, stages)) * 1e3:.2f} and "
            f"{device_ms(lambda: fused.affine_rmsnorm(x, g, stages, eps)) * 1e3:.2f} us/launch on "
            f"the device")


def model_kernel_phase(dev, gen):
    """K4, K5 and K6 at the qwen3-4b serving path's shapes (bfloat16; the row
    that goes into the kernels line) and in float32 at the same shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref, rmsnorm

    eps = 1e-6
    rows, d = SERVE_PROMPT, 2560
    sq, h, kv, hd = SERVE_PROMPT, 32, 8, 128
    s_cache, clen = 4096, SERVE_PROMPT
    out = []
    for dtype, tol, attn_tol in ((torch.float32, F32_TOL, F32_TOL),
                                 (torch.bfloat16, BF16_TOL, ATTN_BF16_TOL)):
        el = torch.finfo(dtype).bits // 8
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        ops_rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S

        # K4 rmsnorm_residual at (1, 2048, 2560)
        x = torch.randn((1, rows, d), generator=gen).to(dev, dtype)
        r = torch.randn((1, rows, d), generator=gen).to(dev, dtype)
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        got_y, got_h = rmsnorm.rmsnorm_residual(x, r, g, eps)
        want_y, want_h = ref.rmsnorm_residual_ref(x, r, g, eps)
        err = max(check_close(f"rmsnorm_residual {tag}", got_y, want_y, tol),
                  check_close(f"rmsnorm_residual sum {tag}", got_h, want_h, tol))
        b, by = bound_ms(4 * rows * d * el + d * 4, 5 * rows * d)
        k4 = dict(
            name="rmsnorm_residual", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:94", max_abs_err=err,
            ms=device_ms(lambda: rmsnorm.rmsnorm_residual(x, r, g, eps)),
            plain_ms=device_ms(lambda: ref.rmsnorm_residual_ref(x, r, g, eps)),
            bound_ms=b, bound_by=by, library_ms=None,
            call_ms=call_ms(lambda: rmsnorm.rmsnorm_residual(x, r, g, eps)),
        )
        log(f"K4 rmsnorm_residual (1,{rows},{d}) {tag}: max|err| {err:.3g} (tol {tol})")

        # K5 flash_attention, causal prefill of one 2048-token prompt
        q = torch.randn((1, sq, h, hd), generator=gen).to(dev, dtype)
        k = torch.randn((1, sq, kv, hd), generator=gen).to(dev, dtype)
        v = torch.randn((1, sq, kv, hd), generator=gen).to(dev, dtype)
        got = flash_attention.flash_attention(q, k, v, causal=True)
        err = check_close(f"flash_attention {tag}", got, ref.flash_attention_ref(q, k, v), attn_tol)
        pairs = sq * (sq + 1) // 2  # visible (q, k) pairs per head
        b, by = bound_ms((2 * sq * h + 2 * sq * kv) * hd * el, 4 * h * hd * pairs, ops_rate)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        k5 = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:133", max_abs_err=err,
            ms=device_ms(lambda: flash_attention.flash_attention(q, k, v), per_graph=5),
            plain_ms=device_ms(lambda: ref.flash_attention_ref(q, k, v), per_graph=2, reps=5),
            bound_ms=b, bound_by=by,
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), per_graph=5),
            call_ms=call_ms(lambda: flash_attention.flash_attention(q, k, v), iters=20),
        )
        log(f"K5 flash_attention q (1,{sq},{h},{hd}) kv {kv} causal {tag}: max|err| {err:.3g} "
            f"(tol {attn_tol}); kernel {flash_attention.KERNELS[dtype]}")

        # K6 decode_attention: one token against a 4096-slot cache holding 2048
        q1 = torch.randn((1, 1, h, hd), generator=gen).to(dev, dtype)
        kc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)
        vc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)
        got = decode_attention.decode_attention(q1, kc, vc, clen)
        err = check_close(f"decode_attention {tag}", got,
                          ref.decode_attention_ref(q1, kc, vc, clen), attn_tol)
        b, by = bound_ms((2 * clen * kv + 2 * h) * hd * el, 4 * h * hd * clen, ops_rate)
        q1t, kct, vct = q1.transpose(1, 2), kc[:, :clen].transpose(1, 2), vc[:, :clen].transpose(1, 2)
        k6 = dict(
            name="decode_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:111", max_abs_err=err,
            ms=device_ms(lambda: decode_attention.decode_attention(q1, kc, vc, clen)),
            plain_ms=device_ms(lambda: ref.decode_attention_ref(q1, kc, vc, clen)),
            bound_ms=b, bound_by=by,
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q1t, kct, vct, enable_gqa=True)),
            call_ms=call_ms(lambda: decode_attention.decode_attention(q1, kc, vc, clen)),
        )
        log(f"K6 decode_attention q (1,1,{h},{hd}) cache (1,{s_cache},{kv},{hd}) len {clen} {tag}: "
            f"max|err| {err:.3g} (tol {attn_tol}); splits merged in one launch")
        for k_ in (k4, k5, k6):
            log(f"  {k_['name']} {tag}: {k_['ms'] * 1e3:.2f} us/launch on the device "
                f"({k_['call_ms'] * 1e3:.2f} us per call from the host), plain "
                f"{k_['plain_ms'] * 1e3:.2f} us, bound {k_['bound_ms'] * 1e3:.3f} us "
                f"({k_['bound_by']}), library "
                + ("n/a" if k_["library_ms"] is None else f"{k_['library_ms'] * 1e3:.2f} us"))
        del x, r, q, k, v, kc, vc
    out += [k4, k5, k6]  # the bfloat16 rows: the serving path's type
    return out


# K7's output is float32 whatever its inputs, and the plain version computes in
# float32 from the same (bf16-rounded) inputs, so the two differ only in the
# order of their sums (up to 128 terms per chunk) and in the cumsum's order
# inside exp(): held at 1e-4 of the largest |value| (y and the state each).
SSD_REL = 1e-4


def check_rel(name, got, want, rel) -> float:
    err = max_err(got, want)
    limit = rel * float(want.float().abs().max())
    if not err <= limit:
        raise AssertionError(f"{name}: max |err| {err} above {limit} ({rel} of max |want|)")
    return err


def ssd_bound(b, s, nh, p, n, chunk, el, ops_rate):
    """(ms, by) of one K7 call: xh, B, C in ``el`` bytes, dt f32 in, y and h
    f32 out. B and C are shared by all heads, so per (batch, chunk) of l
    positions (the ragged last chunk at its real length) C·Bᵀ needs
    l(l+1)/2·N MACs over the causal pairs, and per (batch, head, chunk)
    W·x l(l+1)/2·P (W is zero above the diagonal) and the state products
    C·h and Bᵀ·x 2lNP; two operations per MAC, at ``ops_rate``."""
    io = (b * s * nh * p * el + b * s * nh * 4 + 2 * b * s * n * el
          + b * s * nh * p * 4 + b * nh * n * p * 4)
    lens = [chunk] * (s // chunk) + ([s % chunk] if s % chunk else [])
    macs = b * sum(l * (l + 1) // 2 * n + nh * (l * (l + 1) // 2 * p + 2 * l * n * p) for l in lens)
    return bound_ms(io, 2 * macs, ops_rate)


def ssd_issued_ms(b, s, nh, p, n, chunk, group):
    """ms of the tensor-core operations K7 issues for bf16 inputs, at the
    bf16 rate: mma tiles of 16 x 16 (x 8 columns) over padded shapes, every
    chunk at its full padded length, C·Bᵀ on the tiles on or below the
    diagonal once per (batch, chunk) and head group, W·x over the same
    tiles, C·h and Bᵀ(x·w) whole; the products with an f32 operand (all
    but C·Bᵀ) twice, hi and lo."""
    up = lambda v, m: -(-v // m) * m  # noqa: E731
    lp, np_, pc = up(chunk, 16), up(n, 16), up(p, 8)
    nc = -(-s // chunk)
    tiles = (lp // 16) * (lp // 16 + 1) // 2
    blocks = b * nc * -(-nh // group)
    macs = blocks * tiles * 256 * np_ + b * nc * nh * 2 * (tiles * 256 * pc + 2 * lp * np_ * pc)
    return 2 * macs / BF16_OPS_PER_S * 1e3


def hybrid_kernel_phase(dev, gen):
    """K7 at the zamba2-2.7b prefill's shape (bf16, the row that goes into the
    kernels line; f32; a ragged S = 1109), and K5/K6 at its shared block's
    head dim of 80."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref, ssd
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    b, s, nh, p, n, chunk = 1, SERVE_PROMPT, 80, 64, 64, 128
    k7 = None
    for dtype, seq in ((torch.float32, s), (torch.bfloat16, 1109), (torch.bfloat16, s)):
        tag = f"{'bf16' if dtype == torch.bfloat16 else 'f32'} S={seq}"
        # xh, B, C in dtype; dt softplus'd and a negative, both f32, as the Mamba block passes them
        xh = torch.randn((b, seq, nh, p), generator=gen).to(dev, dtype)
        dt = F.softplus(torch.randn((b, seq, nh), generator=gen)).to(dev)
        a = -torch.exp(0.5 * torch.randn((nh,), generator=gen)).to(dev)
        bm = torch.randn((b, seq, n), generator=gen).to(dev, dtype)
        cm = torch.randn((b, seq, n), generator=gen).to(dev, dtype)
        got_y, got_h = ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk)
        want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk)
        err = max(check_rel(f"ssd_scan y {tag}", got_y, want_y, SSD_REL),
                  check_rel(f"ssd_scan h {tag}", got_h, want_h, SSD_REL))
        bf16 = dtype == torch.bfloat16
        bnd, by = ssd_bound(b, seq, nh, p, n, chunk, xh.element_size(),
                            BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S)
        f32_bnd, f32_by = ssd_bound(b, seq, nh, p, n, chunk, xh.element_size(), FP32_OPS_PER_S)
        reset_launch_counts()
        ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk)
        per_call = launch_counts()["ssd_scan"]  # kernels one call launched
        row = dict(
            name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd.cu",
            replaces="src/repro/kernels/ssd.py:90", max_abs_err=err,
            ms=device_ms(lambda: ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk), per_graph=5),
            plain_ms=device_ms(lambda: ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk),
                               per_graph=2, reps=5),
            bound_ms=bnd, bound_by=by, library_ms=None,
            call_ms=call_ms(lambda: ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk), iters=20),
        )
        rate = "bf16 tensor-core rate" if bf16 else "f32 rate"
        extra = ""
        if bf16:
            group = ssd._plan(xh.device, b, -(-seq // chunk), nh, chunk, n, p)
            extra = (f"; at the f32 rate {f32_bnd * 1e3:.3f} us ({f32_by}); the tensor-core "
                     f"operations issued (head group {group}) "
                     f"{ssd_issued_ms(b, seq, nh, p, n, chunk, group) * 1e3:.3f} us at the bf16 rate")
        log(f"K7 ssd_scan xh ({b},{seq},{nh},{p}) N {n} chunk {chunk} {tag}: max|err| {err:.3g} "
            f"(y {float(want_y.abs().max()):.3g}, h {float(want_h.abs().max()):.3g} max; "
            f"limit {SSD_REL} of each); kernel {ssd.KERNELS[dtype]}, {per_call} launch(es) per "
            f"call; {row['ms'] * 1e3:.2f} us per call on the device ({row['call_ms'] * 1e3:.2f} "
            f"us per call from the host), plain {row['plain_ms'] * 1e3:.2f} us, bound "
            f"{bnd * 1e3:.3f} us ({by}, {rate}){extra}, library: none")
        k7 = row  # the last: bf16 at S = 2048, the serving path's prefill

    # K5 and K6 at zamba2's shared attention: 32 heads over 32 KV heads of 80,
    # in f32 (the SIMT build of K5) and in bf16 (the serving path's type)
    h, kv, hd, s_cache = 32, 32, 80, 4096
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, ATTN_BF16_TOL)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        el = torch.finfo(dtype).bits // 8
        ops_rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        q = torch.randn((1, s, h, hd), generator=gen).to(dev, dtype)
        k = torch.randn((1, s, kv, hd), generator=gen).to(dev, dtype)
        v = torch.randn((1, s, kv, hd), generator=gen).to(dev, dtype)

        def k5():
            return flash_attention.flash_attention(q, k, v, causal=True, window=4096)

        err = check_close(f"flash_attention hd 80 {tag}", k5(),
                          ref.flash_attention_ref(q, k, v, causal=True, window=4096), tol)
        pairs = s * (s + 1) // 2
        bnd, by = bound_ms((2 * s * h + 2 * s * kv) * hd * el, 4 * h * hd * pairs, ops_rate)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, host = device_ms(k5, per_graph=5), call_ms(k5, iters=20)
        lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                        per_graph=5)
        log(f"K5 flash_attention q (1,{s},{h},{hd}) kv {kv} causal window 4096 {tag}: max|err| "
            f"{err:.3g} (tol {tol}); kernel {flash_attention.KERNELS[dtype]}; {ms * 1e3:.2f} "
            f"us/launch on the device ({host * 1e3:.2f} us per call from the host), bound "
            f"{bnd * 1e3:.3f} us ({by}), library F.scaled_dot_product_attention {lib * 1e3:.2f} us")
        q1 = torch.randn((1, 1, h, hd), generator=gen).to(dev, dtype)
        kc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)
        vc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)

        def k6():
            return decode_attention.decode_attention(q1, kc, vc, s, window=4096)

        err = check_close(f"decode_attention hd 80 {tag}", k6(),
                          ref.decode_attention_ref(q1, kc, vc, s, window=4096), tol)
        bnd, by = bound_ms((2 * s * kv + 2 * h) * hd * el, 4 * h * hd * s, ops_rate)
        q1t, kct, vct = q1.transpose(1, 2), kc[:, :s].transpose(1, 2), vc[:, :s].transpose(1, 2)
        ms, host = device_ms(k6), call_ms(k6)
        lib = device_ms(lambda: F.scaled_dot_product_attention(q1t, kct, vct))
        log(f"K6 decode_attention q (1,1,{h},{hd}) cache (1,{s_cache},{kv},{hd}) len {s} {tag}: "
            f"max|err| {err:.3g} (tol {tol}); {ms * 1e3:.2f} us/launch on the device "
            f"({host * 1e3:.2f} us per call from the host), bound {bnd * 1e3:.3f} us ({by}), library "
            f"F.scaled_dot_product_attention {lib * 1e3:.2f} us")
        del q, k, v, kc, vc
    head_dim_checks(dev, gen, 96, 8, 192)
    head_dim_checks(dev, gen, 32, 8, 96)
    # above the built head dims: the pieces kernel, at Gemma-class 256 and
    # at 320, which is no multiple of 64 (a ragged last piece)
    head_dim_checks(dev, gen, 16, 8, 256)
    head_dim_checks(dev, gen, 16, 8, 320)
    ssd_route_checks(dev, gen)
    return [k7]


# K7 where neither the SIMT nor the tensor-core build fits: f32 at
# chunk = N = P = 128, and chunk 256 with N 192 and P 160 in f32 and bf16
SSD_TILE_CASES = (("float32", 128, 128, 128), ("float32", 256, 192, 160),
                  ("bfloat16", 256, 192, 160))


def ssd_route_checks(dev, gen):
    """K7's tiled build against its plain version, timed beside its bound
    (bf16 inputs at the bf16 tensor-core rate, with the f32 rate's beside
    it: the build runs f32 FMAs whatever its inputs)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, ssd
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    b, s, nh = 1, SERVE_PROMPT, 24
    for dname, chunk, n, p in SSD_TILE_CASES:
        dtype = getattr(torch, dname)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        xh = torch.randn((b, s, nh, p), generator=gen).to(dev, dtype)
        dt = F.softplus(torch.randn((b, s, nh), generator=gen)).to(dev)
        a = -torch.exp(0.5 * torch.randn((nh,), generator=gen)).to(dev)
        bm = torch.randn((b, s, n), generator=gen).to(dev, dtype)
        cm = torch.randn((b, s, n), generator=gen).to(dev, dtype)
        h0 = torch.randn((b, nh, n, p), generator=gen).to(dev)

        def k7():
            return ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk, h0=h0)

        reset_launch_counts()
        got_y, got_h = k7()
        per_call = launch_counts()["ssd_scan"]
        want_y, want_h = ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk, h0)
        err = max(check_rel(f"ssd_scan y {tag} chunk {chunk} N {n} P {p}", got_y, want_y, SSD_REL),
                  check_rel(f"ssd_scan h {tag} chunk {chunk} N {n} P {p}", got_h, want_h, SSD_REL))
        # the least time for the work: bf16 inputs at the bf16 tensor-core
        # rate (the build itself issues f32 FMAs: the f32 rate's beside it)
        bf16 = dtype == torch.bfloat16
        bnd, by = ssd_bound(b, s, nh, p, n, chunk, xh.element_size(),
                            BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S)
        f32_bnd, f32_by = ssd_bound(b, s, nh, p, n, chunk, xh.element_size(), FP32_OPS_PER_S)
        ms = device_ms(k7, per_graph=2, reps=5)
        plain = device_ms(lambda: ref.ssd_scan_ref(xh, dt, a, bm, cm, chunk, h0), per_graph=1, reps=3)
        log(f"K7 ssd_scan xh ({b},{s},{nh},{p}) N {n} chunk {chunk} {tag}, with h0: max|err| "
            f"{err:.3g} (limit {SSD_REL} of max |y|, |h|); kernel "
            f"{ssd.kernel_name(dtype, chunk, n, p)}, {per_call} launch(es) per call; "
            f"{ms * 1e3:.2f} us per call on the device, plain {plain * 1e3:.2f} us, bound "
            f"{bnd * 1e3:.3f} us ({by}, {'bf16 tensor-core' if bf16 else 'f32'} rate; at the "
            f"f32 rate {f32_bnd * 1e3:.3f} us, {f32_by}), library: none")
        del xh, bm, cm, got_y, want_y


# K5/K6 against F.scaled_dot_product_attention's output: the library rounds
# where the plain version does not (its flash kernel feeds P to the tensor
# cores in bf16, up to |v| * 2**-9 off), so its output is held at the bf16
# tolerance, which a wrong row or head still misses by far
# the ssm family's scans at xlstm-1.3b's prefill of SERVE_PROMPT tokens: 4
# heads, the mLSTM's P = 4096 / 4 = 1024 at chunk 64, the sLSTM's hd = 512
XLSTM_HEADS, MLSTM_P, MLSTM_CHUNK, SLSTM_HD = 4, 1024, 64, 512
MLSTM_RAGGED = 2039  # 31 whole chunks and one of 55
# Both kernels sum in float32, as their plain versions do from the same
# inputs. Their products run on the tensor cores with bf16 operands: exact
# bf16 inputs, and each float32 operand as bf16 terms (the mLSTM's W, C and
# v·to_end as two terms, 2^-16 relative, beside bf16 inputs and as three,
# about 2^-24, beside f32 ones; the sLSTM's h as three). With the order of
# their sums (over P = 1024 columns and 64 positions; over hd = 512 and the
# head means) each output is held at 1e-4 of its largest |value|.
SCAN_REL = 1e-4


def mlstm_bound(b, s, nh, p, chunk, el, ops_rate):
    """(ms, by) of one mlstm_scan call: q, k, v in ``el`` bytes and the two
    gates in float32 read, y and the final (C, n, m) in float32 written; per
    (batch, head) the causal pairs of each chunk (the ragged last at its
    length) need l(l+1)/2·P MACs for q·kᵀ and as many for W·v, and each
    position P² for C·q and P² for its term of the C update."""
    io = 3 * b * s * nh * p * el + 2 * b * s * nh * 4 + b * s * nh * p * 4 + b * nh * (p * p + p + 1) * 4
    lens = [chunk] * (s // chunk) + ([s % chunk] if s % chunk else [])
    macs = b * nh * sum(l * (l + 1) * p + 2 * l * p * p for l in lens)
    return bound_ms(io, 2 * macs, ops_rate)


def slstm_bound(b, s, nh, hd, el, r_el, ops_rate):
    """(ms, by) of one slstm_scan call: xg (4 gates) in ``el`` bytes and R in
    ``r_el`` read once, hs and the final state in float32 written; each step
    4·hd² MACs a head for h·R (the rest is O(hd))."""
    io = 4 * b * s * nh * hd * el + 4 * nh * hd * hd * r_el + b * s * nh * hd * 4 + b * nh * (3 * hd + 1) * 4
    return bound_ms(io, 2 * 4 * b * s * nh * hd * hd, ops_rate)


def xlstm_kernel_phase(dev, gen):
    """mlstm_scan and slstm_scan at xlstm-1.3b's prefill of 2048 tokens
    against their plain versions on the card: the mLSTM scan in f32 and
    with bf16 inputs (the row that goes into the kernels line: the serving
    path's), at a ragged S, and from a carried state; the sLSTM recurrence
    with f32 and with bf16 xg and R (the serving path's)."""
    import torch

    from repro_torch.kernels import mlstm, ref, slstm

    b, s, nh, p, chunk = 1, SERVE_PROMPT, XLSTM_HEADS, MLSTM_P, MLSTM_CHUNK
    rows = []
    for dtype, seq in ((torch.float32, s), (torch.float32, MLSTM_RAGGED), (torch.bfloat16, s)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        el = torch.finfo(dtype).bits // 8
        q, k, v = (torch.randn((b, seq, nh, p), generator=gen).to(dev, dtype) for _ in range(3))
        ig, fg = (torch.randn((b, seq, nh), generator=gen).to(dev) for _ in range(2))
        got_y, got_state = mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk)
        want_y, want_state = ref.mlstm_scan_ref(q, k, v, ig, fg, chunk)
        err = check_rel(f"mlstm_scan {tag} S {seq} y", got_y, want_y, SCAN_REL)
        for name, g_, w_ in zip("Cnm", got_state, want_state):
            err = max(err, check_rel(f"mlstm_scan {tag} S {seq} {name}", g_, w_, SCAN_REL))
        del want_y, want_state, got_y, got_state
        torch.cuda.empty_cache()
        fn = lambda: mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk)  # noqa: E731
        ms, host = device_ms(fn, per_graph=2, reps=5), call_ms(fn, iters=5, warmup=1)
        plain = call_ms(lambda: ref.mlstm_scan_ref(q, k, v, ig, fg, chunk), iters=3, warmup=1)
        torch.cuda.empty_cache()
        rate, ops_rate = ("bf16", BF16_OPS_PER_S) if dtype == torch.bfloat16 else ("f32", FP32_OPS_PER_S)
        bnd, by = mlstm_bound(b, seq, nh, p, chunk, el, ops_rate)
        plan = mlstm.launch_plan(b, seq, nh, p, chunk, dtype)
        log(f"mlstm_scan q/k/v ({b},{seq},{nh},{p}) chunk {chunk} {tag}: max|err| {err:.3g} "
            f"over y, C, n, m (each within {SCAN_REL} of its largest |value|); {plan}; "
            f"{ms * 1e3:.1f} us per call on the device ({host * 1e3:.1f} us per call from the "
            f"host), plain {plain * 1e3:.1f} us, bound {bnd * 1e3:.1f} us ({by}, {rate}), "
            f"library: none")
        rows.append(dict(
            name="mlstm_scan", route="cuda", source="src/repro_torch/kernels/csrc/mlstm.cu",
            replaces="src/repro/models/xlstm.py:54 (mlstm_chunked, jnp under the "
                     "kernel_mlstm_scan scope, not a Pallas kernel)",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
            call_ms=host, plan=plan))
        del q, k, v, ig, fg
    # from a carried state: the first 1000 positions, then the rest from their state
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        q, k, v = (torch.randn((b, 1500, nh, p), generator=gen).to(dev, dtype) for _ in range(3))
        ig, fg = (torch.randn((b, 1500, nh), generator=gen).to(dev) for _ in range(2))
        _, mid = ref.mlstm_scan_ref(q[:, :1000], k[:, :1000], v[:, :1000], ig[:, :1000], fg[:, :1000],
                                    chunk)
        tail = (q[:, 1000:], k[:, 1000:], v[:, 1000:], ig[:, 1000:], fg[:, 1000:])
        got_y, got_state = mlstm.mlstm_scan(*tail, chunk=chunk, state=mid)
        want_y, want_state = ref.mlstm_scan_ref(*tail, chunk, mid)
        err = check_rel(f"mlstm_scan {tag} from a state y", got_y, want_y, SCAN_REL)
        for name, g_, w_ in zip("Cnm", got_state, want_state):
            err = max(err, check_rel(f"mlstm_scan {tag} from a state {name}", g_, w_, SCAN_REL))
        log(f"mlstm_scan {tag} from the state of 1000 positions over the next 500: "
            f"max|err| {err:.3g} over y, C, n, m (each within {SCAN_REL} of its largest |value|)")
        del q, k, v, ig, fg, mid, tail, got_y, got_state, want_y, want_state
        torch.cuda.empty_cache()

    hd = SLSTM_HD
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        el = torch.finfo(dtype).bits // 8
        xg = torch.randn((b, s, 4 * nh * hd), generator=gen).to(dev, dtype)
        r = (torch.randn((4, nh, hd, hd), generator=gen) * hd ** -0.5).to(dev, dtype)
        got_h, got_state = slstm.slstm_scan(xg, r)
        want_h, want_state = ref.slstm_scan_ref(xg, r)
        err = check_rel(f"slstm_scan {tag} hs", got_h, want_h, SCAN_REL)
        for name, g_, w_ in zip("hcnm", got_state, want_state):
            err = max(err, check_rel(f"slstm_scan {tag} {name}", g_, w_, SCAN_REL))
        fn = lambda: slstm.slstm_scan(xg, r)  # noqa: E731
        ms, host = device_ms(fn, per_graph=1, reps=3), call_ms(fn, iters=3, warmup=1)
        # the chain's floor: the same clusters doing the S steps' h exchange
        # and barrier alone (not a kernel of the path: no launch counted)
        floor = device_ms(lambda: slstm.chain_floor(b, s, nh, hd, dtype, dev), per_graph=1, reps=3)
        # ~15 launches per step: too many to capture, timed as one call
        plain = call_ms(lambda: ref.slstm_scan_ref(xg, r), iters=1, warmup=1)
        rate, ops_rate = ("bf16", BF16_OPS_PER_S) if dtype == torch.bfloat16 else ("f32", FP32_OPS_PER_S)
        bnd, by = slstm_bound(b, s, nh, hd, el, el, ops_rate)
        plan = slstm.launch_plan(hd, dtype, dtype)
        log(f"slstm_scan xg ({b},{s},{4 * nh * hd}) R (4,{nh},{hd},{hd}) {tag}: max|err| {err:.3g} "
            f"over hs, h, c, n, m (each within {SCAN_REL} of its largest |value|); {plan}; "
            f"{ms * 1e3:.1f} us per call on the device ({host * 1e3:.1f} us per call from the host), "
            f"{ms * 1e3 / s:.3f} us a step against the chain's floor of {floor * 1e3 / s:.3f} us a "
            f"step; plain {plain * 1e3:.1f} us, bound {bnd * 1e3:.1f} us ({by}, {rate}), library: none")
        row = dict(
            name="slstm_scan", route="cuda", source="src/repro_torch/kernels/csrc/slstm.cu",
            replaces="src/repro/models/xlstm.py:262 (lax.scan of _slstm_cell, not a Pallas "
                     "kernel)",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
            call_ms=host, plan=plan, chain_floor_ms=floor)
        del xg, r, got_h, want_h
    return [rows[-1], row]  # the bf16 rows: the serving path's types


LIB_TOL = BF16_TOL


def decode_route(dtype, hd) -> str:
    from repro_torch.kernels import flash_attention

    if hd > flash_attention.HEAD_DIMS[-1]:
        return flash_attention.PIECES_KERNEL
    return "decode_split (splits merged in one launch)"


def head_dim_checks(dev, gen, h, kv, hd):
    """K5 and K6 at ``h`` q heads over ``kv`` KV heads of ``hd``, in f32 (the
    SIMT build of K5) and bf16 (wgmma), each against its plain version and
    F.scaled_dot_product_attention's output, and timed beside that library
    call: nemotron-4-340b's attention (96 over 8 of 192, the widest build),
    and a head dim the kernels are not built for (96, run zero-padded to
    128; the bound is the true head dim's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref

    s, s_cache = SERVE_PROMPT, 4096
    width = hd if hd > flash_attention.HEAD_DIMS[-1] else flash_attention.padded_head_dim(hd)
    route = "" if width == hd else f", zero-padded to {width}"
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, ATTN_BF16_TOL)):
        tag = ("bf16" if dtype == torch.bfloat16 else "f32") + route
        el = torch.finfo(dtype).bits // 8
        ops_rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        q = torch.randn((1, s, h, hd), generator=gen).to(dev, dtype)
        k = torch.randn((1, s, kv, hd), generator=gen).to(dev, dtype)
        v = torch.randn((1, s, kv, hd), generator=gen).to(dev, dtype)

        def k5():
            return flash_attention.flash_attention(q, k, v, causal=True)

        err = check_close(f"flash_attention hd {hd} {tag}", k5(), ref.flash_attention_ref(q, k, v), tol)
        bnd, by = bound_ms((2 * s * h + 2 * s * kv) * hd * el, 4 * h * hd * (s * (s + 1) // 2),
                           ops_rate)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_err = check_close(
            f"flash_attention hd {hd} {tag} vs the library", k5(),
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2),
            LIB_TOL)
        ms = device_ms(k5, per_graph=3, reps=7)
        plain = device_ms(lambda: ref.flash_attention_ref(q, k, v), per_graph=1, reps=3)
        lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                               enable_gqa=True), per_graph=3, reps=7)
        log(f"K5 flash_attention q (1,{s},{h},{hd}) kv {kv} causal {tag}: max|err| {err:.3g} "
            f"(tol {tol}), {lib_err:.3g} from the library's output (tol {LIB_TOL}); kernel "
            f"{flash_attention.route(dtype, hd)}; {ms * 1e3:.2f} us/launch on "
            f"the device, bound {bnd * 1e3:.3f} us ({by}), plain {plain * 1e3:.2f} us, library "
            f"F.scaled_dot_product_attention {lib * 1e3:.2f} us")
        del q, k, v, qt, kt, vt
        q1 = torch.randn((1, 1, h, hd), generator=gen).to(dev, dtype)
        kc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)
        vc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)

        def k6():
            return decode_attention.decode_attention(q1, kc, vc, s)

        err = check_close(f"decode_attention hd {hd} {tag}", k6(),
                          ref.decode_attention_ref(q1, kc, vc, s), tol)
        bnd, by = bound_ms((2 * s * kv + 2 * h) * hd * el, 4 * h * hd * s, ops_rate)
        q1t, kct, vct = q1.transpose(1, 2), kc[:, :s].transpose(1, 2), vc[:, :s].transpose(1, 2)
        lib_err = check_close(
            f"decode_attention hd {hd} {tag} vs the library", k6(),
            F.scaled_dot_product_attention(q1t, kct, vct, enable_gqa=True).transpose(1, 2), LIB_TOL)
        ms, plain = device_ms(k6), device_ms(lambda: ref.decode_attention_ref(q1, kc, vc, s))
        lib = device_ms(lambda: F.scaled_dot_product_attention(q1t, kct, vct, enable_gqa=True))
        log(f"K6 decode_attention q (1,1,{h},{hd}) cache (1,{s_cache},{kv},{hd}) len {s} {tag}: "
            f"max|err| {err:.3g} (tol {tol}), {lib_err:.3g} from the library's output (tol "
            f"{LIB_TOL}); kernel {decode_route(dtype, hd)}; {ms * 1e3:.2f} us/launch on the device, bound "
            f"{bnd * 1e3:.3f} us ({by}), plain {plain * 1e3:.2f} us, library "
            f"F.scaled_dot_product_attention {lib * 1e3:.2f} us")
        del q1, kc, vc


MIXTRAL_HEADS = (48, 8, 128)  # q heads over KV heads (a GQA group of 6), head dim
MIXTRAL_WINDOW, MASKING_WINDOW = 4096, 1024
MASKED_CACHE_LEN = 3000  # K6's cache length under the masking window


def visible_pairs(sq, window) -> int:
    """(q, k) pairs a causal attention over ``sq`` positions sees under a
    window of ``window`` keys: min(i + 1, window) for row i."""
    w = min(window, sq)
    return w * (w + 1) // 2 + (sq - w) * w


def mixtral_attention_checks(dev, gen):
    """K5 and K6 at mixtral-8x22b's attention (MIXTRAL_HEADS), f32 and bf16,
    each against its plain version: K5 on a causal prefill of SERVE_PROMPT
    tokens under mixtral's window (which does not mask at that length; timed
    beside F.scaled_dot_product_attention, whose output it is also held to)
    and under MASKING_WINDOW (which does); K6 for one token against a
    4096-slot ring holding SERVE_PROMPT under mixtral's window (timed beside
    the library) and holding MASKED_CACHE_LEN under MASKING_WINDOW."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref

    h, kv, hd = MIXTRAL_HEADS
    s, s_cache = SERVE_PROMPT, 4096
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, ATTN_BF16_TOL)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        el = torch.finfo(dtype).bits // 8
        ops_rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        q = torch.randn((1, s, h, hd), generator=gen).to(dev, dtype)
        k = torch.randn((1, s, kv, hd), generator=gen).to(dev, dtype)
        v = torch.randn((1, s, kv, hd), generator=gen).to(dev, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        for window in (MIXTRAL_WINDOW, MASKING_WINDOW):
            def k5():
                return flash_attention.flash_attention(q, k, v, causal=True, window=window)

            err = check_close(f"flash_attention mixtral window {window} {tag}", k5(),
                              ref.flash_attention_ref(q, k, v, causal=True, window=window), tol)
            bnd, by = bound_ms((2 * s * h + 2 * s * kv) * hd * el,
                               4 * h * hd * visible_pairs(s, window), ops_rate)
            ms = device_ms(k5, per_graph=3, reps=7)
            plain = device_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True, window=window),
                              per_graph=1, reps=3)
            lib = ""
            if window >= s:  # the window does not mask: the library's causal call
                lib_err = check_close(
                    f"flash_attention mixtral {tag} vs the library", k5(),
                    F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True).transpose(1, 2), LIB_TOL)
                lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), per_graph=3, reps=7)
                lib = (f", {lib_err:.3g} from the library's output (tol {LIB_TOL}); library "
                       f"F.scaled_dot_product_attention {lib_ms * 1e3:.2f} us")
            log(f"K5 flash_attention mixtral q (1,{s},{h},{hd}) kv {kv} causal window {window} "
                f"{tag}: max|err| {err:.3g} (tol {tol}); kernel {flash_attention.route(dtype, hd)}; "
                f"{ms * 1e3:.2f} us/launch on the device, bound {bnd * 1e3:.3f} us ({by}), plain "
                f"{plain * 1e3:.2f} us{lib}")
        del q, k, v, qt, kt, vt
        q1 = torch.randn((1, 1, h, hd), generator=gen).to(dev, dtype)
        kc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)
        vc = torch.randn((1, s_cache, kv, hd), generator=gen).to(dev, dtype)
        for clen, window in ((s, MIXTRAL_WINDOW), (MASKED_CACHE_LEN, MASKING_WINDOW)):
            def k6():
                return decode_attention.decode_attention(q1, kc, vc, clen, window=window)

            err = check_close(f"decode_attention mixtral len {clen} window {window} {tag}", k6(),
                              ref.decode_attention_ref(q1, kc, vc, clen, window=window), tol)
            seen = min(clen, window)
            bnd, by = bound_ms((2 * seen * kv + 2 * h) * hd * el, 4 * h * hd * seen, ops_rate)
            ms, host = device_ms(k6), call_ms(k6)
            plain = device_ms(lambda: ref.decode_attention_ref(q1, kc, vc, clen, window=window))
            lib = ""
            if window >= clen:
                q1t, kct, vct = (q1.transpose(1, 2), kc[:, :clen].transpose(1, 2),
                                 vc[:, :clen].transpose(1, 2))
                lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q1t, kct, vct,
                                                                          enable_gqa=True))
                lib = f", library F.scaled_dot_product_attention {lib_ms * 1e3:.2f} us"
            log(f"K6 decode_attention mixtral q (1,1,{h},{hd}) cache (1,{s_cache},{kv},{hd}) len "
                f"{clen} window {window} {tag}: max|err| {err:.3g} (tol {tol}); kernel "
                f"{decode_route(dtype, hd)}; {ms * 1e3:.2f} us/launch on the device ({host * 1e3:.2f} "
                f"us per call from the host), bound {bnd * 1e3:.3f} us ({by}), plain "
                f"{plain * 1e3:.2f} us{lib}")
        del q1, kc, vc


# K5's routes on the MLA, vlm and audio serving paths, each (label, Sq, Sk, q
# heads, KV heads, q/k head dim, v head dim, causal): (a) deepseek-v2's MLA
# prefill, q/k head dim nope 128 + rope 64 against v's 128 (v zero-padded to
# 192, the output sliced); (b) the seamless encoder's self-attention without a
# mask; (c) llama-3.2-vision's cross-attention at prefill, a prompt against its
# 1024 image tokens without a mask, at 2048 and at a ragged 159 tokens
ATTN_FAMILY_K5 = (
    ("(a) deepseek-v2 MLA", SERVE_PROMPT, SERVE_PROMPT, 128, 128, 192, 128, True),
    ("(b) seamless encoder", 1024, 1024, 16, 16, 64, 64, False),
    ("(c) llama-3.2-vision cross", SERVE_PROMPT, 1024, 64, 8, 128, 128, False),
    ("(c) llama-3.2-vision cross", 159, 1024, 64, 8, 128, 128, False),
)
CROSS_K6 = (64, 8, 128, 1024)  # a decoded token's cross-attention: q heads, KV heads, hd, memory


def attention_family_checks(dev, gen):
    """K5 on routes (a)-(c) (ATTN_FAMILY_K5) and K6 on a decoded token's
    cross-attention (CROSS_K6: one query against the whole memory,
    cache_len = Sm), f32 and bf16, each against its plain version and
    F.scaled_dot_product_attention's output, timed beside that library call;
    the bound counts the visible (q, k) pairs at the operation rate of the
    dtype (K5) and the bytes (K6)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, ATTN_BF16_TOL)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        el = torch.finfo(dtype).bits // 8
        ops_rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        for label, sq, sk, h, kv, hd, hd_v, causal in ATTN_FAMILY_K5:
            q = torch.randn((1, sq, h, hd), generator=gen).to(dev, dtype)
            k = torch.randn((1, sk, kv, hd), generator=gen).to(dev, dtype)
            v = torch.randn((1, sk, kv, hd_v), generator=gen).to(dev, dtype)
            scale = hd ** -0.5  # MLA's (nope + rope)^-0.5, passed as the model passes it

            def k5():
                return flash_attention.flash_attention(q, k, v, causal=causal, scale=scale)

            err = check_close(f"flash_attention {label} {tag}", k5(),
                              ref.flash_attention_ref(q, k, v, causal=causal, scale=scale), tol)
            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            bnd, by = bound_ms((sq * h * (hd + hd_v) + sk * kv * (hd + hd_v)) * el,
                               2 * h * (hd + hd_v) * pairs, ops_rate)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def lib_call():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale,
                                                      enable_gqa=kv < h)

            lib_err = check_close(f"flash_attention {label} {tag} vs the library", k5(),
                                  lib_call().transpose(1, 2), LIB_TOL)
            ms = device_ms(k5, per_graph=3, reps=7)
            plain = device_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal, scale=scale),
                              per_graph=1, reps=3)
            lib = device_ms(lib_call, per_graph=3, reps=7)
            log(f"K5 flash_attention {label} q (1,{sq},{h},{hd}) kv (1,{sk},{kv}) v head dim "
                f"{hd_v} {'causal' if causal else 'no mask'} {tag}: max|err| {err:.3g} (tol {tol}), "
                f"{lib_err:.3g} from the library's output (tol {LIB_TOL}); kernel "
                f"{flash_attention.route(dtype, hd, hd_v)}; {ms * 1e3:.2f} us/launch on the "
                f"device, bound {bnd * 1e3:.3f} us ({by}), plain {plain * 1e3:.2f} us, library "
                f"F.scaled_dot_product_attention {lib * 1e3:.2f} us")
            del q, k, v, qt, kt, vt
        h, kv, hd, sm = CROSS_K6
        q1 = torch.randn((1, 1, h, hd), generator=gen).to(dev, dtype)
        kc = torch.randn((1, sm, kv, hd), generator=gen).to(dev, dtype)
        vc = torch.randn((1, sm, kv, hd), generator=gen).to(dev, dtype)

        def k6():
            return decode_attention.decode_attention(q1, kc, vc, sm)

        err = check_close(f"decode_attention cross {tag}", k6(),
                          ref.decode_attention_ref(q1, kc, vc, sm), tol)
        bnd, by = bound_ms((2 * sm * kv + 2 * h) * hd * el, 4 * h * hd * sm, ops_rate)
        q1t, kct, vct = q1.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        lib_err = check_close(
            f"decode_attention cross {tag} vs the library", k6(),
            F.scaled_dot_product_attention(q1t, kct, vct, enable_gqa=True).transpose(1, 2), LIB_TOL)
        ms, host = device_ms(k6), call_ms(k6)
        plain = device_ms(lambda: ref.decode_attention_ref(q1, kc, vc, sm))
        lib = device_ms(lambda: F.scaled_dot_product_attention(q1t, kct, vct, enable_gqa=True))
        log(f"K6 decode_attention llama-3.2-vision cross q (1,1,{h},{hd}) memory (1,{sm},{kv},{hd}) "
            f"len {sm} {tag}: max|err| {err:.3g} (tol {tol}), {lib_err:.3g} from the library's "
            f"output (tol {LIB_TOL}); kernel {decode_route(dtype, hd)}; {ms * 1e3:.2f} us/launch "
            f"on the device ({host * 1e3:.2f} us per call from the host), bound {bnd * 1e3:.3f} us "
            f"({by}), plain {plain * 1e3:.2f} us, library F.scaled_dot_product_attention "
            f"{lib * 1e3:.2f} us")
        del q1, kc, vc


# -- phase 3: the main path ------------------------------------------------------------

def run_script(base_batch, device, fuse, capture=True, waves=None, backend=None,
               fuse_kw=None, **stepping):
    """The stream path's script; returns (digests, per-step wall ms, system).
    ``capture=False`` steps eagerly on the card (no CUDA graphs);
    ``stepping`` are StreamSystem's step_mode and max_workers. With a list
    ``waves``, each wave event is appended to it with the waves and the
    segments the backend had when it fired. ``backend`` replaces the torch
    backend (the multiproc one of phase 3c); ``fuse_kw`` goes to fuse()."""
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    if backend is None:
        backend = TorchBackend(device, capture=capture)
    system = StreamSystem(backend=backend, base_batch=base_batch, **stepping)
    if waves is not None:
        def on_wave(event):
            backend = system.backend
            waves.append((event, [list(w) for w in backend.segment_waves()],
                          sorted(backend.segments)))

        system.backend.configure_stepping(on_wave=on_wave)
    flows = riot_workload() + kernel_flows()
    for df in flows:
        system.submit(df)
    walls = [r.wall_ms for r in system.run(3)]
    fused = system.fuse(**(fuse_kw or {})) if fuse else {}
    if fuse and not fused:
        raise AssertionError("fuse() fused no segment chain")
    walls += [r.wall_ms for r in system.run(3)]
    for name in REMOVED:
        system.remove(name)
    walls += [r.wall_ms for r in system.run(2)]
    digests = {df.name: system.sink_digests(df.name) for df in flows if df.name not in REMOVED}
    return digests, walls, system


# host calls that put work on the card: kernel launches, graph launches,
# and the copies and fills torch issues as their own calls
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def step_launches(system):
    """One more step of ``system`` under torch.profiler: (host launch calls,
    of them graph launches, operations the card ran: kernels, copies and
    fills)."""
    return fn_launches(system.step)


def fn_launches(fn):
    """One call of ``fn`` under torch.profiler, as :func:`step_launches`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = graphs = on_card = 0
    for ev in prof.events():
        if "CUDA" in str(ev.device_type):
            on_card += 1
        elif ev.name in LAUNCH_CALLS:
            calls += 1
            graphs += ev.name == "cudaGraphLaunch"
    return calls, graphs, on_card


def capture_line(label, backend, steps):
    """The captured steps of ``backend`` over ``steps`` steps, as one line."""
    import torch

    st = backend.capture_stats
    ms = st.capture_ms
    per = (f"capture ms per graph median {statistics.median(ms):.3f} (min {min(ms):.3f}, max "
           f"{max(ms):.3f}, total {sum(ms):.1f})") if ms else "no capture"
    return (f"{label}: {st.graphs} graphs captured, {per}, {st.eager_steps} eager warm-up "
            f"segment steps, {st.replays} graph replays ({st.replays / max(steps, 1):.1f} a step), "
            f"{st.input_copies / max(steps, 1):.1f} input copies a step, graph pools "
            f"{st.pool_bytes / 2**20:.1f} MiB, memory_reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")


STEADY = 20  # steady steps timed after the script, sync against concurrent


def check_waves(label, events, steps):
    """Every step's events cover every segment once, in the waves
    ``segment_waves()`` gave, indexed 0..n-1."""
    by_step = {}
    for event, waves, segments in events:
        by_step.setdefault(event.step, []).append((event, waves, segments))
    if sorted(by_step) != list(range(1, steps + 1)):
        raise AssertionError(f"{label}: wave events for steps {sorted(by_step)}")
    for step, group in by_step.items():
        waves, segments = group[0][1], group[0][2]
        if [e.index for e, _, _ in group] != list(range(len(waves))):
            raise AssertionError(f"{label}: step {step} wave indices {[e.index for e, _, _ in group]}")
        if [list(e.segments) for e, _, _ in group] != waves:
            raise AssertionError(f"{label}: step {step} waves differ from segment_waves()")
        stepped = [n for e, _, _ in group for n in e.segments]
        if sorted(stepped) != segments:
            raise AssertionError(f"{label}: step {step} stepped {stepped}, segments {segments}")


def steady(system):
    """STEADY more steps: (wall ms, makespan ms) of each."""
    import torch

    torch.cuda.synchronize()
    reports = system.run(STEADY)
    return [r.wall_ms for r in reports], [r.makespan_ms for r in reports]


def verdicts(system):
    report = system.fusion_report.to_dict()
    return sorted((tuple(d["members"]), d["accepted"]) for d in
                  report["accepted"] + report["rejected"])


def main_path_phase(dev):
    import torch

    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    fused_digests, walls, system = run_script(MAIN_BATCH, dev, fuse=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    log(f"main path: {len(system.manager.submitted)} dataflows live, "
        f"{system.deployed_task_count} tasks deployed, {len(system.backend.segments)} segments, "
        f"{run_s:.2f} s; launches {launches}")
    for name in ("rmsnorm", "map_chain", "affine_rmsnorm", "kalman_scan"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    for name, seg in system.backend.segments.items():
        if not seg.graphs.graphs:
            raise AssertionError(f"segment {name} never stepped through a CUDA graph")
    log(capture_line("captured run", system.backend, len(walls)))
    captured_launches = step_launches(system)
    captured_verdicts = verdicts(system)
    timing = {"sync": steady(system) + (captured_launches,)}
    del system

    # concurrent mode: each wave's replays go onto several streams at once
    conc_launches = None
    for workers in (None, 4):
        label = f"concurrent, max_workers={workers}"
        events = []
        reset_launch_counts()
        conc_digests, conc_walls, conc = run_script(MAIN_BATCH, dev, fuse=True, waves=events,
                                                    step_mode="concurrent", max_workers=workers)
        counts = launch_counts()
        if conc_digests != fused_digests:
            bad = [s for s in fused_digests if fused_digests[s] != conc_digests.get(s)]
            raise AssertionError(f"{label}: digests differ from the sync captured run's for {bad}")
        if verdicts(conc) != captured_verdicts:
            raise AssertionError(f"{label}: fusion verdicts {verdicts(conc)} differ")
        if counts != launches:
            raise AssertionError(f"{label}: kernel launches {counts} != sync {launches}")
        check_waves(label, events, len(conc_walls))
        for name, seg in conc.backend.segments.items():
            if not seg.graphs.graphs:
                raise AssertionError(f"{label}: segment {name} never stepped through a CUDA graph")
        sizes = [len(w) for w in conc.backend.segment_waves()]
        log(f"{label}: sink digests bitwise equal to the sync captured run's, kernel launches "
            f"equal ({counts}), on_wave covered every segment once in each of "
            f"{len(conc_walls)} steps; waves of {sizes} segments after the script; "
            f"step wall ms {[round(w, 3) for w in conc_walls]}")
        log(capture_line(label, conc.backend, len(conc_walls)))
        profiled = step_launches(conc)
        timing[label] = steady(conc) + (profiled,)
        conc.close()
        if workers is None:
            conc_launches = counts
        del conc
    for label, (walls_, makespans, (calls, graphs, on_card)) in timing.items():
        log(f"steady fused step, {label}: wall ms median {statistics.median(walls_):.3f} "
            f"(min {min(walls_):.3f}, max {max(walls_):.3f}) over {STEADY} steps, makespan_ms "
            f"median {statistics.median(makespans):.3f}; {calls} host launch calls ({graphs} "
            f"graph launches), {on_card} operations on the card a step")

    # the same script stepped eagerly (capture=False) on the same card
    reset_launch_counts()
    eager_digests, eager_walls, eager = run_script(MAIN_BATCH, dev, fuse=True, capture=False)
    eager_counts = launch_counts()
    if eager_digests != fused_digests:
        bad = [s for s in fused_digests if fused_digests[s] != eager_digests.get(s)]
        raise AssertionError(f"captured digests differ from the eager step's for {bad}")
    log("captured == eager (capture=False) sink digests (bitwise)")
    eager_verdicts = verdicts(eager)
    log(f"fusion verdicts (chain, accepted): captured {captured_verdicts}; eager "
        f"{'the same' if eager_verdicts == captured_verdicts else eager_verdicts}")
    if eager_counts == launches:
        log(f"kernel launches counted under capture (replays included) equal the eager run's: "
            f"{eager_counts}")
    elif eager_verdicts == captured_verdicts:
        raise AssertionError(f"kernel launches counted under capture {launches} != eager "
                             f"{eager_counts}")
    else:
        log(f"kernel launches differ with the fusion verdicts: eager {eager_counts}")
    eager_launches = step_launches(eager)
    del eager
    for label, (calls, graphs, on_card) in (("captured", captured_launches),
                                            ("eager", eager_launches)):
        log(f"launches per steady step, {label}: {calls} host launch calls ({graphs} graph "
            f"launches), {on_card} operations on the card")
    for sub, sinks in fused_digests.items():
        for sink, dg in sinks.items():
            if dg["count"] != 8:
                raise AssertionError(f"{sub}/{sink}: count {dg['count']} != 8")
            if not math.isfinite(dg["checksum"]):
                raise AssertionError(f"{sub}/{sink}: checksum {dg['checksum']}")
    log("sink counts exact (8 per live sink), checksums finite")

    unfused_digests, unfused_walls, _ = run_script(MAIN_BATCH, dev, fuse=False)
    if unfused_digests != fused_digests:
        bad = [s for s in fused_digests if fused_digests[s] != unfused_digests.get(s)]
        raise AssertionError(f"fused digests differ from unfused for {bad}")
    log("fused == unfused sink digests (bitwise)")

    cpu_digests, _, _ = run_script(CPU_BATCH, "cpu", fuse=True)
    gpu_digests, _, _ = run_script(CPU_BATCH, dev, fuse=True)
    worst = 0.0
    for sub, sinks in cpu_digests.items():
        for sink, dg in sinks.items():
            g = gpu_digests[sub][sink]
            if g["count"] != dg["count"]:
                raise AssertionError(f"{sub}/{sink}: card count {g['count']} != cpu {dg['count']}")
            rel = abs(g["checksum"] - dg["checksum"]) / max(1.0, abs(dg["checksum"]))
            worst = max(worst, rel)
    if worst > CPU_RTOL:
        raise AssertionError(f"card vs cpu checksum rel err {worst} > {CPU_RTOL}")
    log(f"base_batch={CPU_BATCH}: card and cpu sink counts equal, checksum rel err {worst:.3g} "
        f"(rtol {CPU_RTOL})")

    # steps 1-3 before fusion, 4-6 fused, 7-8 after the removals; step 1
    # includes first-launch costs (cuBLAS handle, allocator growth)
    log(f"step wall ms, fused run: {[round(w, 3) for w in walls]}")
    log(f"step wall ms, fused run, eager: {[round(w, 3) for w in eager_walls]}")
    log(f"step wall ms, unfused run: {[round(w, 3) for w in unfused_walls]}")
    log(f"median step wall ms at base_batch={MAIN_BATCH}: fused steps 4-8 "
        f"{statistics.median(walls[3:]):.3f}, eager {statistics.median(eager_walls[3:]):.3f}, "
        f"unfused steps 4-8 {statistics.median(unfused_walls[3:]):.3f}")
    phase3 = {
        "digests": fused_digests,
        "launches": dict(launches),
        "verdicts": captured_verdicts,
        "walls": {label: statistics.median(t[0]) for label, t in timing.items()},
    }
    return {name: n for name, n in launches.items()}, conc_launches, phase3


# -- phase 3b: the session, its checkpoints and the OPMW rw1 replay ------------------

RW1_SEED = 11  # rw1 as benchmarks/workload_traces.py and repro.launch.dryrun define it
RW1_PEAKS = (471, 277)  # peak submitted and running tasks of rw1 (the dry run's)


def session_digests(session):
    return {n: session.sink_digests(n) for n in session.names}


def session_head(session):
    """The session script up to its checkpoint: submit_many the RIoT and
    kernel flows, 3 steps, fuse(), 2 steps; returns the step walls."""
    from repro_torch.workloads import kernel_flows, riot_workload

    session.submit_many(riot_workload() + kernel_flows())
    walls = [r.wall_ms for r in session.run(3)]
    if not session.fuse():
        raise AssertionError("fuse() fused no segment chain")
    return walls + [r.wall_ms for r in session.run(2)]


def session_tail(session):
    """The script after its checkpoint: defragment(), 2 steps, remove three
    flows, 2 steps; returns (digests, step walls)."""
    session.defragment()
    walls = [r.wall_ms for r in session.run(2)]
    for name in REMOVED:
        session.remove(name)
    walls += [r.wall_ms for r in session.run(2)]
    return session_digests(session), walls


def compare_digests(label, got, want, rel):
    """Counts exact; checksums equal (``rel`` 0) or within ``rel``."""
    worst = 0.0
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: submissions {sorted(got)} != {sorted(want)}")
    for sub, sinks in want.items():
        for sink, dg in sinks.items():
            g = got[sub][sink]
            if g["count"] != dg["count"]:
                raise AssertionError(f"{label}: {sub}/{sink} count {g['count']} != {dg['count']}")
            if not math.isfinite(g["checksum"]):
                raise AssertionError(f"{label}: {sub}/{sink} checksum {g['checksum']}")
            if rel == 0 and g["checksum"] != dg["checksum"]:
                raise AssertionError(f"{label}: {sub}/{sink} checksum {g['checksum']!r} != "
                                     f"{dg['checksum']!r} (bitwise)")
            worst = max(worst, abs(g["checksum"] - dg["checksum"]) / max(1.0, abs(dg["checksum"])))
    if worst > rel:
        raise AssertionError(f"{label}: checksum rel err {worst} > {rel}")
    return worst


def rw1_replay(session, dags, events, trail):
    """One step after each event; appends each event's per-submission sink
    counts to ``trail`` and returns the peaks of submitted and running tasks."""
    from repro_torch.workloads import replay

    peaks = (0, 0)
    for _ev, _receipt in replay(session, dags, events):
        session.step()
        trail.append({n: {s: d["count"] for s, d in session.sink_digests(n).items()}
                      for n in session.names})
        peaks = (max(peaks[0], session.submitted_task_count),
                 max(peaks[1], session.running_task_count))
    return peaks


def session_phase(dev, card):
    """ReuseSession(execute=True, backend="torch") at base_batch=16384: the
    RIoT and kernel flows through fuse(), checkpoint(), defragment() and
    removals; a crash restored on the card (bitwise), checkpoints across
    devices at base_batch=1024, and the OPMW rw1 trace replayed with a
    restore at its middle event. Returns the launch counts of the session's
    uninterrupted run."""
    import shutil
    import tempfile

    import torch

    from repro_torch.api import ReuseSession
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.workloads import opmw_workload, rw_trace

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="session-", dir=root)
    try:
        fired = {"merge": 0, "defrag": 0, "step": 0}
        hooks = {f"on_{k}": (lambda ev, k=k: fired.__setitem__(k, fired[k] + 1)) for k in fired}
        ckpt_dir = os.path.join(tmp, "card")
        reset_launch_counts()
        backend = TorchBackend(dev)
        session = ReuseSession(execute=True, backend=backend, base_batch=MAIN_BATCH,
                               checkpoint_dir=ckpt_dir, **hooks)
        walls = session_head(session)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = session.checkpoint()
        write_ms = (time.perf_counter() - t0) * 1e3
        ckpt_bytes = os.path.getsize(path)
        digests, tail_walls = session_tail(session)
        torch.cuda.synchronize()
        launches = launch_counts()
        walls += tail_walls
        if not all(fired.values()):
            raise AssertionError(f"session hooks that never fired: {fired}")
        for name in ("rmsnorm", "map_chain", "affine_rmsnorm", "kalman_scan"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the session path")
        for sub, sinks in digests.items():
            for sink, dg in sinks.items():
                if dg["count"] != 9 or not math.isfinite(dg["checksum"]):
                    raise AssertionError(f"session {sub}/{sink}: {dg} (count 9 expected)")
        log(f"session: {len(session.names)} dataflows live, {session.stats().segments} segments "
            f"after defragment(), hooks fired {fired}; launches {launches}")
        log(f"session step wall ms at base_batch={MAIN_BATCH}: {[round(w, 3) for w in walls]}; "
            f"median {statistics.median(walls):.3f} ({card})")
        for name, seg in backend.segments.items():
            if not seg.graphs.graphs:
                raise AssertionError(f"session segment {name} never stepped through a CUDA graph")
        log(capture_line("session", backend, len(walls)))
        del session, backend

        t0 = time.perf_counter()
        restored = ReuseSession.restore(ckpt_dir, device=dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        log(f"checkpoint at step 5: {ckpt_bytes} bytes, written in {write_ms:.1f} ms, restored on "
            f"the card in {restore_ms:.1f} ms ({card})")
        compare_digests("restore on the card", session_tail(restored)[0], digests, 0)
        log("restore on the card: sink digests bitwise equal to the uninterrupted run's")

        # across devices at base_batch=1024: card -> cpu, then cpu -> card
        for src, dst in ((dev, "cpu"), ("cpu", dev)):
            src_dir = os.path.join(tmp, f"from-{torch.device(src).type}")
            first = ReuseSession(execute=True, backend="torch", base_batch=CPU_BATCH,
                                 device=src, checkpoint_dir=src_dir)
            session_head(first)
            first.checkpoint()
            want, _ = session_tail(first)
            got, _ = session_tail(ReuseSession.restore(src_dir, device=dst))
            worst = compare_digests(f"restore {torch.device(src).type} -> {torch.device(dst).type}",
                                    got, want, CPU_RTOL)
            log(f"base_batch={CPU_BATCH}: checkpoint taken on {torch.device(src).type} restored on "
                f"{torch.device(dst).type}: sink counts equal, checksum rel err {worst:.3g} "
                f"(rtol {CPU_RTOL})")

        # the OPMW rw1 trace, one step after each event, a restore at the middle
        dags = opmw_workload()
        events = rw_trace(dags, seed=RW1_SEED)
        mid = len(events) // 2
        dry_trail = []
        dry_peaks = rw1_replay(ReuseSession(execute=True, backend="dryrun"), dags, events,
                               dry_trail)
        rw_dir = os.path.join(tmp, "rw1")
        t0 = time.perf_counter()
        card_trail = []
        backends = [TorchBackend(dev), TorchBackend(dev)]
        rw = ReuseSession(execute=True, backend=backends[0], base_batch=MAIN_BATCH,
                          checkpoint_dir=rw_dir)
        head_peaks = rw1_replay(rw, dags, events[:mid], card_trail)
        rw.checkpoint()
        rw = ReuseSession.restore(rw_dir, backend=backends[1])
        tail_peaks = rw1_replay(rw, dags, events[mid:], card_trail)
        torch.cuda.synchronize()
        rw_s = time.perf_counter() - t0
        peaks = tuple(max(a, b) for a, b in zip(head_peaks, tail_peaks))
        if card_trail != dry_trail:
            bad = next(i for i, (a, b) in enumerate(zip(card_trail, dry_trail)) if a != b)
            raise AssertionError(f"rw1: sink counts after event {bad} differ from dryrun's")
        if peaks != dry_peaks or peaks != RW1_PEAKS:
            raise AssertionError(f"rw1 peaks {peaks}, dryrun {dry_peaks}, expected {RW1_PEAKS}")
        log(f"OPMW rw1 on the card at base_batch={MAIN_BATCH}: {len(events)} events and steps, "
            f"restored at event {mid}, {rw_s:.2f} s; per-submission sink counts equal dryrun's "
            f"after every event; peak submitted -> running tasks {peaks[0]} -> {peaks[1]} ({card})")
        log(capture_line(f"rw1 events 1-{mid}", backends[0], mid))
        log(capture_line(f"rw1 events {mid + 1}-{len(events)}, restored", backends[1],
                         len(events) - mid))
        del rw, backends

        conc_launches = concurrent_session(dev, card, tmp, ckpt_dir, digests, dags, events,
                                           dry_trail)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"session phase: {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches, conc_launches


SPAN_CATEGORIES = ("step", "segment", "control", "compile", "checkpoint")
PROMETHEUS_NAMES = ("repro_steps_total", "repro_segment_step_ms", "repro_reuse_tasks_saved",
                    "repro_reuse_tasks_reused_total", "repro_reuse_core_steps_avoided_total")


def concurrent_session(dev, card, tmp, sync_dir, digests, dags, events, dry_trail):
    """The session script in concurrent mode against the sync session's
    ``digests`` (bitwise), telemetry on over its tail, its checkpoint
    restored in sync mode and the sync one (in ``sync_dir``) in concurrent
    mode, and rw1 in concurrent mode against the dry run's ``dry_trail``.
    Returns the launch counts of the concurrent session's run."""
    import torch

    from repro_torch.api import ReuseSession
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.runtime.executor import TorchBackend

    conc_dir = os.path.join(tmp, "concurrent")
    reset_launch_counts()
    session = ReuseSession(execute=True, backend=TorchBackend(dev), base_batch=MAIN_BATCH,
                           checkpoint_dir=conc_dir, step_mode="concurrent")
    walls = session_head(session)
    session.configure_obs(trace=True)
    session.checkpoint()
    got, tail_walls = session_tail(session)
    torch.cuda.synchronize()
    launches = launch_counts()
    compare_digests("concurrent session", got, digests, 0)
    for name in ("rmsnorm", "map_chain", "affine_rmsnorm", "kalman_scan"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the concurrent session path")
    log(f"session, concurrent: sink digests bitwise equal to the sync session's; launches "
        f"{launches}; step wall ms {[round(w, 3) for w in walls + tail_walls]} ({card})")

    prom = session.prometheus_text()
    missing = [n for n in PROMETHEUS_NAMES if n not in prom]
    if missing:
        raise AssertionError(f"prometheus text lacks {missing}")
    path = os.path.join(tmp, "trace.json")
    n = session.export_chrome_trace(path)
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    by_cat = {}
    for e in spans:
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + 1
    if len(spans) != n or any(by_cat.get(c, 0) <= 0 for c in SPAN_CATEGORIES):
        raise AssertionError(f"chrome trace of {n} spans holds {len(spans)}, by category {by_cat}")
    log(f"telemetry over the concurrent session's tail: {n} spans by category "
        f"{dict(sorted(by_cat.items()))}; Prometheus text of {len(prom.splitlines())} lines holds "
        f"{', '.join(PROMETHEUS_NAMES)}; the Chrome trace loads with json")
    session.close()
    del session

    for label, src, mode in (("concurrent -> sync", conc_dir, "sync"),
                             ("sync -> concurrent", sync_dir, "concurrent")):
        restored = ReuseSession.restore(src, device=dev, step_mode=mode)
        compare_digests(f"checkpoint {label}", session_tail(restored)[0], digests, 0)
        restored.close()
        log(f"checkpoint taken in {label.split(' -> ')[0]} mode restored on the card in "
            f"{mode} mode: sink digests bitwise equal to the uninterrupted run's")

    t0 = time.perf_counter()
    trail = []
    rw = ReuseSession(execute=True, backend=TorchBackend(dev), base_batch=MAIN_BATCH,
                      step_mode="concurrent")
    peaks = rw1_replay(rw, dags, events, trail)
    torch.cuda.synchronize()
    rw_s = time.perf_counter() - t0
    if trail != dry_trail:
        bad = next(i for i, (a, b) in enumerate(zip(trail, dry_trail)) if a != b)
        raise AssertionError(f"rw1 concurrent: sink counts after event {bad} differ from dryrun's")
    if peaks != RW1_PEAKS:
        raise AssertionError(f"rw1 concurrent peaks {peaks}, expected {RW1_PEAKS}")
    log(f"OPMW rw1 on the card in concurrent mode at base_batch={MAIN_BATCH}: {len(events)} "
        f"events and steps, {rw_s:.2f} s; per-submission sink counts equal dryrun's after every "
        f"event ({card})")
    rw.close()
    return launches


# -- phase 3c: the worker-process plane ------------------------------------------------

# fuse() on the multiproc backend scores chains against its slots: a chain
# whose members sit on two workers is consolidated only if that stretches
# the modelled makespan by less than (members - 1) x overhead_ms. In process
# (one slot) every chain is accepted; phase 3c accepts every chain too
# (members migrate to one worker first), so both fuse the same segments.
ACCEPT_ALL = {"overhead_ms": 1e9}
WORKER_MODES = (("sync", 2, False), ("concurrent", 4, True))  # mode, workers, chain batching


def rpc_total(backend) -> int:
    """Coordinator-to-worker RPCs the backend completed so far (its counter,
    read without a scrape: a scrape itself sends RPCs)."""
    return int(sum(backend._m_rpcs._values.values()))


def worker_phase(dev, phase3):
    """Phase 3c: phase 3's script on backend="multiproc" over shm — 2 workers
    in sync mode (one RPC per segment), 4 in concurrent mode with chain
    batching (one step_chain RPC per worker per step) — with sink digests
    bitwise and kernel launches (summed over the workers) equal to phase 3's
    captured run; checkpoints across multiproc and torch on the card
    (bitwise); a worker killed between steps and recovered (counts and
    digests unchanged); a short run over tcp. Returns the launch counts of
    the two script runs."""
    import torch

    from repro_torch.runtime.system import StreamSystem
    from repro_torch.runtime.worker import MultiprocBackend

    t_phase = time.perf_counter()
    runs = {}
    systems = {}
    for mode, workers, chains in WORKER_MODES:
        label = f"workers, {mode}"
        backend = MultiprocBackend(workers=workers, transport="shm", chain_batching=chains,
                                   device=str(dev))
        t0 = time.perf_counter()
        digests, walls, system = run_script(MAIN_BATCH, dev, fuse=True, backend=backend,
                                            fuse_kw=ACCEPT_ALL, step_mode=mode,
                                            max_workers=workers)
        script_s = time.perf_counter() - t0
        counts = backend.launch_counts()
        runs[label] = counts
        compare_digests(f"{label} vs phase 3's captured run", digests, phase3["digests"], 0)
        if verdicts(system) != phase3["verdicts"]:
            raise AssertionError(f"{label}: fusion verdicts {verdicts(system)} != phase 3's")
        if counts != phase3["launches"]:
            raise AssertionError(f"{label}: kernel launches over the workers {counts} != phase "
                                 f"3's {phase3['launches']}")
        placed = {}
        for name, w in backend.device_of.items():
            placed.setdefault(w, []).append(name)
        log(f"{label} ({workers} workers over shm, chain batching {chains}): sink digests "
            f"bitwise equal to phase 3's captured run, fusion verdicts equal, kernel launches "
            f"summed over the workers equal ({counts}); segments per worker "
            f"{ {w: len(v) for w, v in sorted(placed.items())} }; script {script_s:.2f} s, "
            f"step wall ms {[round(w, 3) for w in walls]}")
        # steady steps: wall, bytes published and RPCs per step
        pub0, rpc0 = backend.transport.counters()["bytes_published"], rpc_total(backend)
        reports = system.run(STEADY)
        pub = (backend.transport.counters()["bytes_published"] - pub0) / STEADY
        rpcs = (rpc_total(backend) - rpc0) / STEADY
        walls_ = [r.wall_ms for r in reports]
        # each segment's ms as its worker measured it (fetch, step, copies
        # back, publish); their sum a step against the wall leaves the
        # coordinator's share (the RPCs, the scheduling)
        seg_sum = statistics.median(sum(r.segment_ms.values()) for r in reports)
        log(f"steady fused step, {label}: worker-measured segment ms summed over a step median "
            f"{seg_sum:.3f}, makespan_ms median "
            f"{statistics.median(r.makespan_ms for r in reports):.3f}")
        log(f"steady fused step, {label}: wall ms median {statistics.median(walls_):.3f} (min "
            f"{min(walls_):.3f}, max {max(walls_):.3f}) over {STEADY} steps; phase 3 in process: "
            + ", ".join(f"{k} {v:.3f}" for k, v in phase3["walls"].items())
            + f"; {pub / 2**20:.2f} MiB published over the transport a step, {rpcs:.1f} RPCs a "
            f"step; spawn to the end of the first step {backend.first_step_s:.2f} s")
        for w, mem in backend.worker_memory().items():
            ctx = mem["free_at_start"] - mem["free_after_first_step"]
            log(f"  worker {w}: memory_reserved {mem['reserved'] / 2**20:.1f} MiB (peak "
                f"{mem['max_reserved'] / 2**20:.1f}), {mem['graphs']} graphs, pools "
                f"{mem['graph_pool_bytes'] / 2**20:.1f} MiB; device free {mem['free_at_start'] / 2**30:.2f}"
                f" GiB at its start (its context made), {mem['free_after_first_step'] / 2**30:.2f} "
                f"GiB after its first step ({ctx / 2**20:.1f} MiB taken by then, every process "
                f"on the card counted)")
        systems[mode] = system

    # checkpoints across the planes, and a worker killed and recovered:
    # multiproc (sync) -> torch on the card -> multiproc, each leg stepped
    # beside the system it came from, digests bitwise equal
    src = systems["sync"]
    systems["concurrent"].close()
    payload = src.checkpoint_payload()
    on_torch = StreamSystem.from_payload(payload, backend="torch", device=dev)
    backend = src.backend
    backend.shadow_states = True  # post-step states ride each step reply
    src.step()
    victim = 0
    proc = backend._procs[victim]
    proc.terminate()
    proc.join(timeout=30)
    if proc.is_alive():
        raise AssertionError("the killed worker is still alive")
    record = backend.recover_worker(victim)
    src.step()
    on_torch.run(2)
    want = {n: on_torch.sink_digests(n) for n in sorted(on_torch.manager.submitted)}
    got = {n: src.sink_digests(n) for n in sorted(src.manager.submitted)}
    compare_digests("multiproc checkpoint restored on torch (card), 2 steps", want, got, 0)
    log(f"checkpoint taken on multiproc restored on torch on the card: 2 steps bitwise equal "
        f"to the multiproc system's; worker {victim} killed between those steps and recovered "
        f"in {record['ms']:.1f} ms ({len(record['segments'])} segments redeployed from their "
        f"post-step states), counts and checksums unchanged")
    health = src.worker_health()
    if health["respawns"] != 1 or health["generations"][victim] != 1:
        raise AssertionError(f"worker_health after the recovery: {health}")
    back = StreamSystem.from_payload(on_torch.checkpoint_payload(), backend="multiproc",
                                     workers=2, device=str(dev))
    back.run(2)
    on_torch.run(2)
    compare_digests("torch checkpoint restored on multiproc, 2 steps",
                    {n: back.sink_digests(n) for n in sorted(back.manager.submitted)},
                    {n: on_torch.sink_digests(n) for n in sorted(on_torch.manager.submitted)}, 0)
    log("checkpoint taken on torch (card) restored on multiproc: 2 steps bitwise equal to the "
        "torch system's")
    back.close()
    src.close()
    del on_torch

    # a short run over tcp: the kernel flows and three RIoT flows, 3 steps,
    # against the same on the torch backend
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.workloads import kernel_flows, riot_workload

    flows = riot_workload()[:3] + kernel_flows()
    out = {}
    for label, backend in (("tcp", MultiprocBackend(workers=2, transport="tcp",
                                                    device=str(dev))),
                           ("torch", TorchBackend(dev))):
        system = StreamSystem(backend=backend, base_batch=MAIN_BATCH)
        for df in flows:
            system.submit(df)
        system.run(3)
        out[label] = {df.name: system.sink_digests(df.name) for df in flows}
        if label == "tcp":
            tcp_bytes = backend.transport.counters()["bytes_published"]
        system.close()
    compare_digests("multiproc over tcp vs torch", out["tcp"], out["torch"], 0)
    log(f"multiproc over tcp (2 workers, {len(flows)} flows, 3 steps, "
        f"{tcp_bytes / 2**20:.1f} MiB published): sink digests bitwise equal to the torch "
        f"backend's")
    torch.cuda.synchronize()
    log(f"worker phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


# -- phase 3d: the in-process backend over the host transports, and sharded -------------


def mib_a_step(transport, steps, before):
    return (transport.counters()["bytes_published"] - before) / steps / 2**20


def transport_sharded_phase(dev, phase3):
    """Phase 3d: phase 3's script on ``backend="torch"`` over shm and tcp
    (each boundary batch across the host through pinned staging) and on
    ``backend="sharded"`` (every card, then two slots of cuda:0), in sync
    and concurrent mode: digests bitwise and kernel launches equal to phase
    3's captured run. Returns each run's launch counts."""
    import collections

    import torch

    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.runtime.executor import TorchBackend
    from repro_torch.runtime.sharded import ShardedBackend

    t_phase = time.perf_counter()
    runs = {}
    for transport in ("shm", "tcp"):
        label = f"torch over {transport}"
        reset_launch_counts()
        backend = TorchBackend(dev, transport=transport)
        digests, walls, system = run_script(MAIN_BATCH, dev, fuse=True, backend=backend)
        counts = launch_counts()
        runs[label] = counts
        compare_digests(f"{label} vs phase 3's captured run", digests, phase3["digests"], 0)
        if counts != phase3["launches"]:
            raise AssertionError(f"{label}: kernel launches {counts} != phase 3's")
        before = backend.transport.counters()["bytes_published"]
        walls_, _ = steady(system)
        log(f"{label}: sink digests bitwise equal to phase 3's captured run, kernel launches "
            f"equal; steady fused step wall ms median {statistics.median(walls_):.3f} (min "
            f"{min(walls_):.3f}, max {max(walls_):.3f}) over {STEADY} steps against phase 3's "
            f"inproc sync {phase3['walls']['sync']:.3f}; "
            f"{mib_a_step(backend.transport, STEADY, before):.2f} MiB published a step")
        system.close()
        del system, backend
    for devices in (None, [dev] * 2):
        for mode in ("sync", "concurrent"):
            label = f"sharded, devices={devices and [str(d) for d in devices]}, {mode}"
            reset_launch_counts()
            backend = ShardedBackend(devices=devices, step_mode=mode)
            # fuse() scores chains against the slots, as on a worker pool
            digests, walls, system = run_script(MAIN_BATCH, dev, fuse=True, backend=backend,
                                                fuse_kw=ACCEPT_ALL)
            counts = launch_counts()
            runs[label] = counts
            compare_digests(f"{label} vs phase 3's captured run", digests, phase3["digests"], 0)
            if verdicts(system) != phase3["verdicts"]:
                raise AssertionError(f"{label}: fusion verdicts {verdicts(system)} != phase 3's")
            if counts != phase3["launches"]:
                raise AssertionError(f"{label}: kernel launches {counts} != phase 3's")
            for name, seg in backend.segments.items():
                if not seg.graphs.graphs:
                    raise AssertionError(f"{label}: segment {name} never stepped through a graph")
            per_slot = collections.Counter(backend.device_of.values())
            log(f"{label}: device_count {torch.cuda.device_count()}, {len(backend.devices)} "
                f"slot(s) on {sorted({str(d) for d in backend.devices})}; sink digests bitwise "
                f"equal to phase 3's captured run, fusion verdicts and kernel launches equal "
                f"(fuse() accepting every chain); segments per slot "
                f"{dict(sorted(per_slot.items()))}; step wall ms {[round(w, 3) for w in walls]}")
            system.close()
            del system, backend
    torch.cuda.synchronize()
    log(f"transport and sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


# -- phase 3e: supervision and autoscaling of the worker pool ----------------------------

HEARTBEAT_S = 2.0  # the supervised pool's heartbeat; the in-step kill steps at once
INERT_SCALE = {"min_workers": 2, "max_workers": 3, "high_ms": 1e9, "low_ms": 1e-9,
               "patience": 1, "cooldown": 0}


def cluster_phase(dev, phase3):
    """Phase 3e: phase 3's script on two pools of 2 workers over shm in sync
    mode with the backend's default chain batching (a step_chain RPC a
    worker), one supervised (spill snapshots, heartbeats) with autoscale=
    armed, one not, stepped in turns; a worker killed between two steps (the next step's RPC fails
    and recovers it), another killed while idle (the heartbeat recovers
    it), the pool grown by one and shrunk back by the autoscaler, each
    followed by steps whose digests are bitwise the unsupervised pool's.
    Returns each pool's launch counts."""
    import signal

    import torch

    from repro_torch.cluster import AutoscalePolicy
    from repro_torch.cluster.events import HEARTBEAT_MISSED
    from repro_torch.runtime.worker import MultiprocBackend

    t_phase = time.perf_counter()
    pools = {}
    for label, supervise in (("unsupervised", False), ("supervised", True)):
        backend = MultiprocBackend(workers=2, transport="shm", device=str(dev))
        # autoscale= armed with thresholds no pressure reaches; they are
        # set from the measured pressure further down
        extra = {"supervise": {"heartbeat_interval": HEARTBEAT_S},
                 "autoscale": dict(INERT_SCALE)} if supervise else {}
        digests, walls, system = run_script(MAIN_BATCH, dev, fuse=True, backend=backend,
                                            fuse_kw=ACCEPT_ALL, step_mode="sync", **extra)
        compare_digests(f"cluster, {label} pool vs phase 3's captured run", digests,
                        phase3["digests"], 0)
        if backend.launch_counts() != phase3["launches"]:
            raise AssertionError(f"{label} pool: kernel launches {backend.launch_counts()}")
        if supervise and backend.snapshot_mode != "spill":
            raise AssertionError(f"supervised pool snapshots by {backend.snapshot_mode}")
        log(f"cluster, {label} pool (2 workers over shm, sync, chain batching {backend.chain_batching}"
            f"): sink digests bitwise equal to "
            f"phase 3's captured run, kernel launches equal; spawn to the end of the first step "
            f"{backend.first_step_s:.2f} s")
        pools[label] = system
    sup, plain = pools["supervised"], pools["unsupervised"]
    be = sup.backend

    def lockstep(label, steps=1):
        for system in (sup, plain):
            system.run(steps)
        compare_digests(f"cluster, {label}", {n: sup.sink_digests(n) for n in
                                              sorted(sup.manager.submitted)},
                        {n: plain.sink_digests(n) for n in sorted(plain.manager.submitted)}, 0)

    # the supervision overhead: both pools' steady steps, in turns
    walls = {"unsupervised": [], "supervised": []}
    for rnd in range(4):
        for label in (("unsupervised", "supervised") if rnd % 2 == 0
                      else ("supervised", "unsupervised")):
            torch.cuda.synchronize()
            walls[label] += [r.wall_ms for r in pools[label].run(STEADY // 4)]
    compare_digests("cluster, after the steady steps", {n: sup.sink_digests(n) for n in
                                                        sorted(sup.manager.submitted)},
                    {n: plain.sink_digests(n) for n in sorted(plain.manager.submitted)}, 0)
    # read before the kills: a killed worker's counts go with it
    runs = {f"cluster, {label}": pools[label].backend.launch_counts() for label in pools}
    health = sup.worker_health()
    scaler = sup._autoscaler
    pressure = scaler.pressure()
    if pressure <= 0:
        raise AssertionError(f"no pressure measured on the supervised pool: {pressure}")
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"cluster: steady fused step wall ms median supervised {med['supervised']:.3f} (min "
        f"{min(walls['supervised']):.3f}, max {max(walls['supervised']):.3f}), unsupervised "
        f"{med['unsupervised']:.3f} (min {min(walls['unsupervised']):.3f}, max "
        f"{max(walls['unsupervised']):.3f}), {STEADY} steps each in turns of {STEADY // 4}: "
        f"supervised / unsupervised {med['supervised'] / med['unsupervised']:.4f}; the workers' "
        f"spill ms a step {health['spill_ms_per_step']}, snapshot mode {health['snapshot_mode']}")

    # a worker killed between two steps: the next step's RPC to it fails
    # and the in-step path (_step_recover) respawns it and redeploys its
    # segments from its spill file; the re-dispatched step runs once
    n_events = len(be.worker_events)
    os.kill(be._procs[1].pid, signal.SIGKILL)
    lockstep("in-step recovery of worker 1, 1 step, bitwise the unsupervised pool")
    if len(be.respawns) != 1:
        raise AssertionError(f"in-step recovery: respawns {be.respawns}")
    kinds = [e.kind for e in be.worker_events[n_events:]]
    if HEARTBEAT_MISSED in kinds:
        raise AssertionError(f"the heartbeat, not the step, recovered worker 1: {kinds}")
    log(f"cluster: worker 1 SIGKILLed between two steps, recovered inside the next step in "
        f"{be.respawns[-1]['ms']:.1f} ms ({len(be.respawns[-1]['segments'])} segments "
        f"redeployed from spill); events {kinds}; digests bitwise the unsupervised pool's")
    lockstep("after the in-step recovery, 2 more steps", 2)

    # a worker killed while idle: the heartbeat finds it and recovers it
    n_events = len(be.worker_events)
    os.kill(be._procs[0].pid, signal.SIGKILL)
    t0 = time.perf_counter()
    while len(be.respawns) < 2:
        if time.perf_counter() - t0 > 300:
            raise AssertionError("the heartbeat never recovered the idle worker")
        time.sleep(0.05)
    kinds = [e.kind for e in be.worker_events[n_events:]]
    if HEARTBEAT_MISSED not in kinds:
        raise AssertionError(f"idle kill: events {kinds}")
    log(f"cluster: worker 0 SIGKILLed while idle, the heartbeat ({HEARTBEAT_S} s) recovered it "
        f"{time.perf_counter() - t0:.2f} s after the kill, the respawn {be.respawns[-1]['ms']:.1f} "
        f"ms; events {kinds}")
    lockstep("after the heartbeat's recovery, 2 steps, bitwise the unsupervised pool", 2)

    # the autoscaler (autoscale=, observing after every step), thresholds
    # set from the measured pressure: grow by one, then shrink back
    if scaler.actions:
        raise AssertionError(f"the inert autoscaler acted: {scaler.actions}")
    scaler.policy = AutoscalePolicy(**{**INERT_SCALE, "high_ms": pressure / 2,
                                       "low_ms": pressure / 4})
    n_events = len(be.worker_events)
    for _ in range(3):
        lockstep("autoscale grow")
        if be.n_workers == 3:
            break
    if be.n_workers != 3:
        raise AssertionError(f"the autoscaler did not grow the pool: {scaler.state()}")
    lockstep("grown pool, 2 steps", 2)
    grown_pressure = scaler.pressure()
    scaler.policy = AutoscalePolicy(**{**INERT_SCALE, "high_ms": grown_pressure * 100,
                                       "low_ms": grown_pressure * 10})
    lockstep("autoscale shrink")
    if be.n_workers != 2:
        raise AssertionError(f"the autoscaler did not shrink the pool: {scaler.state()}")
    lockstep("shrunk pool, 2 steps, bitwise the unsupervised pool", 2)
    if sup.worker_health()["autoscale"]["workers"] != 2:
        raise AssertionError(f"worker_health's autoscale section: {sup.worker_health()}")
    events = be.worker_events[n_events:]
    log(f"cluster: autoscaler at measured pressure {pressure:.3f} ms a worker grew the pool 2 -> "
        f"3 and shrank it 3 -> 2 (pressure then {grown_pressure:.3f}); events "
        + ", ".join(f"{e.kind} {e.ms:.1f} ms" if e.ms else e.kind for e in events)
        + f"; actions {[(a['from'], a['to']) for a in scaler.actions]}")
    for system in (sup, plain):
        system.close()
    if sup._supervisor.running:
        raise AssertionError("close() left the supervisor running")
    torch.cuda.synchronize()
    log(f"cluster phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


# -- phase 3f: the trace-replay CLI --------------------------------------------------------

TRACE_CUT = 40  # the event the interrupted rw1 run stops at


def run_cli(args, timeout=900):
    """``python -m <args>`` from this checkout; fails on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=root)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc


def trace_cli_phase(dev):
    """Phase 3f: ``python -m repro_torch.launch.dryrun`` in subprocesses on the
    card: riot/rw1 interrupted at TRACE_CUT and resumed with --restore gives
    the uninterrupted series; riot/seq on a supervised, autoscaled pool of 2
    workers with one killed at event 6 exits 0 with a respawn and the sink
    counts of the same events on the in-process backend."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="trace-", dir=root)
    series = ("live_tasks", "paused_tasks", "cores")
    cli = ("repro_torch.launch.dryrun", "--trace")
    try:
        rec = {}
        for name, extra in (
            ("full", []),
            ("part", ["--checkpoint-dir", os.path.join(tmp, "ckpt"), "--max-events",
                      str(TRACE_CUT)]),
            ("rest", ["--checkpoint-dir", os.path.join(tmp, "ckpt"), "--restore"]),
        ):
            path = os.path.join(tmp, f"{name}.json")
            t0 = time.perf_counter()
            backend = [] if name == "rest" else ["--backend", "torch"]
            run_cli([*cli, "riot/rw1", *backend, "--json", path, *extra])
            rec[name] = json.load(open(path))
            rec[name]["process_s"] = time.perf_counter() - t0
        if rec["rest"]["resumed_at_event"] != TRACE_CUT or rec["rest"]["backend"] != "torch":
            raise AssertionError(f"resume record {rec['rest']['resumed_at_event']}, "
                                 f"{rec['rest']['backend']}")
        stitched = {k: rec["part"]["series"][k] + rec["rest"]["series"][k] for k in series}
        if stitched != {k: rec["full"]["series"][k] for k in series}:
            raise AssertionError("riot/rw1: the stitched series differ from the uninterrupted run")
        log(f"trace CLI riot/rw1 on the card: {rec['full']['events']} events; cut at "
            f"{TRACE_CUT} and resumed with --restore, the stitched series equal the "
            f"uninterrupted run's; replay wall s full {rec['full']['wall_s']}, part "
            f"{rec['part']['wall_s']}, rest {rec['rest']['wall_s']} (processes "
            + ", ".join(f"{rec[k]['process_s']:.1f}" for k in ("full", "part", "rest")) + " s)")

        chaos = os.path.join(tmp, "chaos.json")
        calm = os.path.join(tmp, "calm.json")
        t0 = time.perf_counter()
        run_cli([*cli, "riot/seq", "--backend", "multiproc", "--workers", "2", "--supervise",
                 "--autoscale", "1:3", "--kill-worker-at", "6", "--max-events", "12",
                 "--json", chaos])
        chaos_s = time.perf_counter() - t0
        run_cli([*cli, "riot/seq", "--backend", "torch", "--max-events", "12", "--json", calm])
        got, want = json.load(open(chaos)), json.load(open(calm))
        health = got["worker_health"]
        if health["respawns"] < 1:
            raise AssertionError(f"riot/seq chaos run: no respawn in {health}")
        if got["sink_counts"] != want["sink_counts"] or not got["sink_counts"]:
            raise AssertionError("riot/seq chaos run: sink counts differ from the un-killed run")
        if {k: got["series"][k] for k in series} != {k: want["series"][k] for k in series}:
            raise AssertionError("riot/seq chaos run: series differ from the un-killed run")
        log(f"trace CLI riot/seq on a supervised pool (2 workers, autoscale 1:3), worker killed "
            f"after event 6: exit 0, {health['respawns']} respawn(s), "
            f"{sum(len(v) for v in got['sink_counts'].values())} sinks' counts equal to the "
            f"in-process run's; autoscale actions "
            f"{[(a['from'], a['to']) for a in health['autoscale']['actions']]}; events "
            f"{[e['kind'] for e in health['events']]}; {chaos_s:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"trace CLI phase: {time.perf_counter() - t_phase:.1f} s")


# -- phase 3g: the multi-tenant front end ----------------------------------------------------


def session_sinks(session, names):
    return {n: session.sink_digests(n) for n in names}


def frontend_phase(dev):
    """Phase 3g: ``ServeFrontend`` over ``ReuseSession(execute=True,
    backend="torch", base_batch=MAIN_BATCH)`` on the card: alice submits the
    21 RIoT flows, bob tenant copies of them (0 slots each); after steps the
    digests are bitwise those of a direct session with the same
    submissions; then over the socket (submit, status, stats, metrics, stop
    with a checkpoint) and ``ServeFrontend.restore`` on the card with equal
    ledgers; then the daemon in a subprocess. Returns the launch counts of
    the in-process runs."""
    import shutil
    import tempfile

    import torch

    from repro_torch.api import ReuseSession
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeClient, ServeFrontend, TenantQuota
    from repro_torch.workloads import riot_workload, tenant_copy

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="frontend-", dir=root)
    steps = 3
    try:
        flows = riot_workload()
        reset_launch_counts()
        fe = ServeFrontend(slots=256, backend="torch", base_batch=MAIN_BATCH,
                           default_quota=TenantQuota(max_slots=256),
                           checkpoint_dir=os.path.join(tmp, "ckpt"))
        submit_ms = {"alice": [], "bob": []}
        for tenant in ("alice", "bob"):
            for df in flows:
                sub = df.copy() if tenant == "alice" else tenant_copy(df, tenant)
                t0 = time.perf_counter()
                r = fe.submit(tenant, sub)
                submit_ms[tenant].append((time.perf_counter() - t0) * 1e3)
                if r.status != "ADMITTED":
                    raise AssertionError(f"{tenant} {sub.name}: {r.to_json()}")
                if tenant == "bob" and r.slots_charged != 0:
                    raise AssertionError(f"bob's {sub.name} charged {r.slots_charged} slots")
        torch.cuda.synchronize()
        step_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fe.step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        names = sorted(fe.session.manager.submitted)
        got = session_sinks(fe.session, names)
        direct = ReuseSession(execute=True, backend="torch", base_batch=MAIN_BATCH)
        for df in flows:
            direct.submit(df.copy())
        for df in flows:
            direct.submit(tenant_copy(df, "bob"))
        direct.run(steps)
        compare_digests("front end vs a direct session", got, session_sinks(direct, names), 0)
        direct.close()
        counts = launch_counts()
        stats = fe.stats()
        led = stats["ledgers"]
        log(f"front end on the card: alice's {len(flows)} RIoT flows held "
            f"{led['alice']['slots_held']} slots, bob's tenant copies 0 (slots saved "
            f"{led['bob']['slots_saved']}), effective capacity {stats['effective_capacity']:.2f}; "
            f"sink digests of {len(names)} dataflows after {steps} steps bitwise equal to a "
            f"direct session's; submit ms median alice {statistics.median(submit_ms['alice']):.3f}"
            f", bob {statistics.median(submit_ms['bob']):.3f}; step ms "
            f"{[round(w, 3) for w in step_ms]}")

        host, port = fe.start()
        with ServeClient((host, port)) as client:
            extra = tenant_copy(flows[0], "carol")
            r = client.submit("carol", extra)
            if r["status"] != "ADMITTED" or r["slots_charged"] != 0:
                raise AssertionError(f"carol over the socket: {r}")
            if client.status()["dataflows"] != len(names) + 1:
                raise AssertionError("status over the socket")
            wire_stats = client.stats()
            if "repro_serve" not in client.metrics()["text"]:
                raise AssertionError("metrics over the socket")
            client.step(1)
            before = client.stats()["ledgers"]
            digests = session_sinks(fe.session, sorted(fe.session.manager.submitted))
            out = client.shutdown(checkpoint=True)
        t0 = time.perf_counter()
        while fe._sock is not None and time.perf_counter() - t0 < 30:
            time.sleep(0.02)
        fe.close()
        if not out.get("ok"):
            raise AssertionError(f"shutdown over the socket: {out}")
        restored = ServeFrontend.restore(os.path.join(tmp, "ckpt"), slots=256,
                                         default_quota=TenantQuota(max_slots=256))
        if restored.stats()["ledgers"] != before:
            raise AssertionError("restored ledgers differ")
        compare_digests("front end restored on the card", session_sinks(
            restored.session, sorted(digests)), digests, 0)
        if restored.session.backend_name != "torch":
            raise AssertionError(f"restored on {restored.session.backend_name}")
        restored.close()
        log(f"front end over the socket: carol's copy admitted for 0 slots, status, stats "
            f"(effective capacity {wire_stats['effective_capacity']:.2f}), metrics, one step, "
            f"stop with a checkpoint; ServeFrontend.restore on the card: ledgers equal, sink "
            f"digests bitwise")

    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    daemon_check()
    torch.cuda.synchronize()
    log(f"front end phase: {time.perf_counter() - t_phase:.1f} s")
    return {"front end": counts}


def daemon_check():
    """``python -m repro_torch.launch.serve start --backend torch`` in a
    subprocess, driven by the submit, status and stop subcommands."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    errors = os.path.join(os.path.dirname(src), "build", "daemon.log")
    os.makedirs(os.path.dirname(errors), exist_ok=True)
    t0 = time.perf_counter()
    with open(errors, "w") as err:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "start", "--backend", "torch",
             "--port", str(port)], stdout=subprocess.PIPE, stderr=err, text=True, env=env,
            cwd=os.path.dirname(src))
    try:
        line = daemon.stdout.readline()
        if not line.startswith("serving on"):
            daemon.wait(timeout=60)
            raise AssertionError(f"daemon: {line!r} {open(errors).read()[-2000:]}")
        cli = ("repro_torch.launch.serve",)
        for tenant in ("alice", "bob"):
            run_cli([*cli, "submit", "--port", str(port), "--tenant", tenant, "--workload",
                     "riot", "--count", "5"])
        status = json.loads(run_cli([*cli, "status", "--port", str(port), "--stats"]).stdout)
        run_cli([*cli, "stop", "--port", str(port), "--no-checkpoint"])
        daemon.wait(timeout=60)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
    if daemon.returncode != 0 or status["backend"] != "torch":
        raise AssertionError(f"daemon exited {daemon.returncode}, status {status}")
    led = status["ledgers"]
    if not led["bob"]["slots_held"] < led["alice"]["slots_held"]:
        raise AssertionError(f"daemon ledgers {led}")
    log(f"daemon (python -m repro_torch.launch.serve start --backend torch): 5 RIoT flows "
        f"each from alice and bob, bob holding {led['bob']['slots_held']} slots against "
        f"alice's {led['alice']['slots_held']}; stopped cleanly, "
        f"{time.perf_counter() - t0:.1f} s")


# -- phase 4: the serving path at full width --------------------------------------

SERVE_ARCH = "qwen3-4b"
HYBRID_ARCH = "zamba2-2.7b"
MOE_ARCH = "mixtral-8x22b"
MLA_ARCH, VLM_ARCH, AUDIO_ARCH = "deepseek-v2-236b", "llama-3.2-vision-90b", "seamless-m4t-medium"
SSM_ARCH = "xlstm-1.3b"
MEMORY_SEED = 1  # the numpy seed of the vlm/audio memories and the vlm gates
ZERO_MEMORY_REL = 1e-2  # least max|diff|/max|logit| between a drawn and a zero memory
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 8, 16, 4, 4096
DENSE_KERNELS = ("rmsnorm", "rmsnorm_residual", "flash_attention", "decode_attention")
WITNESS_PROMPT, WITNESS_STEPS = 160, 3  # one full chunk of 128 and a ragged one of 32
# the serving phases: architecture, layers of its card-vs-CPU cut (zamba2's
# 6 are one group: six Mamba layers and one application of the shared
# block), the kernels its engine run must launch, the weight seeds of its
# bf16 checks (the first is the engine's), and the limits of those checks
# (max|diff| over the largest logit, cosine, same greedy token): at full
# depth, then at the cut's depth (see below)
SERVE_PHASES = (
    (SERVE_ARCH, 2, DENSE_KERNELS, (0,), (5e-2, 0.999, True), (2e-2, 0.9998, True), {}),
    (HYBRID_ARCH, 6, DENSE_KERNELS + ("ssd_scan",), (0, 1), (0.15, 0.995, False),
     (0.2, 0.97, False), {}),
    # mixtral-8x22b at full width cut to MOE_DEPTH of its 56 layers (about 5.0
    # GB of bf16 weights a layer: 8 layers and the embeddings are about 41
    # GB); its card-vs-CPU cut is one layer (10.8 GB of float32 weights on
    # each side), drawn on the card; the routing of every token is compared
    (MOE_ARCH, 1, DENSE_KERNELS, (0, 1), (5e-2, 0.999, True), (2e-2, 0.9998, True),
     dict(depth=8, f32_depth=4, cut_on_card=True, routes=True)),
    # 5d: deepseek-v2-236b (MLA, 160 experts top-6 and 2 shared) cut from 60
    # to 6 layers, first_k_dense 1 + 5 MoE (about 7.9 GB of bf16 weights a MoE
    # layer with its MLA: 42.5 GB with the embeddings); the f32 consistency
    # check at 2 layers and the card-vs-CPU cut at 2 (1 dense + 1 MoE, 21 GB
    # of float32 weights each side). No K6: MLA's decode is the reference's
    # absorbed form, matrix products over the latent cache, which the
    # reference leaves to XLA outside any Pallas kernel. The bf16 witness
    # runs the first layer alone (MLA and the dense FFN: every port kernel of
    # the path, no router): with top-6 of 160 experts a bf16 near-tie flips
    # a token's experts (10 of 323 tokens over 2 layers, each within twice
    # its card-vs-CPU probability difference), and through the capacity,
    # which drops by token order, other tokens' outputs with it (the 2-layer
    # reading was 0.077, cosine 0.9962; f32 at 2 layers chose the same
    # experts for every token)
    (MLA_ARCH, 2, DENSE_KERNELS[:3], (0, 1), (5e-2, 0.999, True), (2e-2, 0.9998, True),
     dict(depth=6, f32_depth=2, cut_on_card=True, routes=True, witness_layers=1)),
    # 5e: llama-3.2-vision-90b cut from 100 to 10 layers, 8 self + 2 gated
    # cross (about 1.71 GB a layer, 21.3 GB with the embeddings); f32
    # consistency at 5 (one group); the card-vs-CPU cut at 2 layers, one self
    # and one cross block (cross_attn_every 2)
    (VLM_ARCH, 2, DENSE_KERNELS, (0, 1), (5e-2, 0.999, True), (2e-2, 0.9998, True),
     dict(depth=10, f32_depth=5, cut_on_card=True, cut=dict(cross_attn_every=2))),
    # 5f: seamless-m4t-medium whole (12 encoder + 12 decoder layers, about 2.0
    # GB); LayerNorm, so no K1/K4 but the memory's k_input_norm; prompts up
    # to 1024; the card-vs-CPU cut at 2 + 2 layers; the CLI on the card
    (AUDIO_ARCH, 2, ("flash_attention", "decode_attention"), (0, 1), (5e-2, 0.999, True),
     (2e-2, 0.9998, True),
     dict(cut_on_card=True, cut=dict(n_encoder_layers=2), max_prompt=1024, cli=True)),
    # 5g: xlstm-1.3b whole (42 mLSTM + 6 sLSTM blocks, 3.6 B parameters: 7.2
    # GB in bf16, 14.4 GB in f32 for the consistency check at full depth);
    # K1 (the first norm, each mLSTM's out_norm and each sLSTM's group
    # norm), K4 at every seam, mlstm_scan and slstm_scan once per block and
    # prefill; the card-vs-CPU cut at 2 layers, one mLSTM and one sLSTM
    # block (slstm_every 2), at full width; the CLI on the card. The limits:
    # see the notes below
    (SSM_ARCH, 2, ("rmsnorm", "rmsnorm_residual", "mlstm_scan", "slstm_scan"), (0,),
     (0.25, 0.99, False), (2e-2, 0.9998, True),
     dict(cut_on_card=True, cut=dict(xlstm=dict(slstm_every=2)), f32_limits=(3e-4, 0.99999),
          cli=True)),
)
# The checks of each serving phase after its engine run:
#  * prefill/decode consistency at full width and depth: prefill(prompt)
#    against prefill(prompt[:-1]) + decode_step(prompt[-1]), on one prompt.
#    In float32 (the first seed) the two paths compute the same function
#    and differ only in the order of their sums (M = S against M = 1
#    matmuls, K5 against K6, and for zamba2 K7's chunked scan against the
#    one-step state update): held to 1e-4 of the largest logit, cosine >=
#    0.99999 and the same greedy token (observed 2.2e-6 for qwen3-4b,
#    1.2e-5 for zamba2-2.7b). In bf16, for each seed: each op rounds to
#    2**-9 relative, and the roundings compound through the residual
#    stream. qwen3-4b's two paths are held to 5e-2 of the largest logit,
#    cosine >= 0.999 and the same greedy token. zamba2's 54 + 9 blocks of
#    random weights drift much further from float32 in bf16, in the
#    reference as in the port (at d_model 256 and 54 layers on the CPU the
#    reference's bf16 forward is 0.26 of the largest logit from its f32
#    forward, cosine 0.974: tests/test_torch_models.py::
#    test_hybrid_bf16_drift_from_f32_is_the_references); its two bf16 paths
#    round alike but may swap near-equal top logits, and are held only
#    against gross faults: 0.15, cosine >= 0.995, no greedy token. Each
#    bf16 path's departure from the f32 prefill (whose weights the bf16 ones
#    round) is printed beside it.
#  * the card against the CPU at the cut's depth and full width, in float32
#    (PARITY_TOL; prefill and 4 decode steps at prompts of 64 and 256, the
#    same greedy tokens) and, for each seed, in bf16 (bf16_witness): every
#    kernel on the card against its plain version on the CPU, which rounds
#    to bf16 at the same places, too few blocks deep for the roundings to
#    compound. This is the check that tells a bf16-only fault of the served
#    path from rounding. Sound runs read at most 0.0093 (cosine 0.999945,
#    same greedy tokens) for qwen3-4b's 2 layers and 0.067 (cosine 0.9975)
#    for zamba2's 6, over four seeds; a planted fault (K7's bf16 build
#    leaving out y's C·h term) reads 0.62-0.93 (cosine 0.41-0.71) there.
#    Held to 2e-2 and cosine 0.9998 with the same greedy tokens for
#    qwen3-4b, and to 0.2 and cosine 0.97 for zamba2-2.7b, whose sound runs
#    may swap a near-equal top logit (one seed of four did). The readings:
#    scripts/torch_bf16_witness.py, on the tree and on a copy with the fault.
#  * mixtral-8x22b: the bf16 limits are qwen3-4b's (the same dense attention
#    blocks, 8 of them, an MoE FFN of two experts in place of the MLP); its
#    f32 consistency runs at f32_depth = 4 layers, since 8 layers of float32
#    weights (about 80 GB) do not fit the card beside anything else. The
#    routing is part of the result: on the card and on the CPU each token
#    must choose the same experts, except where its k-th and (k+1)-th router
#    probabilities are within ROUTE_GAP_F32 in float32; in bf16, where the
#    router's input differs between the devices by the roundings above, the
#    two probabilities may be no further apart than twice the token's largest
#    card-vs-CPU probability difference (the flip is then that difference's).
#    Every differing token is named.
#  * xlstm-1.3b: 48 blocks of random weights amplify a rounding far more
#    than the attention stacks do. On the CPU at d_model 256 and 512 (48
#    blocks, slstm_every 8, prompts of 209-274 tokens, seeds 0-2) the
#    float32 prefill/decode paths read 8e-6 to 6.9e-5 of the largest logit
#    (cosine >= 0.9999998, the same greedy token), the bf16 paths 0.034 to
#    0.10 (cosine >= 0.996, the same greedy token), and the bf16 prefill
#    sits 0.69 to 1.24 from the float32 one (cosine 0.47 to 0.74; zamba2's
#    is 0.26). So the float32 check is held at 3e-4 (cosine 0.99999, the
#    same greedy token), the bf16 one at 0.25 and cosine 0.99 against gross
#    faults. The two-block cut's bf16 witness, where nothing compounds, is
#    qwen3-4b's: 2e-2, cosine 0.9998, the same greedy tokens. Sound runs
#    read 0.0080-0.0086 (cosine >= 0.999949, the same tokens) over four
#    seeds; a planted fault (mlstm_scan leaving out y's carried C·q term)
#    0.36-0.50 (cosine 0.82-0.90): scripts/torch_bf16_witness.py --arch
#    xlstm-1.3b, on the tree and on a copy with the fault.
CONSISTENCY_F32, CONSISTENCY_F32_COS = 1e-4, 0.99999
ROUTE_GAP_F32 = 1e-6
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)  # card vs CPU in f32: 2560- and 151936-wide sums


def agree(a, b):
    """max|a - b| / max|a|, the least cosine over rows, and the argmaxes."""
    import torch

    rel = float((a - b).abs().max() / a.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
    return rel, cos, int(a.argmax()), int(b.argmax())


def bf16_witness(dev, cfg, params, prompt, memory=None):
    """A bf16 model on the card against the same weights on the CPU: the
    logits of ``forward`` at every position of ``prompt``, then prefill and
    WITNESS_STEPS decode steps fed the CPU's greedy token (vlm/audio: over
    ``memory``, (1, Sm, D) float32). Returns the worst max|diff| over the
    largest logit, the least cosine, and whether the greedy tokens of the
    prefill and decode steps agreed."""
    import torch

    from repro_torch.models import decode_step, forward, init_cache, prefill
    from repro_torch.models.transformer import tree_map

    ps = {"cpu": tree_map(lambda t: t.cpu(), params), dev: params}
    mem = {d: None if memory is None else memory.to(d) for d in ps}
    ml = 0 if memory is None else memory.shape[1]
    n = len(prompt)
    toks = torch.from_numpy(prompt).long()[None]
    worst_rel, worst_cos, _, _ = agree(
        forward(ps["cpu"], cfg, toks, memory=mem["cpu"])[0].float(),
        forward(params, cfg, toks.to(dev), memory=mem[dev])[0].float().cpu())
    caches = {d: init_cache(cfg, 1, n + WITNESS_STEPS + 1, memory_len=ml, device=d) for d in ps}
    logits = {d: prefill(ps[d], cfg, toks.to(d), caches[d], memory=mem[d])[0] for d in ps}
    same = True
    for i in range(WITNESS_STEPS + 1):
        rel, cos, am, bm = agree(logits["cpu"].float(), logits[dev].float().cpu())
        worst_rel, worst_cos, same = max(worst_rel, rel), min(worst_cos, cos), same and am == bm
        if i == WITNESS_STEPS:
            break
        tok = torch.tensor([[am]])
        logits = {d: decode_step(ps[d], cfg, tok.to(d), caches[d])[0] for d in ps}
    return worst_rel, worst_cos, same


def check_limits(reading, limits) -> bool:
    rel, cos, same = reading
    lim_rel, lim_cos, same_token = limits
    return rel <= lim_rel and cos >= lim_cos and (same or not same_token)


def limits_text(limits) -> str:
    lim_rel, lim_cos, same_token = limits
    return f"(limits {lim_rel}, cosine {lim_cos}{', same greedy token' if same_token else ''})"


class RouteLog:
    """Records, per device type, the router's probabilities and chosen
    experts at every moe_layer call while it is entered."""

    def __enter__(self):
        from repro_torch.models import mlp

        self._mlp, self._route, self.calls = mlp, mlp._route, {}

        def route(p, xt, k):
            out = self._route(p, xt, k)
            self.calls.setdefault(xt.device.type, []).append(
                (out[0].detach().float().cpu(), out[2].cpu()))
            return out

        mlp._route = route
        return self

    def __exit__(self, *exc):
        self._mlp._route = self._route


def check_routes(label, log, k, f32):
    """The card's expert choices against the CPU's, token by token, call by
    call (see the mixtral notes above); returns the number of tokens routed
    and the differing ones as (call, token, gap, largest probability
    difference)."""
    import torch

    cpu, card = log.calls.get("cpu", []), log.calls.get("cuda", [])
    if len(cpu) != len(card) or not cpu:
        raise AssertionError(f"{label}: {len(cpu)} router calls on the cpu, {len(card)} on the card")
    tokens, differ = 0, []
    for c, ((pc, ic), (pg, ig)) in enumerate(zip(cpu, card)):
        tokens += ic.shape[0]
        for t in torch.nonzero((ic.sort(-1).values != ig.sort(-1).values).any(-1)).flatten():
            t = int(t)
            top = torch.sort(pc[t], descending=True).values
            gap, dp = float(top[k - 1] - top[k]), float((pc[t] - pg[t]).abs().max())
            limit = ROUTE_GAP_F32 if f32 else max(ROUTE_GAP_F32, 2 * dp)
            if gap > limit:
                raise AssertionError(f"{label}: call {c} token {t} chose experts "
                                     f"{ig[t].tolist()} on the card, {ic[t].tolist()} on the "
                                     f"cpu; its k-th and (k+1)-th probabilities are {gap:.3g} "
                                     f"apart (limit {limit:.3g})")
            differ.append((c, t, gap, dp))
    return tokens, differ


def routes_text(tokens, differ) -> str:
    named = "; ".join(f"call {c} token {t}: gap {g:.3g}, largest probability difference {d:.3g}"
                      for c, t, g, d in differ)
    return f"experts chosen differ for {len(differ)} of {tokens} tokens" + (
        f" ({named})" if differ else "")


def memory_len(cfg) -> int:
    return {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(cfg.family, 0)


def draw_memory(cfg, rng):
    """A standard normal memory (1, Sm, D) float32 on the CPU for the vlm
    and audio families (image tokens, frames), None for the others."""
    import torch

    ml = memory_len(cfg)
    return torch.from_numpy(rng.standard_normal((1, ml, cfg.d_model)).astype("float32")) if ml else None


def open_gates(params, cfg):
    """A vlm model's gates, 0 at init (tanh(0)·y drops every cross-attention
    output, so a check with them would hold nothing of it), set to values in
    [0.5, 1) from numpy's generator at MEMORY_SEED: the same on every device
    and in every weight draw."""
    import numpy as np
    import torch

    if cfg.family != "vlm":
        return params
    gate = params["cross_blocks"]["attn"]["gate"]
    vals = np.random.default_rng(MEMORY_SEED).uniform(0.5, 1.0, gate.shape[0])
    gate.copy_(torch.from_numpy(vals).to(gate.dtype))
    return params


def no_drops(cfg):
    """``cfg`` with an MoE capacity that holds every token (capacity factor
    E / top_k): prefill of S tokens and prefill of S - 1 plus a decode step
    route the same tokens only when no expert is full, since capacity drops
    depend on how many tokens compete (in the reference too)."""
    if cfg.family != "moe":
        return cfg
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))


def with_cut(cfg, cut):
    """``cfg`` with the fields of ``cut`` replaced; a dict value replaces
    fields of that sub-configuration (``xlstm=dict(slstm_every=2)``)."""
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
                          else v for k, v in cut.items()})


def cut_words(cut) -> list:
    return [f"{kk} {vv}" for k, v in cut.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])]


def serve_phase(dev, arch, cut_layers, needed, seeds, bf16_limits, cut_limits, depth=None,
                f32_depth=None, cut_on_card=False, routes=False, cut=None,
                max_prompt=SERVE_PROMPT, cli=False, witness_layers=None,
                f32_limits=(CONSISTENCY_F32, CONSISTENCY_F32_COS)):
    """``arch`` at full width in bf16 through ServeEngine, at full depth or
    cut to ``depth`` layers (``f32_depth`` for the float32 consistency check,
    held to ``f32_limits``: max|diff| over the largest logit, cosine);
    the card-vs-CPU cut's weights drawn on the card when ``cut_on_card``,
    ``cut`` its other changes to the configuration (:func:`with_cut`; the
    bf16 witness at ``witness_layers`` when given); with ``routes`` the experts each token
    chose on the card and the CPU are compared. Prompts
    of 128 to ``max_prompt`` tokens; a vlm or audio request carries a memory
    drawn with numpy at MEMORY_SEED, a vlm model's gates are opened
    (open_gates), and a drawn memory must move the logits away from a zero
    one. With ``cli``, ``python -m repro_torch.launch.serve --arch`` runs on
    the card. Returns the launch counts of the engine run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, mlp, prefill
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = configs.get_config(arch)
    if depth:
        parts = ""
        if cfg.family == "moe" and cfg.moe.first_k_dense:
            parts = f" ({cfg.moe.first_k_dense} dense + {depth - cfg.moe.first_k_dense} MoE)"
        elif cfg.family == "vlm":
            n_cross = depth // cfg.cross_attn_every
            parts = f" ({depth - n_cross} self + {n_cross} gated cross)"
        log(f"{cfg.name}: depth cut from {cfg.n_layers} to {depth} layers{parts}, full width "
            f"(one card holds {depth} layers of bf16 weights beside the embeddings and caches)")
        cfg = cfg.replace(n_layers=depth)
    f32_depth = f32_depth or cfg.n_layers
    ml = memory_len(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = open_gates(init_params(cfg, torch.Generator(device=dev).manual_seed(0)), cfg)
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters drawn on the card in {time.perf_counter() - t0:.1f} s ({cfg.param_dtype})")

    rng = np.random.default_rng(0)
    mem_rng = np.random.default_rng(MEMORY_SEED)
    lens = rng.integers(128, max_prompt + 1, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    memories = [draw_memory(cfg, mem_rng) for _ in prompts]
    engine = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for rid, (prompt, mem) in enumerate(zip(prompts, memories)):
        engine.submit(Request(rid, prompt, max_new=SERVE_NEW,
                              memory=None if mem is None else mem[0].numpy()))
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if sorted(r.rid for r in results) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"served {sorted(r.rid for r in results)}")
    for r in results:
        if len(r.tokens) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: tokens {r.tokens}")
    for name in needed:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    if cfg.family == "hybrid" and launches["ssd_scan"] != K7_LAUNCHES * cfg.n_layers * SERVE_REQUESTS:
        raise AssertionError(f"ssd_scan launched {launches['ssd_scan']} kernels for "
                             f"{SERVE_REQUESTS} prefills of {cfg.n_layers} Mamba layers")
    if cfg.family == "ssm":  # one launch per block and prefill, none in decode
        from repro_torch.models.transformer import ssm_counts

        for name, blocks in zip(("mlstm_scan", "slstm_scan"), ssm_counts(cfg)):
            if launches[name] != blocks * SERVE_REQUESTS:
                raise AssertionError(f"{name} launched {launches[name]} times for "
                                     f"{SERVE_REQUESTS} prefills of {blocks} blocks")
    log(f"served {len(results)} requests x {SERVE_NEW} tokens, prompts {sorted(lens.tolist())}"
        + (f", each with a memory of {ml} positions" if ml else "")
        + f", slots {SERVE_SLOTS}, max_len {SERVE_MAX_LEN}: {wall:.2f} s, "
        f"{SERVE_REQUESTS * SERVE_NEW / wall:.1f} generated tokens/s; launches {launches}")
    log(f"first tokens: {[r.tokens[:4] for r in sorted(results, key=lambda r: r.rid)]}")
    del engine

    # prefill ms per prompt length and decode ms per token at batch 1
    mem = None if memories[0] is None else memories[0].to(dev)
    cache = init_cache(cfg, 1, SERVE_MAX_LEN, memory_len=ml, device=dev)
    for n in (128, 512, 1024, SERVE_PROMPT):
        if n > max_prompt:
            continue
        toks = torch.from_numpy(prompts[0][:1].repeat(n)).long()[None].to(dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, cfg, toks, cache, memory=mem)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"prefill {n} tokens: {statistics.median(times):.2f} ms (median of 3; {times})")
    if cfg.family == "moe":
        dropped = []
        dispatch = mlp.dispatch

        def counted(c, idx):
            slot, keep = dispatch(c, idx)
            dropped.append(int((~keep).sum()))
            return slot, keep

        mlp.dispatch = counted
        try:
            toks = torch.from_numpy(prompts[-1]).long()[None].to(dev)
            prefill(params, cfg, toks, cache)
        finally:
            mlp.dispatch = dispatch
        log(f"tokens dropped by capacity at the prefill of a {toks.shape[1]}-token prompt "
            f"(C = {mlp.capacity(cfg, toks.shape[1])} slots an expert): {sum(dropped)} of "
            f"{toks.shape[1] * cfg.moe.top_k * len(dropped)} (token, expert) choices, per MoE "
            f"layer {dropped}")
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    times = []
    reset_launch_counts()
    for _ in range(SERVE_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_token = {k: v / SERVE_NEW for k, v in launch_counts().items() if v}
    host_calls, _, on_card = fn_launches(lambda: decode_step(params, cfg, tok, cache))
    log(f"decode at {cache['len'] - SERVE_NEW - 1}+ cached positions, batch 1: "
        f"{statistics.median(times):.2f} ms/token (median of {len(times)}); per decoded token "
        f"{host_calls} host launch calls, {on_card} operations on the card, port kernels "
        f"{per_token}")

    # prefill/decode consistency on one prompt, in bf16 and in float32
    prompt = torch.from_numpy(prompts[0]).long()[None].to(dev)

    def both_paths(p, c):
        c = no_drops(c)
        full, _ = prefill(p, c, prompt, init_cache(c, 1, SERVE_MAX_LEN, memory_len=ml, device=dev),
                          memory=mem)
        cache = init_cache(c, 1, SERVE_MAX_LEN, memory_len=ml, device=dev)
        prefill(p, c, prompt[:, :-1], cache, memory=mem)
        step, _ = decode_step(p, c, prompt[:, -1:], cache)
        return full.float(), step.float()

    bf16 = {seeds[0]: both_paths(params, cfg)}
    if ml:  # the memory reaches the logits: against a zero memory of the same shape
        zero, _ = prefill(params, cfg, prompt, init_cache(cfg, 1, SERVE_MAX_LEN, memory_len=ml,
                                                          device=dev), memory=torch.zeros_like(mem))
        rel = agree(bf16[seeds[0]][0], zero.float())[0]
        log(f"{cfg.name}: the drawn memory against a zero one moves the last logits by "
            f"max|diff|/max|logit| {rel:.3g} (least {ZERO_MEMORY_REL}"
            + (", gates opened to tanh(g), g in [0.5, 1)" if cfg.family == "vlm" else "") + ")")
        if rel < ZERO_MEMORY_REL:
            raise AssertionError(f"{cfg.name}: the memory does not reach the logits")
        del zero
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory (max_memory_allocated): {peak:.2f} GiB")
    embed_rows = params["embed"][:8].clone()
    del params, cache
    for seed in seeds[1:]:
        params = open_gates(init_params(cfg, torch.Generator(device=dev).manual_seed(seed)), cfg)
        bf16[seed] = both_paths(params, cfg)
        del params
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32", n_layers=f32_depth)
    params32 = open_gates(init_params(cfg32, torch.Generator(device=dev).manual_seed(seeds[0])),
                          cfg32)
    if not torch.equal(params32["embed"][:8].to(embed_rows.dtype), embed_rows):
        raise AssertionError("the bf16 weights are not the float32 ones rounded")
    f32 = both_paths(params32, cfg32)
    del params32
    torch.cuda.empty_cache()

    n = prompt.shape[1]
    rel, cos, am, bm = agree(*f32)
    log(f"prefill/decode consistency, f32 ({f32_depth} layers), seed {seeds[0]} ({n} tokens): "
        f"max|diff|/max|logit| "
        f"{rel:.3g} (limit {f32_limits[0]}), cosine {cos:.7f} (limit {f32_limits[1]}), "
        f"argmax {am} vs {bm}")
    if rel > f32_limits[0] or cos < f32_limits[1] or am != bm:
        raise AssertionError("prefill and decode_step disagree on the last token in f32")
    for seed in seeds:
        rel, cos, am, bm = agree(*bf16[seed])
        drift = ""
        if seed == seeds[0] and f32_depth == cfg.n_layers:
            d = [agree(f32[0], x)[:2] for x in bf16[seed]]
            drift = (f"; from the f32 prefill: prefill {d[0][0]:.3g} (cosine {d[0][1]:.6f}), "
                     f"prefill + decode {d[1][0]:.3g} (cosine {d[1][1]:.6f})")
        log(f"prefill/decode consistency, bf16, seed {seed} ({n} tokens): max|diff|/max|logit| "
            f"{rel:.3g}, cosine {cos:.6f}, argmax {am} vs {bm} {limits_text(bf16_limits)}{drift}")
        if not check_limits((rel, cos, am == bm), bf16_limits):
            raise AssertionError(f"prefill and decode_step disagree on the last token in bf16, "
                                 f"seed {seed}")

    # card against CPU: the same configuration cut to a few layers, float32
    cut = cut or {}
    cut32 = with_cut(cfg.replace(n_layers=cut_layers, dtype="float32", param_dtype="float32"), cut)
    cut_text = ", ".join([f"{cut_layers} layers"] + cut_words(cut))
    t0 = time.perf_counter()
    if cut_on_card:
        dev_params = open_gates(init_params(cut32, torch.Generator(device=dev).manual_seed(0)), cut32)
        cpu_params = tree_map(lambda t: t.cpu(), dev_params)
    else:
        cpu_params = init_params(cut32, torch.Generator().manual_seed(0))
        dev_params = tree_map(lambda t: t.to(dev), cpu_params)
    log(f"{cut32.name} cut to {cut_text}, float32: parameters drawn on the "
        f"{'card' if cut_on_card else 'CPU'} in {time.perf_counter() - t0:.1f} s")
    cut_mem = draw_memory(cut32, mem_rng)
    route_log = RouteLog() if routes else contextlib.nullcontext()
    with route_log:
        worst = cut_parity(dev, cfg, cut32, cpu_params, dev_params, rng, cut_mem)
    log(f"{cfg.name} card vs cpu ({cut_text}, f32, prompts 64 and 256, prefill + 4 "
        f"decode steps): max|err| {worst:.3g} (tol {PARITY_TOL}), greedy tokens equal"
        + (f"; {routes_text(*check_routes('f32 card vs cpu', route_log, cfg.moe.top_k, True))}"
           if routes else ""))
    del cpu_params, dev_params
    cut16 = with_cut(cfg.replace(n_layers=witness_layers or cut_layers), cut)
    if witness_layers:
        cut_text = ", ".join([f"{witness_layers} layers"] + cut_words(cut))
    routes = routes and cut16.n_layers > cut16.moe.first_k_dense  # a router in the witness
    for seed in seeds:
        params = open_gates(init_params(cut16, torch.Generator(device=dev).manual_seed(seed)), cut16)
        route_log = RouteLog() if routes else contextlib.nullcontext()
        with route_log:
            reading = bf16_witness(dev, cut16, params, prompts[0][:WITNESS_PROMPT], cut_mem)
        del params
        log(f"{cfg.name} card vs cpu ({cut_text}, bf16, seed {seed}; forward at "
            f"{WITNESS_PROMPT} positions, prefill + {WITNESS_STEPS} decode steps): max|diff|/"
            f"max|logit| {reading[0]:.3g}, cosine {reading[1]:.6f}, greedy tokens "
            f"{'equal' if reading[2] else 'differ'} {limits_text(cut_limits)}"
            + (f"; {routes_text(*check_routes(f'bf16 card vs cpu, seed {seed}', route_log, cfg.moe.top_k, False))}"
               if routes else ""))
        if not check_limits(reading, cut_limits):
            raise AssertionError(f"bf16 on the card departs from bf16 on the cpu, seed {seed}")
    if cli:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = run_cli(["repro_torch.launch.serve", "--arch", arch], timeout=600)
        lines = proc.stdout.splitlines()
        if not lines or lines[-1] != f"served {SERVE_REQUESTS} requests":
            raise AssertionError(f"python -m repro_torch.launch.serve --arch {arch} printed {lines}")
        log(f"python -m repro_torch.launch.serve --arch {arch} on the card: {lines[-1]!r} "
            f"({lines[0]!r} first), {time.perf_counter() - t0:.1f} s")
    log(f"{cfg.name} serving phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def cut_parity(dev, cfg, cut, cpu_params, dev_params, rng, memory=None):
    """The cut on the card against the CPU in float32: prefill of 64 and 256
    tokens (over ``memory`` for vlm/audio), then 4 decode steps fed the
    CPU's greedy token; the worst max|err|."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill

    worst = 0.0
    ml = 0 if memory is None else memory.shape[1]
    for n in (64, 256):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=n)).long()[None]
        caches = {d: init_cache(cut, 1, n + 8, memory_len=ml, device=d) for d in ("cpu", dev)}
        ps = {"cpu": cpu_params, dev: dev_params}
        mem = {d: None if memory is None else memory.to(d) for d in caches}
        logits = {d: prefill(ps[d], cut, toks.to(d), caches[d], memory=mem[d])[0] for d in caches}
        for i in range(5):
            got, want = logits[dev].cpu(), logits["cpu"]
            worst = max(worst, check_close(f"card vs cpu, prompt {n}, step {i}", got, want,
                                           PARITY_TOL))
            nxt = {d: int(logits[d].argmax()) for d in logits}
            if nxt[dev] != nxt["cpu"]:
                raise AssertionError(f"prompt {n}, step {i}: greedy {nxt[dev]} on the card, "
                                     f"{nxt['cpu']} on the cpu")
            if i == 4:
                break
            tok = torch.tensor([[nxt["cpu"]]])
            logits = {d: decode_step(ps[d], cut, tok.to(d), caches[d])[0] for d in caches}
    return worst


# -- phase 5c: LM reuse-serving at full width -------------------------------------------

# ReuseServing at qwen3-4b's width: 6 tenants over urban/meter/taxi as
# serve_reuse makes them, 4 stages of 9 blocks (36 blocks, qwen3-4b's depth)
# of which the lower 3 are the shared backbone
REUSE_D, REUSE_BATCH, REUSE_TENANTS = 2560, 256, 6
REUSE_STAGES, REUSE_SHARED, REUSE_BLOCKS = 4, 3, 9
REUSE_STEPS, REUSE_AFTER = 5, 3  # steps before and after tenant1 is removed
# the reference's --reuse line (python -m repro.launch.serve --reuse on the CPU)
REUSE_CLI_LINE = "tenants=6 running_tasks=33 deployed_cost=65.7"


def reuse_pipes(d=REUSE_D, n_stages=REUSE_STAGES, blocks=REUSE_BLOCKS, tenants=REUSE_TENANTS):
    from repro_torch.serve import TenantPipeline

    return [TenantPipeline(tenant=f"tenant{i}", stream=("urban", "meter", "taxi")[i % 3],
                           shared_stages=min(REUSE_SHARED, n_stages), n_stages=n_stages, d=d,
                           layers_per_stage=blocks) for i in range(tenants)]


def weight_bytes(dataflows) -> int:
    """float32 weight bytes of the lm_* tasks of ``dataflows``: a block is
    w1 (d, 2d) and w2 (2d, d), 16·d² bytes; the embed 8·d, the head d² + 8·d
    values."""
    total = 0
    for df in dataflows:
        for t in df.tasks.values():
            cfg = json.loads(t.config) if t.config.startswith("{") else {}
            d = int(cfg.get("d", 0))
            if t.type == "lm_stage":
                lo, hi = (int(v) for v in cfg["layers"].split("-"))
                total += (hi - lo + 1) * 16 * d * d
            elif t.type == "lm_embed":
                total += 8 * d * 4
            elif t.type == "lm_head":
                total += (d * d + 8 * d) * 4
    return total


def busy_ms(fn):
    """One call of ``fn`` under torch.profiler: the union of the card's
    operation intervals in ms, and the call's wall ms (profiled)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if "CUDA" in str(ev.device_type) and not ev.name.startswith("op::"))
    union_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            union_us += end - max(start, reach)
            reach = end
    return union_us / 1e3, wall


def sink_last(rs, receipt):
    """The last batch a tenant's sink took (its state), on the CPU."""
    (tid,) = receipt.sink_map.values()
    for seg in rs.system.backend.segments.values():
        if tid in seg.states:
            return seg.states[tid]["last"].cpu()
    raise KeyError(tid)


def reuse_run(dev, strategy, pipes, steps=REUSE_STEPS, after=REUSE_AFTER, profile_step=True):
    """ReuseServing on ``dev``: the pipelines added, ``steps`` steps (the
    last under the profiler when ``profile_step``), tenant1 removed when
    ``after`` steps follow; returns what it observed."""
    import torch

    from repro_torch.serve import ReuseServing

    rs = ReuseServing(strategy=strategy, base_batch=REUSE_BATCH, device=dev)
    t0 = time.perf_counter()
    receipts = [rs.add_tenant(p) for p in pipes]
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    sync()
    on_card = torch.device(dev).type == "cuda"
    out = {"deploy_s": time.perf_counter() - t0, "walls": [], "busy": None,
           "allocated": torch.cuda.memory_allocated(dev) if on_card else 0}
    out["stats"] = rs.stats()
    out["weights"] = weight_bytes(rs.system.manager.running.values())
    for i in range(steps):
        if profile_step and i == steps - 1:
            out["busy"], wall = busy_ms(rs.step)
        else:
            t0 = time.perf_counter()
            rs.step()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        out["walls"].append(wall)
    out["before"] = {t: rs.tenant_output(t) for t in sorted(rs.tenants)}
    out["last"] = sink_last(rs, receipts[0])
    if not after:
        rs.system.close()
        return out
    rs.remove_tenant("tenant1")
    out["stats_after"] = rs.stats()
    for _ in range(after):
        t0 = time.perf_counter()
        rs.step()
        sync()
        out["walls"].append((time.perf_counter() - t0) * 1e3)
    out["after"] = {t: rs.tenant_output(t) for t in sorted(rs.tenants)}
    backend = rs.system.backend
    out["graphs"] = getattr(backend, "capture_stats", None)
    rs.system.close()
    return out


def reuse_serving_phase(dev):
    """LM reuse-serving on the card at full width (REUSE_D = qwen3-4b's
    d_model; REUSE_STAGES stages of REUSE_BLOCKS blocks, 36 in all, the lower
    REUSE_SHARED shared), REUSE_TENANTS tenants at base_batch REUSE_BATCH:
    REUSE_STEPS steps, tenant1 removed, REUSE_AFTER steps, with the launch
    counts reset just before and read just after. The same run with
    strategy="none" (every tenant its own copy) gives each tenant bitwise
    the same sink digests; one tenant cut to 1 stage of 2 blocks at the same
    width and batch on the card against the CPU within PARITY_TOL; the
    --reuse CLI on the card prints the reference's line. Returns the launch
    counts of the signature run."""
    import gc

    import torch

    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_launch_counts()
    run = reuse_run(dev, "signature", reuse_pipes())
    counts = launch_counts()
    if counts["rmsnorm"] <= 0 or counts["rmsnorm_residual"] <= 0:
        raise AssertionError(f"reuse-serving launched no K1/K4: {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    nope = reuse_run(dev, "none", reuse_pipes())
    st, st_none = run["stats"], nope["stats"]
    log(f"reuse-serving at d_model {REUSE_D}, {REUSE_STAGES} stages x {REUSE_BLOCKS} blocks "
        f"({REUSE_SHARED} shared), {REUSE_TENANTS} tenants, base_batch {REUSE_BATCH}: "
        f"{st['running_tasks']} running tasks ({st_none['running_tasks']} without reuse), "
        f"{st['deployed_tasks']} deployed, deployed_cost {st['deployed_cost']:.1f} "
        f"({st_none['deployed_cost']:.1f} without reuse); after removing tenant1 "
        f"{run['stats_after']['running_tasks']} running, deployed_cost "
        f"{run['stats_after']['deployed_cost']:.1f}")
    log(f"reuse-serving weights deployed: {run['weights'] / 1e9:.3f} GB of float32 blocks "
        f"against {nope['weights'] / 1e9:.3f} GB without reuse "
        f"({run['weights'] / nope['weights']:.4f}); memory_allocated after the deploys "
        f"{run['allocated'] / 2**30:.2f} GiB against {nope['allocated'] / 2**30:.2f} GiB; "
        f"deployed in {run['deploy_s']:.1f} s and {nope['deploy_s']:.1f} s")
    for label, r in (("signature", run), ("none", nope)):
        w = r["walls"]
        log(f"reuse-serving step wall ms, {label}: {', '.join(f'{x:.3f}' for x in w)} (steps 1-2 "
            f"eager and capture, {REUSE_STEPS} profiled, tenant1 removed before step "
            f"{REUSE_STEPS + 1}); steady median {statistics.median(w[2:REUSE_STEPS - 1]):.3f}; "
            f"the card busy {r['busy']:.3f} ms of the profiled step's {w[REUSE_STEPS - 1]:.3f}")
    log(f"reuse-serving kernel launches (signature run): {counts}")
    for key in ("before", "after"):
        if run[key] != nope[key]:
            raise AssertionError(f"reuse-serving: strategy signature and none differ ({key} the "
                                 f"removal): {run[key]} vs {nope[key]}")
    for t, sinks in run["after"].items():
        n = sinks[f"{t}/sink"]["count"] - run["before"][t][f"{t}/sink"]["count"]
        if n != REUSE_AFTER:
            raise AssertionError(f"reuse-serving: {t} answered {n} batches across the removal")
    log(f"reuse-serving: strategy signature == none sink digests (bitwise) for all "
        f"{REUSE_TENANTS} tenants before the removal and the {REUSE_TENANTS - 1} after it; "
        f"the survivors' counts grew by {REUSE_AFTER}")
    del run, nope
    gc.collect()
    torch.cuda.empty_cache()

    # the card against the CPU: one tenant, one stage of 2 blocks, full width
    one = reuse_pipes(n_stages=1, blocks=2, tenants=1)
    t0 = time.perf_counter()
    outs = {d: reuse_run(d, "signature", one, steps=3, after=0, profile_step=False)
            for d in (dev, "cpu")}
    sink = outs["cpu"]["before"]["tenant0"]["tenant0/sink"]
    got = outs[dev]["before"]["tenant0"]["tenant0/sink"]
    err = check_close("reuse-serving card vs cpu, the sink's last batch", outs[dev]["last"],
                      outs["cpu"]["last"], PARITY_TOL)
    if got["count"] != sink["count"] or not math.isclose(
            got["checksum"], sink["checksum"], rel_tol=PARITY_TOL["rtol"],
            abs_tol=PARITY_TOL["atol"]):
        raise AssertionError(f"reuse-serving card vs cpu: {got} vs {sink} (tol {PARITY_TOL})")
    log(f"reuse-serving card vs cpu (1 tenant, 1 stage of 2 blocks, d_model {REUSE_D}, batch "
        f"{REUSE_BATCH}, 3 steps): counts {got['count']} equal, the last batch's max|err| "
        f"{err:.3g}, checksum {got['checksum']:.6f} vs {sink['checksum']:.6f} (tol "
        f"{PARITY_TOL}); {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    proc = run_cli(["repro_torch.launch.serve", "--reuse"], timeout=300)
    lines = proc.stdout.splitlines()
    if not lines or lines[0] != REUSE_CLI_LINE or len(lines) != REUSE_TENANTS + 1:
        raise AssertionError(f"python -m repro_torch.launch.serve --reuse printed {lines}")
    log(f"python -m repro_torch.launch.serve --reuse on the card: {lines[0]!r} (the reference's "
        f"line), {len(lines) - 1} tenants' digests, {time.perf_counter() - t0:.1f} s")
    log(f"reuse-serving phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


# nemotron-4-340b cut in width and depth for the card-vs-CPU check: its head
# dim of 192 and 12 q heads per KV head kept (d_model 2304 = 12 x 192 over
# one KV head), 2 layers, d_ff 4 x d_model as configured, a 4096-token
# vocabulary; layernorm and squared ReLU (plain torch in the port, as in
# the reference) as configured
NEMOTRON_CUT = dict(n_layers=2, d_model=2304, n_heads=12, n_kv_heads=1, d_ff=9216,
                    vocab_size=4096, dtype="float32", param_dtype="float32")


def nemotron_cut_phase(dev):
    """The nemotron cut on the card against the CPU in f32 (PARITY_TOL):
    prefill of 64 and 256 tokens into a cache two slots longer, then 4
    decode steps, the last two past the cache's last slot (written there,
    as the reference's clamped write); the same greedy tokens."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map

    cut = configs.get_config("nemotron-4-340b").replace(**NEMOTRON_CUT)
    cpu_params = init_params(cut, torch.Generator().manual_seed(0))
    ps = {"cpu": cpu_params, dev: tree_map(lambda t: t.to(dev), cpu_params)}
    rng = torch.Generator().manual_seed(2)
    worst = 0.0
    reset_launch_counts()
    for n in (64, 256):
        toks = torch.randint(0, cut.vocab_size, (1, n), generator=rng)
        caches = {d: init_cache(cut, 1, n + 2, device=d) for d in ps}
        logits = {d: prefill(ps[d], cut, toks.to(d), caches[d])[0] for d in ps}
        for i in range(5):
            worst = max(worst, check_close(f"nemotron cut, prompt {n}, step {i}",
                                           logits[dev].cpu(), logits["cpu"], PARITY_TOL))
            nxt = {d: int(logits[d].argmax()) for d in ps}
            if nxt[dev] != nxt["cpu"]:
                raise AssertionError(f"nemotron cut, prompt {n}, step {i}: greedy {nxt[dev]} on "
                                     f"the card, {nxt['cpu']} on the cpu")
            if i == 4:
                break
            tok = torch.tensor([[nxt["cpu"]]])
            logits = {d: decode_step(ps[d], cut, tok.to(d), caches[d])[0] for d in ps}
    counts = launch_counts()
    if counts["flash_attention"] <= 0 or counts["decode_attention"] <= 0:
        raise AssertionError(f"the nemotron cut ran no K5/K6 launch: {counts}")
    log(f"nemotron-4-340b cut ({cut.n_layers} layers, d_model {cut.d_model}, {cut.n_heads} heads "
        f"over {cut.n_kv_heads} of {cut.head_dim_}, f32) card vs cpu, prompts 64 and 256 into "
        f"caches 2 slots longer, prefill + 4 decode steps (2 past the last slot): max|err| "
        f"{worst:.3g} (tol {PARITY_TOL}), greedy tokens equal")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phase", choices=("all", "kernels"), default="all")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout (src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  nvcc: {line.strip()}")
    dev = torch.device("cuda", 0)

    kernels = kernel_phase(dev)
    if args.phase == "kernels":
        return 0
    stream, stream_concurrent, phase3 = main_path_phase(dev)
    runs = {"stream path": stream, "stream path, concurrent": stream_concurrent}
    runs["session"], runs["session, concurrent"] = session_phase(dev, card)
    runs.update(worker_phase(dev, phase3))
    runs.update(transport_sharded_phase(dev, phase3))
    runs.update(cluster_phase(dev, phase3))
    trace_cli_phase(dev)
    runs.update(frontend_phase(dev))
    for arch, cut_layers, needed, seeds, bf16_limits, cut_limits, extra in SERVE_PHASES:
        runs[f"{arch} serving"] = serve_phase(dev, arch, cut_layers, needed, seeds, bf16_limits,
                                              cut_limits, **extra)
    runs["reuse serving"] = reuse_serving_phase(dev)
    nemotron_cut_phase(dev)
    log("launches: " + "; ".join(f"{name} {counts}" for name, counts in runs.items()))
    for k in kernels:
        k["launches"] = sum(counts[k["name"]] for counts in runs.values())
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was launched on no counted path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
