#!/usr/bin/env python3
"""Smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
device and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``), and exits
non-zero, printing no result, without either or outside a checkout.

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); build the kernels from
     ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
  2. every kernel against its plain PyTorch version on the card, at the
     stream path's shapes (K1 also at model widths, f32 and bf16; K4-K6 at
     the serving path's, bf16 and f32); K2/K3
     must be bitwise equal to the eager op-by-op path; device time per
     launch (CUDA-graph replay between CUDA events) beside the bound, the
     plain version's and the one-call library time;
  3. the main path: ``StreamSystem(backend="torch", base_batch=16384)``
     runs the 21 RIoT dataflows plus the kernel flows — 3 steps, fuse(),
     3 steps, remove three dataflows, 2 steps — with launch counts reset
     just before and read just after; sink counts exact; digests bitwise
     equal to an unfused run; counts equal to a CPU run at base_batch=1024
     and checksums within CPU_RTOL;
  4. the serving path at full width: qwen3-4b (36 layers, bf16, random
     weights drawn on the card from a seeded generator) through
     ``ServeEngine(slots=4, max_len=4096)``, 8 greedy requests of 16 new
     tokens, prompts of 128-2048 tokens; launch counts reset just before
     and read just after (K1, K4, K5, K6 > 0); prefill ms per prompt
     length, decode ms per token, tokens/s, peak memory; prefill/decode
     consistency; the configuration cut to 2 layers in f32 on the card
     against the CPU (logits within 1e-3, greedy tokens equal);
  5. a ``{"kernels": [...]}`` line (launches summed over the counted runs
     of phases 3 and 4), the card line as nvidia-smi gives it, and as the
     last line ``{"ok": true, "device": {...}}``.

``--phase kernels`` stops after phase 2 (a first check of new kernels).
"""
from __future__ import annotations

import argparse
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
    return 0.0


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

    # kalman scan (a helper of the path, not a TPU-kernel port)
    xe0 = torch.zeros(d, device=dev)
    p0 = torch.ones(d, device=dev)
    y, xe1, p1 = kalman.kalman_scan(x, xe0, p0, 0.1, 1.0)
    y_ref, xe_ref, p_ref = ref.kalman_scan_ref(x, xe0, p0, 0.1, 1.0)
    err = max(check_close("kalman_scan", y, y_ref, F32_TOL),
              check_close("kalman_scan xe", xe1, xe_ref, F32_TOL),
              check_close("kalman_scan p", p1, p_ref, F32_TOL))
    b, by = bound_ms(io_bytes + 4 * d * 4, 8 * rows * d)
    out.append(dict(
        name="kalman_scan", route="cuda", source="src/repro_torch/kernels/csrc/kalman.cu",
        replaces="src/repro/ops/riot.py:222 (lax.scan, not a Pallas kernel)",
        max_abs_err=err,
        ms=device_ms(lambda: kalman.kalman_scan(x, xe0, p0, 0.1, 1.0), per_graph=5, reps=5),
        # ~8 launches per row: too many to capture, timed as one call
        plain_ms=call_ms(lambda: ref.kalman_scan_ref(x, xe0, p0, 0.1, 1.0), iters=1, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None,
        call_ms=call_ms(lambda: kalman.kalman_scan(x, xe0, p0, 0.1, 1.0), iters=20),
    ))
    log(f"kalman_scan (16384,5): max|err| {err:.3g} vs plain (bitwise: {err == 0.0})")
    out += model_kernel_phase(dev, gen)
    for k in out:
        log(f"  {k['name']}: {k['ms'] * 1e3:.2f} us/launch on the device "
            f"({k['call_ms'] * 1e3:.2f} us per call from the host), plain {k['plain_ms'] * 1e3:.2f} us, "
            f"bound {k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), library "
            + ("n/a" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.2f} us"))
    return out


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
            f"(tol {attn_tol})")

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
            f"max|err| {err:.3g} (tol {attn_tol})")
        for k_ in (k4, k5, k6):
            log(f"  {k_['name']} {tag}: {k_['ms'] * 1e3:.2f} us/launch on the device "
                f"({k_['call_ms'] * 1e3:.2f} us per call from the host), plain "
                f"{k_['plain_ms'] * 1e3:.2f} us, bound {k_['bound_ms'] * 1e3:.3f} us "
                f"({k_['bound_by']}), library "
                + ("n/a" if k_["library_ms"] is None else f"{k_['library_ms'] * 1e3:.2f} us"))
        del x, r, q, k, v, kc, vc
    out += [k4, k5, k6]  # the bfloat16 rows: the serving path's type
    return out


# -- phase 3: the main path ------------------------------------------------------------

def run_script(base_batch, device, fuse):
    """The stream path's script; returns (digests, per-step wall ms, system)."""
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    system = StreamSystem(backend="torch", base_batch=base_batch, device=device)
    flows = riot_workload() + kernel_flows()
    for df in flows:
        system.submit(df)
    walls = [r.wall_ms for r in system.run(3)]
    fused = system.fuse() if fuse else {}
    if fuse and not fused:
        raise AssertionError("fuse() fused no segment chain")
    walls += [r.wall_ms for r in system.run(3)]
    for name in REMOVED:
        system.remove(name)
    walls += [r.wall_ms for r in system.run(2)]
    digests = {df.name: system.sink_digests(df.name) for df in flows if df.name not in REMOVED}
    return digests, walls, system


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
    log(f"step wall ms, unfused run: {[round(w, 3) for w in unfused_walls]}")
    log(f"median step wall ms at base_batch={MAIN_BATCH}: fused steps 4-8 "
        f"{statistics.median(walls[3:]):.3f}, unfused steps 4-8 "
        f"{statistics.median(unfused_walls[3:]):.3f}")
    steps = len(walls)
    return {name: n for name, n in launches.items()}, steps


# -- phase 4: the serving path at full width --------------------------------------

SERVE_ARCH = "qwen3-4b"
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 8, 16, 4, 4096
# prefill(prompt) vs prefill(prompt[:-1]) + decode_step(prompt[-1]) in bf16 over
# 36 layers: the two paths round the last token's activations in different
# matmul shapes (M = S against M = 1) and attention kernels (K5 against K6),
# about one bf16 rounding (2**-9 relative) per op, compounding through the
# residual stream; held to 5e-2 of the largest logit, cosine >= 0.999 and
# the same greedy token.
CONSISTENCY_REL, CONSISTENCY_COS = 5e-2, 0.999
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)  # card vs CPU in f32: 2560- and 151936-wide sums


def serve_phase(dev):
    """qwen3-4b at full width and depth in bf16 through ServeEngine; returns
    the launch counts of the engine run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = configs.get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters drawn on the card in {time.perf_counter() - t0:.1f} s ({cfg.param_dtype})")

    rng = np.random.default_rng(0)
    lens = rng.integers(128, SERVE_PROMPT + 1, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    engine = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid, prompt, max_new=SERVE_NEW))
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if sorted(r.rid for r in results) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"served {sorted(r.rid for r in results)}")
    for r in results:
        if len(r.tokens) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: tokens {r.tokens}")
    for name in ("rmsnorm", "rmsnorm_residual", "flash_attention", "decode_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    log(f"served {len(results)} requests x {SERVE_NEW} tokens, prompts {sorted(lens.tolist())}, "
        f"slots {SERVE_SLOTS}, max_len {SERVE_MAX_LEN}: {wall:.2f} s, "
        f"{SERVE_REQUESTS * SERVE_NEW / wall:.1f} generated tokens/s; launches {launches}")
    log(f"first tokens: {[r.tokens[:4] for r in sorted(results, key=lambda r: r.rid)]}")
    del engine

    # prefill ms per prompt length and decode ms per token at batch 1
    cache = init_cache(cfg, 1, SERVE_MAX_LEN, device=dev)
    for n in (128, 512, 1024, SERVE_PROMPT):
        toks = torch.from_numpy(prompts[0][:1].repeat(n)).long()[None].to(dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, cfg, toks, cache)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"prefill {n} tokens: {statistics.median(times):.2f} ms (median of 3; {times})")
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    times = []
    for _ in range(SERVE_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"decode at {SERVE_PROMPT}+ cached positions, batch 1: "
        f"{statistics.median(times):.2f} ms/token (median of {len(times)})")

    # prefill/decode consistency on one prompt
    prompt = torch.from_numpy(prompts[0]).long()[None].to(dev)
    full, _ = prefill(params, cfg, prompt, init_cache(cfg, 1, SERVE_MAX_LEN, device=dev))
    cache = init_cache(cfg, 1, SERVE_MAX_LEN, device=dev)
    prefill(params, cfg, prompt[:, :-1], cache)
    step, _ = decode_step(params, cfg, prompt[:, -1:], cache)
    a, b = full.float(), step.float()
    rel = float((a - b).abs().max() / a.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
    log(f"prefill/decode consistency ({prompt.shape[1]} tokens): max|diff|/max|logit| {rel:.3g} "
        f"(limit {CONSISTENCY_REL}), cosine {cos:.6f} (limit {CONSISTENCY_COS}), "
        f"argmax {int(a.argmax())} vs {int(b.argmax())}")
    if rel > CONSISTENCY_REL or cos < CONSISTENCY_COS or int(a.argmax()) != int(b.argmax()):
        raise AssertionError("prefill and decode_step disagree on the last token")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory (max_memory_allocated): {peak:.2f} GiB")
    del params, cache

    # card against CPU: the same configuration cut to 2 layers, float32
    cut = cfg.replace(n_layers=2, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    cpu_params = init_params(cut, torch.Generator().manual_seed(0))
    dev_params = tree_map(lambda t: t.to(dev), cpu_params)
    log(f"{cut.name} cut to 2 layers, float32: parameters drawn on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    worst = 0.0
    for n in (64, 256):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=n)).long()[None]
        caches = {d: init_cache(cut, 1, n + 8, device=d) for d in ("cpu", dev)}
        ps = {"cpu": cpu_params, dev: dev_params}
        logits = {d: prefill(ps[d], cut, toks.to(d), caches[d])[0] for d in caches}
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
    log(f"card vs cpu (2 layers, f32, prompts 64 and 256, prefill + 4 decode steps): "
        f"max|err| {worst:.3g} (tol {PARITY_TOL}), greedy tokens equal")
    return launches


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
    stream_launches, _ = main_path_phase(dev)
    serve_launches = serve_phase(dev)
    log(f"launches: stream path {stream_launches}; serving path {serve_launches}")
    for k in kernels:
        k["launches"] = stream_launches[k["name"]] + serve_launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
