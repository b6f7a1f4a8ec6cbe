#!/usr/bin/env python3
"""Where K7, the kalman scan, the ssm family's scans and the backward kernels spend their time on the card.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/torch_kernel_ablation.py``. Prints, and writes as JSON to
``--out``:

  * K7 ``ssd_scan`` at zamba2-2.7b's prefill shape (xh (1, 2048, 80, 64),
    N 64, chunk 128, bf16): device µs per call, the device µs of each of
    the tensor-core build's three kernels (torch.profiler), and the device
    µs per call with the output kernel's head group forced to each of a few
    sizes (the plan's choice among them);
  * ``kalman_scan`` at (rows, 5) from p0 = 1 for rows 256 and 16384 and
    gain parameters (q, r) that settle into a fixed point after 27 rows,
    into a cycle of period 2 after 19, and not within 16384 rows;
  * the ssm scans at xlstm-1.3b's prefill of 2048 tokens, in bf16 and f32:
    ``mlstm_scan`` (q/k/v (1, 2048, 4, 1024), chunk 64) with its launch
    plan and the device µs of each of its two kernels, and ``slstm_scan``
    (xg (1, 2048, 8192), R (4, 4, 512, 512)) with its plan, the clusters
    the card places at once, its µs a step, and the chain's floor: the same
    clusters doing the 2048 steps' h exchange and barrier alone.

  * the training path's two backward kernels in bf16 (``--only bwd``):
    ``flash_attention_bwd`` at ``chip_smoke.ATTN_BWD_SHAPES`` (qwen3-4b's
    causal q (1, 2048, 32, 128) over 8 KV heads, a window of 512, no mask
    at Sk 1024, zamba2-2.7b's causal q and kv (1, 2048, 32, 80),
    nemotron-4-340b's (1, 2048, 96, 192) over 8 and deepseek-v2's MLA at
    q/k 192 and v 128, which take the wide build on wgmma: its launch plan
    printed too) and ``rmsnorm_bwd`` at :data:`BWD_ROWS` (K4's form at the
    seams' (2048, 2560), K1's there and at the q- and k-norm's (65536, 128)
    and (16384, 128)): device µs per call and of each of its launches (D,
    dk/dv and dq, at 192 ``fa_bwd_rows_wide``, ``fa_bwd_dkdv_wide`` and
    ``fa_bwd_dq_wide``; the row pass and the dscale sum).

  * the scans' backward kernels, bf16 and f32 (``--only scan_bwd``):
    ``ssd_scan_bwd`` at zamba2-2.7b's 2048-token step (xh (1, 2048, 80,
    64), N 64, chunk 128), ``mlstm_scan_bwd`` (q/k/v (1, 2048, 4, 1024),
    chunk 64) and ``slstm_scan_bwd`` (xg (1, 2048, 8192), R (4, 4, 512,
    512)) at xlstm-1.3b's: device µs per call and of each launch
    (``ssd_scan_bwd``'s bf16 build: states, passes, chunk terms, sums; the
    sLSTM's two products around its kernel included, and its kernel alone
    with µs a step), the three scans' launch plans;
    ``ssd_scan_bwd`` also with 20 calls a graph and 21 replays, beside
    ``device_ms``'s 1 call and 5 replays for a call over 1 ms.

``--only ssm`` (or ``k7``, ``kalman``, ``bwd``, ``scan_bwd``) runs one part; ``--src
<checkout>/src`` times another checkout's port with this script (compare
two in one call, in turns).

Device times are CUDA-graph replays between CUDA events
(``chip_smoke.device_ms``); the card's name and power limit head the
output.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import ATTN_BWD_SHAPES, device_ms  # noqa: E402

GROUPS = (1, 2, 5, 10, 20)
KALMAN_ROWS = (256, 16384)
KALMAN_QR = ((0.1, 1.0), (0.3, 1.5), (1e-6, 1e3))
BWD_ROWS = (("K4", 2048, 2560), ("K1", 2048, 2560), ("K1", 65536, 128), ("K1", 16384, 128))


def kernels_us(fn, calls: int = 10) -> dict:
    """Device µs per call of each CUDA kernel that ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type is not None and "CUDA" in str(e.device_type):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            key = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = key.split("(")[0].split("<")[0].split("::")[-1] or key[:60]
            out[name] = us / calls
    return out


def ssm_scans(dev, gen) -> dict:
    """The ssm scans' plans and device times at xlstm-1.3b's prefill."""
    import torch

    from repro_torch.kernels import mlstm, slstm

    out = {}
    b, s, nh, p, chunk, hd = 1, 2048, 4, 1024, 64, 512
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        q, k, v = (torch.randn((b, s, nh, p), generator=gen).to(dev, dtype) for _ in range(3))
        ig, fg = (torch.randn((b, s, nh), generator=gen).to(dev) for _ in range(2))
        fn = lambda: mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk)  # noqa: E731
        plan = mlstm.launch_plan(b, s, nh, p, chunk, dtype)
        us = device_ms(fn, per_graph=5, reps=5) * 1e3
        by = kernels_us(fn)
        out[f"mlstm_{tag}"] = {"us": us, "kernels_us": by, "plan": plan}
        print(f"mlstm_scan (1,{s},{nh},{p}) chunk {chunk} {tag}: {us:.2f} us per call; {plan}; "
              f"by kernel {({k_: round(v_, 2) for k_, v_ in by.items()})}")
        del q, k, v
        xg = torch.randn((b, s, 4 * nh * hd), generator=gen).to(dev, dtype)
        r = (torch.randn((4, nh, hd, hd), generator=gen) * hd ** -0.5).to(dev, dtype)
        plan = slstm.launch_plan(hd, dtype, dtype)
        us = device_ms(lambda: slstm.slstm_scan(xg, r), per_graph=1, reps=5) * 1e3
        floor = device_ms(lambda: slstm.chain_floor(b, s, nh, hd, dtype, dev), per_graph=1, reps=5) * 1e3
        out[f"slstm_{tag}"] = {"us": us, "us_a_step": us / s, "chain_floor_us_a_step": floor / s,
                               "plan": plan}
        print(f"slstm_scan xg (1,{s},{4 * nh * hd}) R (4,{nh},{hd},{hd}) {tag}: {plan}; "
              f"{us:.2f} us per call, {us / s:.3f} us a step; the chain's floor {floor / s:.3f} us a step")
        del xg, r
    return out


def backward_kernels(dev, gen) -> dict:
    """The backward kernels' device µs per call and per launch, bf16."""
    import torch

    from repro_torch.kernels import flash_attention, rmsnorm

    out = {}
    bf16 = torch.bfloat16
    for label, sq, sk, h, kv, hd, hd_v, causal, window in ATTN_BWD_SHAPES:
        q = torch.randn((1, sq, h, hd), generator=gen).to(dev, bf16)
        do = torch.randn((1, sq, h, hd_v), generator=gen).to(dev, bf16)
        k = torch.randn((1, sk, kv, hd), generator=gen).to(dev, bf16)
        v = torch.randn((1, sk, kv, hd_v), generator=gen).to(dev, bf16)
        o, lse = flash_attention.flash_attention(q, k, v, causal=causal, window=window, with_lse=True)
        fn = lambda: flash_attention.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, causal=causal, window=window)
        us = device_ms(fn, per_graph=3, reps=5) * 1e3
        by = kernels_us(fn, calls=5)
        plan = flash_attention.bwd_launch_plan(1, sq, sk, h, kv, hd, hd_v, bf16)
        out[f"flash_attention_bwd {label}"] = {"us": us, "kernels_us": by, "plan": plan}
        print(f"flash_attention_bwd {label} q (1,{sq},{h},{hd}) kv (1,{sk},{kv},{hd}/{hd_v}) bf16: {us:.2f} us "
              f"per call; by kernel {({k_: round(v_, 2) for k_, v_ in by.items()})}; {plan}")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for form, n, d in BWD_ROWS:
        x, res, gy, gh = (torch.randn((n, d), generator=gen).to(dev, bf16) for _ in range(4))
        scale = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        if form == "K1":
            fn = lambda: rmsnorm.rmsnorm_bwd(x, gy, scale)  # noqa: E731
        else:
            fn = lambda: rmsnorm.rmsnorm_bwd(x, gy, scale, res=res, gh=gh)  # noqa: E731
        us = device_ms(fn) * 1e3
        by = kernels_us(fn)
        out[f"rmsnorm_bwd {form} ({n},{d})"] = {"us": us, "kernels_us": by}
        print(f"rmsnorm_bwd {form} ({n},{d}) bf16: {us:.2f} us per call; by kernel "
              f"{({k_: round(v_, 2) for k_, v_ in by.items()})}")
        del x, res, gy, gh
    return out


def scan_backward_kernels(dev, gen) -> dict:
    """The scans' backward kernels' device µs per call and per launch."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mlstm, slstm, ssd

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        b, s, nh, p, n, chunk = 1, 2048, 80, 64, 64, 128
        xh = torch.randn((b, s, nh, p), generator=gen).to(dev, dtype)
        dt = F.softplus(torch.randn((b, s, nh), generator=gen)).to(dev)
        a = -torch.exp(0.5 * torch.randn((nh,), generator=gen)).to(dev)
        bm, cm = (torch.randn((b, s, n), generator=gen).to(dev, dtype) for _ in range(2))
        dy = torch.randn((b, s, nh, p), generator=gen).to(dev)
        cases = [(f"ssd_scan_bwd (1,{s},{nh},{p}) N {n} chunk {chunk} {tag}",
                  lambda chunk=chunk: ssd.ssd_scan_bwd(xh, dt, a, bm, cm, dy, chunk=chunk), 3)]
        plans = {}  # another checkout's port may predate the backward plans
        if hasattr(ssd, "bwd_launch_plan"):
            slots = ssd._bwd_slots(dev, chunk, n, p) if ssd.bwd_route(dtype) == "mma" else 0
            plans[cases[-1][0]] = ssd.bwd_launch_plan(b, s, nh, chunk, n, p, dtype, slots)
        nh, p, chunk = 4, 1024, 64
        q, k, v = (torch.randn((b, s, nh, p), generator=gen).to(dev, dtype) for _ in range(3))
        ig = torch.randn((b, s, nh), generator=gen).to(dev)
        fg = torch.randn((b, s, nh), generator=gen).to(dev) + 3.0
        y, _ = mlstm.mlstm_scan(q, k, v, ig, fg, chunk=chunk)
        dym = torch.randn((b, s, nh, p), generator=gen).to(dev)
        cases.append((f"mlstm_scan_bwd (1,{s},{nh},{p}) chunk {chunk} {tag}",
                      lambda: mlstm.mlstm_scan_bwd(q, k, v, ig, fg, y, dym, chunk=chunk), 1))
        if hasattr(mlstm, "bwd_launch_plan"):
            plans[cases[-1][0]] = mlstm.bwd_launch_plan(b, s, nh, p, chunk, dtype)
        hd = 512
        xg = torch.randn((b, s, 4 * nh * hd), generator=gen).to(dev, dtype)
        r = (torch.randn((4, nh, hd, hd), generator=gen) * hd ** -0.5).to(dev, dtype)
        hs, _ = slstm.slstm_scan(xg, r)
        dhs = torch.randn((b, s, nh, hd), generator=gen).to(dev)
        cases.append((f"slstm_scan_bwd (1,{s},{4 * nh * hd}) R (4,{nh},{hd},{hd}) {tag}",
                      lambda: slstm.slstm_scan_bwd(xg, r, hs, dhs), 1))
        if hasattr(slstm, "bwd_launch_plan"):
            plans[cases[-1][0]] = slstm.bwd_launch_plan(hd, dtype)
        for label, fn, per_graph in cases:
            us = device_ms(fn, per_graph=per_graph, reps=3) * 1e3
            by = kernels_us(fn, calls=2)
            out[label] = {"us": us, "kernels_us": by}
            if label.startswith("ssd_scan_bwd"):
                out[label]["us_20_calls_21_replays"] = device_ms(fn, per_graph=20, reps=21, adapt=False) * 1e3
            if label in plans:
                out[label]["plan"] = plans[label]
            print(f"{label}: {us:.1f} us per call; by kernel {({k_: round(v_, 1) for k_, v_ in by.items()})}"
                  + (f"; {plans[label]}" if label in plans else ""))
            if label.startswith("slstm_scan_bwd"):
                # the reverse chain's kernel apart from the two products around it
                chain = sum(v_ for k_, v_ in by.items() if k_.startswith("slstm_bwd"))
                out[label].update(kernel_us=chain, kernel_us_a_step=chain / s, products_us=sum(by.values()) - chain)
                print(f"  the kernel {chain:.1f} us ({chain / s:.3f} us a step), the products and "
                      f"copies around it {sum(by.values()) - chain:.1f} us")
        del xh, dt, a, bm, cm, dy, q, k, v, ig, fg, y, dym, xg, r, hs, dhs, cases
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/torch_kernel_ablation.json")
    parser.add_argument("--only", choices=("k7", "kalman", "ssm", "bwd", "scan_bwd"), default=None)
    parser.add_argument("--src", default=None, help="the src/ directory of another checkout to time")
    args = parser.parse_args()
    parts = (args.only,) if args.only else ("k7", "kalman", "ssm", "bwd", "scan_bwd")
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import kalman, ssd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}")
    import repro_torch

    print(f"port: {os.path.relpath(os.path.dirname(repro_torch.__file__), ROOT)}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    report = {"card": card}

    if "k7" in parts:
        b, s, nh, p, n, chunk = 1, 2048, 80, 64, 64, 128
        xh = torch.randn((b, s, nh, p), generator=gen).to(dev, torch.bfloat16)
        dt = F.softplus(torch.randn((b, s, nh), generator=gen)).to(dev)
        a = -torch.exp(0.5 * torch.randn((nh,), generator=gen)).to(dev)
        bm = torch.randn((b, s, n), generator=gen).to(dev, torch.bfloat16)
        cm = torch.randn((b, s, n), generator=gen).to(dev, torch.bfloat16)

        def k7():
            return ssd.ssd_scan(xh, dt, a, bm, cm, chunk=chunk)

        plan = ssd._plan(dev, b, s // chunk, nh, chunk, n, p)
        report["ssd_us"] = device_ms(k7, per_graph=5) * 1e3
        report["ssd_kernels_us"] = kernels_us(k7)
        print(f"K7 ssd_scan (1,{s},{nh},{p}) N {n} chunk {chunk} bf16: {report['ssd_us']:.2f} us per "
              f"call; by kernel {({k: round(v, 2) for k, v in report['ssd_kernels_us'].items()})}")
        planned = ssd._plan
        report["ssd_us_by_group"] = {}
        try:
            for g in GROUPS:
                ssd._plan = lambda *_args, g=g: g  # force the output kernel's head group
                us = device_ms(k7, per_graph=5) * 1e3
                report["ssd_us_by_group"][g] = us
                print(f"  head group {g}{' (the plan)' if g == plan else ''}: {us:.2f} us per call")
        finally:
            ssd._plan = planned
        report["ssd_planned_group"] = plan

    if "kalman" in parts:
        report["kalman_us"] = {}
        for rows in KALMAN_ROWS:
            batch = torch.randn((rows, 8), generator=gen).to(dev)
            z = batch[:, 1:6]
            xe0, p0 = torch.zeros(5, device=dev), torch.ones(5, device=dev)
            for q, r in KALMAN_QR:
                us = device_ms(lambda: kalman.kalman_scan(z, xe0, p0, q, r), per_graph=5, reps=5) * 1e3
                report["kalman_us"][f"{rows} q={q} r={r}"] = us
                print(f"kalman_scan ({rows},5) q {q} r {r}, p0 = 1: {us:.2f} us")
    if "ssm" in parts:
        report.update(ssm_scans(dev, gen))
    if "bwd" in parts:
        report.update(backward_kernels(dev, gen))
    if "scan_bwd" in parts:
        report.update(scan_backward_kernels(dev, gen))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
