#!/usr/bin/env python3
"""Where K7, the kalman scan and the ssm family's scans spend their time on the card.

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

``--only ssm`` (or ``k7``, ``kalman``) runs one part.

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

from chip_smoke import device_ms  # noqa: E402

GROUPS = (1, 2, 5, 10, 20)
KALMAN_ROWS = (256, 16384)
KALMAN_QR = ((0.1, 1.0), (0.3, 1.5), (1e-6, 1e3))


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/torch_kernel_ablation.json")
    parser.add_argument("--only", choices=("k7", "kalman", "ssm"), default=None)
    args = parser.parse_args()
    parts = (args.only,) if args.only else ("k7", "kalman", "ssm")

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
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
