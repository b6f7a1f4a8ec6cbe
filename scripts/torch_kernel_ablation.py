#!/usr/bin/env python3
"""Where K7 and the kalman scan spend their time on the card.

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
    into a cycle of period 2 after 19, and not within 16384 rows.

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


def ssd_kernels_us(fn, calls: int = 10) -> dict:
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/torch_kernel_ablation.json")
    args = parser.parse_args()

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
    report["ssd_kernels_us"] = ssd_kernels_us(k7)
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

    report["kalman_us"] = {}
    for rows in KALMAN_ROWS:
        batch = torch.randn((rows, 8), generator=gen).to(dev)
        z = batch[:, 1:6]
        xe0, p0 = torch.zeros(5, device=dev), torch.ones(5, device=dev)
        for q, r in KALMAN_QR:
            us = device_ms(lambda: kalman.kalman_scan(z, xe0, p0, q, r), per_graph=5, reps=5) * 1e3
            report["kalman_us"][f"{rows} q={q} r={r}"] = us
            print(f"kalman_scan ({rows},5) q {q} r {r}, p0 = 1: {us:.2f} us")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
