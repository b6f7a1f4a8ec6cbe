#!/usr/bin/env python3
"""Device time of the port's row kernels at the shapes the serving and
stream paths give them, for comparing two checkouts in one call.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/torch_row_bench.py [--src DIR] [--out FILE]

``--src`` is the ``src`` directory of the checkout whose kernels are timed
(default: this checkout's); the timing and the shapes are this script's
(``chip_smoke.device_ms``: CUDA-graph replays between CUDA events), so two
checkouts are timed alike. Times, in device µs per launch:
  * K1 ``rmsnorm`` in bf16 at ``chip_smoke.RMS_SHAPES`` (qwen3-4b's q- and
    k-norm at 2048 tokens, its layer-0 norm, zamba2-2.7b's out_norm, a
    decode step's q-norm), beside ``F.rms_norm`` on the same input;
  * K4 ``rmsnorm_residual`` in bf16 at (2048, 2560) and (2048, 5120);
  * K1, K2 ``map_chain`` and K3 ``affine_rmsnorm`` at the stream path's
    (16384, 5) f32 column view.
With ``--plans`` it times instead K1 and K4 at those bf16 shapes under
every register-route plan that fits the row (each power-of-two thread count
per row with the fewest chunks a thread that cover it) and under the
two-pass route, marking the plan ``rmsnorm.row_plan`` picks: the reading
that chose its rule. Prints the card's name and power limit, one line per
kernel, shape (and plan), and the whole as one JSON line, which it also
writes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
K4_SHAPES = ((2048, 2560), (2048, 5120))


def plan_sweep(dev, gen, shapes, timed) -> None:
    """K1 and K4 (bf16) at each shape under every plan that fits (see the
    module's docstring), launched through the C entry points."""
    import torch

    from repro_torch.kernels import build, rmsnorm
    from repro_torch.kernels._launch import stream_ptr

    lib, eps = build.library(), 1e-6
    cases = [("K1", rows, d) for (rows, d), _ in shapes] + [("K4", rows, d) for rows, d in K4_SHAPES]
    for kernel, rows, d in cases:
        x, r = (torch.randn((rows, d), generator=gen).to(dev, torch.bfloat16) for _ in range(2))
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        y, h = torch.empty_like(x), torch.empty_like(x)
        n = -(-d // 8)  # 16-byte chunks of a bf16 row
        plans = [rmsnorm.RowPlan("two-pass", 256, 1, False)]
        t = 1
        while t <= rmsnorm.MAX_ROW_THREADS:
            c = -(-n // t)
            if c <= rmsnorm.MAX_ROW_CHUNKS and (t == 1 or -(-n // (t // 2)) > c):  # fewer chunks
                plans.append(rmsnorm.RowPlan("registers", t, c, d % 8 == 0))
            t *= 2
        chosen = rmsnorm.row_plan(d, 2, True)
        for plan in plans:
            if kernel == "K1":
                def fn(plan=plan):
                    build.check(lib.rt_rmsnorm(x.data_ptr(), d, g.data_ptr(), y.data_ptr(), rows, d,
                                               eps, 1, *plan.args(), stream_ptr(x)), "rmsnorm")
            else:
                def fn(plan=plan):
                    build.check(lib.rt_rmsnorm_residual(
                        x.data_ptr(), d, r.data_ptr(), d, g.data_ptr(), y.data_ptr(), h.data_ptr(),
                        rows, d, eps, 1, *plan.args(), stream_ptr(x)), "rmsnorm_residual")
            mark = " (row_plan)" if plan == chosen else ""
            timed(f"{kernel} ({rows},{d}) bf16 {plan.route} {plan.threads}x{plan.chunks}{mark}", fn)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    parser.add_argument("--out", default="chiprun_out/torch_row_bench.json")
    parser.add_argument("--plans", action="store_true", help="time every plan at each shape")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_row_bench: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import RMS_SHAPES, device_ms
    from repro_torch.kernels import fused, rmsnorm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; kernels from {os.path.abspath(args.src)}")
    dev, eps = torch.device("cuda", 0), 1e-6
    gen = torch.Generator().manual_seed(0)
    us = {}

    def timed(key, fn):
        us[key] = device_ms(fn) * 1e3
        print(f"{key}: {us[key]:.2f} us/launch on the device", flush=True)

    if args.plans:
        plan_sweep(dev, gen, RMS_SHAPES, timed)
    for (rows, d), _what in ([] if args.plans else RMS_SHAPES):
        x = torch.randn((rows, d), generator=gen).to(dev, torch.bfloat16)
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        g16 = g.to(torch.bfloat16)
        timed(f"K1 rmsnorm ({rows},{d}) bf16", lambda: rmsnorm.rmsnorm(x, g, eps))
        timed(f"F.rms_norm ({rows},{d}) bf16", lambda: F.rms_norm(x, (d,), g16, eps))
    for rows, d in (() if args.plans else K4_SHAPES):
        x, r = (torch.randn((rows, d), generator=gen).to(dev, torch.bfloat16) for _ in range(2))
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        timed(f"K4 rmsnorm_residual ({rows},{d}) bf16", lambda: rmsnorm.rmsnorm_residual(x, r, g, eps))
    if not args.plans:
        x = (torch.randn((16384, 8), generator=gen) * 4.0 + 1.0).to(dev)[:, 1:6]
        g = torch.full((5,), 1.5, device=dev)
        stages = ((2.0, 0.5), (0.7, -0.1))
        timed("K1 rmsnorm (16384,5) f32 strided", lambda: rmsnorm.rmsnorm(x, g, eps))
        timed("K2 map_chain (16384,5) f32 strided", lambda: fused.map_chain(x, stages))
        timed("K3 affine_rmsnorm (16384,5) f32 strided",
              lambda: fused.affine_rmsnorm(x, g, stages, eps))
    report = {"card": card, "src": os.path.abspath(args.src), "device_us": us}
    print(json.dumps(report))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
