#!/usr/bin/env python3
"""Where a step of the PyTorch port's stream path spends its time, on the card.

Runs the main path of ``chip_smoke.py`` (the 21 RIoT dataflows plus the
kernel flows, ``base_batch`` events per source per step, fused), then
profiles a few steady steps with ``torch.profiler`` (CPU and CUDA
activities). Each operator's ``apply`` is wrapped in a ``record_function``
named after its task type, so host time splits by task type.

Prints, and writes as JSON to ``--out``:
  * step wall ms (host clock around ``step()``, which waits for the card),
    for steps without and with the profiler;
  * device busy ms per step (sum of kernel times; one stream, so kernels
    do not overlap) and the idle share ``1 - busy / wall``;
  * kernel launches per step, and the top kernels by device time;
  * host ms per task type (the operator's Python and launch cost).

Usage (on a machine with a CUDA device, from the repository root):
    python3 scripts/torch_step_profile.py [--batch 16384] [--steps 3]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def _wrap_ops(system):
    import torch

    for seg in system.backend.segments.values():
        for tid, op in seg.operators.items():
            label = f"op::{system.backend.task_defs[tid].type}"
            if seg.fused_runs.get(tid):
                label += "(fused)"
            inner = op.apply

            def apply(*args, _inner=inner, _label=label):
                with torch.profiler.record_function(_label):
                    return _inner(*args)

            op.apply = apply


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16384)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default="chiprun_out/torch_step_profile.json")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    system = StreamSystem(backend="torch", base_batch=args.batch)
    for df in riot_workload() + kernel_flows():
        system.submit(df)
    system.run(3)
    system.fuse()
    system.run(2)  # warm: allocator and cuBLAS settled
    _wrap_ops(system)

    plain_walls = [r.wall_ms for r in system.run(args.steps)]  # without the profiler
    reset_launch_counts()
    walls = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            system.step()
            walls.append((time.perf_counter() - t0) * 1e3)
    steps = args.steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events: the kernels, plus the GPU-timeline copies of the
    # op:: ranges, which span gaps and are left out of the busy time
    kernels = [
        e for e in prof.key_averages()
        if e.device_type is not None and "CUDA" in str(e.device_type) and not e.key.startswith("op::")
    ]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    host_us = {}
    for ev in prof.events():
        if ev.name.startswith("op::") and "CPU" in str(ev.device_type):
            host_us[ev.name[4:]] = host_us.get(ev.name[4:], 0.0) + ev.cpu_time_total
    wall = statistics.median(walls)
    report = {
        "card": card,
        "batch": args.batch,
        "steps_profiled": steps,
        "segments": len(system.backend.segments),
        "tasks_deployed": system.deployed_task_count,
        "step_wall_ms_unprofiled": plain_walls,
        "step_wall_ms": walls,
        "step_wall_ms_median": wall,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall),
        "kernel_launches_per_step": launches,
        "repro_torch_kernel_launches": launch_counts(),
        "top_kernels": [
            {"name": e.key[:120], "device_ms_per_step": dev_us(e) / 1e3 / steps,
             "launches_per_step": e.count / steps}
            for e in top
        ],
        "host_ms_per_step_by_task_type": {
            name: us / 1e3 / steps for name, us in sorted(host_us.items(), key=lambda kv: -kv[1])
        },
    }
    print(f"card: {card}")
    print(f"step wall ms without the profiler {plain_walls}")
    print(f"step wall ms {walls} (median {wall:.3f}); device busy {busy_ms:.3f} ms/step; "
          f"idle share {report['device_idle_share']:.3f}; {launches:.0f} kernel launches/step")
    for k in report["top_kernels"]:
        print(f"  {k['device_ms_per_step']:9.3f} ms  x{k['launches_per_step']:6.1f}  {k['name']}")
    for name, ms in report["host_ms_per_step_by_task_type"].items():
        print(f"  host {ms:9.3f} ms  {name}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
