#!/usr/bin/env python3
"""Where a step of the PyTorch port's stream path spends its time, on the card.

Three paths, each at ``--batch`` events per source per step:

  * **stream**: the main path of ``chip_smoke.py`` (the 21 RIoT dataflows
    plus the kernel flows), 3 steps, ``fuse()``, 2 steps, then ``--steps``
    steady steps without the profiler (the step walls) and ``--steps``
    under ``torch.profiler`` (CPU and CUDA activities);
  * **session**: ``chip_smoke.py``'s session script (``ReuseSession``:
    submit_many, 3 steps, fuse, 2 steps, defragment, 2 steps, remove three
    flows, 2 steps), then ``--steps`` steady steps; step walls;
  * **rw1**: the OPMW rw1 trace (``rw_trace(seed=11)``), one step after
    each of its 156 events; ms per step.

Each operator's ``apply`` is wrapped once (operators are shared between
structurally identical segments) in a ``record_function`` named after its
task type. Segments step through CUDA graphs after their first step
(``TorchBackend``'s default), and a ``record_function`` inside a capture
never fires on a replay, so the stream path's first step (the eager
warm-up of every segment) and its second (the captures) are profiled on
their own: host ms per task type come from those; the steady steps give
device busy ms, the idle share ``1 - busy / wall``, the operations the
card ran, and the host launch calls (of them graph launches) per step.
``--eager`` runs all three with ``TorchBackend(capture=False)``.

Prints, and writes as JSON to ``--out``. ``--src`` runs another
checkout's port (its ``src`` directory) with this script, to compare two
checkouts in one call; a port without step capture is eager by nature
(run it without ``--eager``).

Usage (on a machine with a CUDA device, from the repository root):
    python3 scripts/torch_step_profile.py [--batch 16384] [--steps 20] [--eager]
        [--paths stream,session,rw1] [--src <checkout>/src] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REMOVED = ("urban_etl", "taxi_pred_lr", "FA")  # chip_smoke.py's removals
RW1_SEED = 11
# host calls that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _wrap_ops(backend, wrapped):
    """Wrap each operator of the deployed segments once, by identity."""
    import torch

    for seg in backend.segments.values():
        for tid, op in seg.operators.items():
            if id(op) in wrapped:
                continue
            label = f"op::{backend.task_defs[tid].type}"
            if seg.fused_runs.get(tid):
                label += "(fused)"
            inner = op.apply

            def apply(*args, _inner=inner, _label=label):
                with torch.profiler.record_function(_label):
                    return _inner(*args)

            op.apply = apply
            wrapped[id(op)] = op  # keeps the id from being reused


def _profiled(steps, fn):
    """Run ``fn`` ``steps`` times under torch.profiler; returns the walls
    and the per-step readings of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events: kernels, copies and fills, without the GPU-timeline
    # copies of the op:: ranges, which span gaps
    on_card = [
        e for e in prof.key_averages()
        if e.device_type is not None and "CUDA" in str(e.device_type) and not e.key.startswith("op::")
    ]
    busy_ms = sum(dev_us(e) for e in on_card) / 1e3 / steps
    calls = {name: 0 for name in LAUNCH_CALLS}
    host_us = {}
    for ev in prof.events():
        if "CPU" not in str(ev.device_type):
            continue
        if ev.name in calls:
            calls[ev.name] += 1
        elif ev.name.startswith("op::"):
            host_us[ev.name[4:]] = host_us.get(ev.name[4:], 0.0) + ev.cpu_time_total
    wall = statistics.median(walls)
    return {
        "step_wall_ms": walls,
        "step_wall_ms_median": wall,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall),
        "card_operations_per_step": sum(e.count for e in on_card) / steps,
        "host_launch_calls_per_step": sum(calls.values()) / steps,
        "graph_launches_per_step": calls["cudaGraphLaunch"] / steps,
        "top_on_card": [
            {"name": e.key[:120], "device_ms_per_step": dev_us(e) / 1e3 / steps,
             "count_per_step": e.count / steps}
            for e in sorted(on_card, key=dev_us, reverse=True)[:15]
        ],
        "host_ms_per_step_by_task_type": {
            name: us / 1e3 / steps for name, us in sorted(host_us.items(), key=lambda kv: -kv[1])
        },
    }


def _capture_stats(backend):
    st = getattr(backend, "capture_stats", None)
    if st is None:
        return None
    return {"graphs": st.graphs, "capture_ms": st.capture_ms, "pool_bytes": st.pool_bytes,
            "replays": st.replays, "input_copies": st.input_copies,
            "eager_steps": st.eager_steps}


def _backend(args):
    from repro_torch.runtime.executor import TorchBackend

    return TorchBackend(capture=False) if args.eager else TorchBackend()


def stream_path(args):
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    backend = _backend(args)
    system = StreamSystem(backend=backend, base_batch=args.batch)
    for df in riot_workload() + kernel_flows():
        system.submit(df)
    wrapped = {}
    _wrap_ops(backend, wrapped)
    first = _profiled(1, system.step)  # every segment's eager warm-up
    second = _profiled(1, system.step)  # every segment's capture, then its replay
    system.run(1)
    system.fuse()
    _wrap_ops(backend, wrapped)
    system.run(2)  # the fused segments' warm-up and capture
    plain = [r.wall_ms for r in system.run(args.steps)]  # without the profiler
    reset_launch_counts()
    steady = _profiled(args.steps, system.step)
    steady["repro_torch_kernel_launches_per_step"] = {
        k: n / args.steps for k, n in launch_counts().items()}
    # the profiler lengthens the step; the busy time over the plain walls
    steady["device_idle_share_unprofiled"] = max(
        0.0, 1.0 - steady["device_busy_ms_per_step"] / statistics.median(plain))
    return {
        "segments": len(backend.segments),
        "tasks_deployed": system.deployed_task_count,
        "step_wall_ms_unprofiled": plain,
        "step_wall_ms_unprofiled_median": statistics.median(plain),
        "first_step": first,
        "second_step": second,
        "steady": steady,
        "capture": _capture_stats(backend),
    }


def session_path(args):
    from repro_torch.api import ReuseSession
    from repro_torch.workloads import kernel_flows, riot_workload

    backend = _backend(args)
    session = ReuseSession(execute=True, backend=backend, base_batch=args.batch)
    session.submit_many(riot_workload() + kernel_flows())
    walls = [r.wall_ms for r in session.run(3)]
    session.fuse()
    walls += [r.wall_ms for r in session.run(2)]
    session.defragment()
    walls += [r.wall_ms for r in session.run(2)]
    for name in REMOVED:
        session.remove(name)
    walls += [r.wall_ms for r in session.run(2)]
    steady = [r.wall_ms for r in session.run(args.steps)]
    return {
        "script_step_wall_ms": walls,
        "script_step_wall_ms_median": statistics.median(walls),
        "steady_step_wall_ms": steady,
        "steady_step_wall_ms_median": statistics.median(steady),
        "capture": _capture_stats(backend),
    }


def rw1_path(args):
    import torch

    from repro_torch.api import ReuseSession
    from repro_torch.workloads import opmw_workload, replay, rw_trace

    dags = opmw_workload()
    events = rw_trace(dags, seed=RW1_SEED)
    backend = _backend(args)
    session = ReuseSession(execute=True, backend=backend, base_batch=args.batch)
    t0 = time.perf_counter()
    walls = []
    for _ev, _receipt in replay(session, dags, events):
        walls.append(session.step().wall_ms)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    return {
        "events": len(events),
        "seconds": total_s,
        "ms_per_event": total_s * 1e3 / len(events),
        "step_wall_ms_median": statistics.median(walls),
        "step_wall_ms_sum": sum(walls),
        "memory_reserved_bytes": torch.cuda.memory_reserved(),
        "capture": _capture_stats(backend),
    }


PATHS = {"stream": stream_path, "session": session_path, "rw1": rw1_path}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16384)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--eager", action="store_true", help="TorchBackend(capture=False)")
    parser.add_argument("--paths", default="stream,session,rw1")
    parser.add_argument("--src", default=os.path.join(HERE, "..", "src"),
                        help="the src directory of the checkout whose port runs")
    parser.add_argument("--out", default="chiprun_out/torch_step_profile.json")
    args = parser.parse_args()
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        parser.error(f"unknown paths {sorted(unknown)}; choose from {sorted(PATHS)}")
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    report = {"card": card, "src": os.path.abspath(args.src), "eager": args.eager,
              "batch": args.batch, "steps": args.steps}
    mode = "eager" if args.eager else "default"
    print(f"card: {card}; port {report['src']} ({mode}), base_batch {args.batch}")
    for name in paths:
        report[name] = PATHS[name](args)
    if "stream" in report:
        s = report["stream"]
        for label in ("first_step", "second_step", "steady"):
            r = s[label]
            print(f"stream {label}: wall median {r['step_wall_ms_median']:.3f} ms, device busy "
                  f"{r['device_busy_ms_per_step']:.3f} ms, idle share {r['device_idle_share']:.3f}, "
                  f"{r['host_launch_calls_per_step']:.0f} host launch calls "
                  f"({r['graph_launches_per_step']:.0f} graph launches), "
                  f"{r['card_operations_per_step']:.0f} operations on the card per step")
        print(f"stream steady step wall without the profiler: median "
              f"{s['step_wall_ms_unprofiled_median']:.3f} ms over {args.steps} steps, idle share "
              f"{s['steady']['device_idle_share_unprofiled']:.3f}; {s['segments']} segments")
        for k in s["steady"]["top_on_card"]:
            print(f"  {k['device_ms_per_step']:9.3f} ms  x{k['count_per_step']:6.1f}  {k['name']}")
        for label in ("first_step", "second_step", "steady"):
            for name, ms in list(s[label]["host_ms_per_step_by_task_type"].items())[:8]:
                print(f"  {label} host {ms:9.3f} ms  {name}")
    if "session" in report:
        s = report["session"]
        print(f"session: script step walls median {s['script_step_wall_ms_median']:.3f} ms, "
              f"steady median {s['steady_step_wall_ms_median']:.3f} ms")
    if "rw1" in report:
        s = report["rw1"]
        print(f"rw1: {s['events']} events in {s['seconds']:.2f} s ({s['ms_per_event']:.2f} ms an "
              f"event, step wall median {s['step_wall_ms_median']:.3f} ms), memory_reserved "
              f"{s['memory_reserved_bytes'] / 2**30:.2f} GiB")
    for name in paths:
        cap = report[name]["capture"]
        if cap is not None and cap["capture_ms"]:
            ms = cap["capture_ms"]
            print(f"{name} capture: {cap['graphs']} graphs, capture ms median "
                  f"{statistics.median(ms):.3f} (total {sum(ms):.1f}), {cap['eager_steps']} eager "
                  f"segment steps, {cap['replays']} replays, pools {cap['pool_bytes'] / 2**20:.1f} MiB")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
