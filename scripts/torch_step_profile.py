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
    each of its 156 events; ms per step;
  * **modes**: the stream path's script (3 steps, ``fuse()``, 2 steps) in
    sync mode and in concurrent mode at ``max_workers`` 1, 4 and None, one
    system each, then ``--steps`` steady steps of each in turns (sync, 1,
    4, None, None, 4, 1, sync): the step walls without the profiler and
    ``makespan_ms``, and under the profiler device busy (the union of the
    card's kernel, copy and fill intervals, so overlapping streams count
    once), the kernel time summed (its ratio to busy is the overlap), the
    idle share, host launch calls and operations on the card;
  * **obs**: the telemetry overhead, as ``benchmarks/obs_overhead_bench.py``
    measures the reference's: one stream system per plane of ``--obs``
    (``off``: ``configure_obs(metrics=False, trace=False)``; ``default``:
    the registry, no tracing; ``traced``: the registry and span tracing),
    ``--windows`` windows of ``--steps`` steps each in rotating order, the
    best window's ms per step per plane; the reference's bar is that
    ``default`` costs under 3% of ``off``;
  * **ablate**: the steady sync step's bookkeeping switched off piece by
    piece on one system, in ``--windows`` rotating windows of ``--steps``
    steps (best window and median per variant): ``full``; ``no metrics``
    (the registry off); ``no stragglers`` (no EWMA update); ``no broker
    locks`` (publish and fetch without locks, counters or wake-ups); ``no
    count lock`` (replays add their launches without the lock); ``all
    off``; and ``gc off`` (``full`` with the garbage collector disabled);
  * **host**: where the host's time of a steady fused step goes, by
    function: ``--steps`` steps under ``cProfile`` (which slows every
    Python call alike, so compare two checkouts with it, not with the
    plain walls), each function's own µs per step and calls per step, the
    same summed by source file, and the step wall under the profiler
    beside the µs spent waiting in ``synchronize``.

Each operator's ``apply`` is wrapped once (operators are shared between
structurally identical segments) in a ``record_function`` named after its
task type. Segments step through CUDA graphs after their first step
(``TorchBackend``'s default), and a ``record_function`` inside a capture
never fires on a replay, so the stream path's first step (the eager
warm-up of every segment) and its second (the captures) are profiled on
their own: host ms per task type come from those; the steady steps give
device busy ms, the idle share ``1 - busy / wall``, the operations the
card ran, and the host launch calls (of them graph launches) per step.
``--eager`` runs every path with ``TorchBackend(capture=False)``;
``--step-mode`` and ``--max-workers`` set the stepping of the stream,
session, rw1 and obs paths.

Prints, and writes as JSON to ``--out``. ``--src`` runs another
checkout's port (its ``src`` directory) with this script, to compare two
checkouts in one call; a port without step capture is eager by nature
(run it without ``--eager``).

Usage (on a machine with a CUDA device, from the repository root):
    python3 scripts/torch_step_profile.py [--batch 16384] [--steps 20] [--eager]
        [--step-mode sync|concurrent] [--max-workers N]
        [--paths stream,session,rw1,modes,obs,ablate,host] [--obs off,default,traced] [--windows 5]
        [--src <checkout>/src] [--out FILE]
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
    kernel_ms = sum(dev_us(e) for e in on_card) / 1e3 / steps
    # the union of their intervals: where streams overlap, the card is busy once
    spans = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if "CUDA" in str(ev.device_type) and not ev.name.startswith("op::")
    )
    union_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            union_us += end - max(start, reach)
            reach = end
    busy_ms = union_us / 1e3 / steps
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
        "device_kernel_ms_per_step": kernel_ms,
        "device_overlap": kernel_ms / busy_ms if busy_ms else 0.0,
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


def _backend(args, step_mode=None, max_workers=None):
    """A TorchBackend as the flags say; only the arguments that differ from
    the defaults are passed, so an older checkout's port (``--src``) runs
    in its default mode."""
    from repro_torch.runtime.executor import TorchBackend

    kw = {}
    if args.eager:
        kw["capture"] = False
    step_mode = step_mode or args.step_mode
    max_workers = max_workers if max_workers is not None else args.max_workers
    if step_mode != "sync":
        kw["step_mode"] = step_mode
    if max_workers is not None:
        kw["max_workers"] = max_workers
    return TorchBackend(**kw)


def _fused_stream_system(args, step_mode=None, max_workers=None):
    """The stream path's flows through 3 steps, ``fuse()`` and 2 steps (the
    fused segments' warm-up and capture): the steady state."""
    from repro_torch.runtime.system import StreamSystem
    from repro_torch.workloads import kernel_flows, riot_workload

    system = StreamSystem(backend=_backend(args, step_mode, max_workers), base_batch=args.batch)
    for df in riot_workload() + kernel_flows():
        system.submit(df)
    system.run(3)
    system.fuse()
    system.run(2)
    return system


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


MODES = (("sync", None), ("concurrent", 1), ("concurrent", 4), ("concurrent", None))


def _mode_label(mode, workers):
    return mode if mode == "sync" else f"concurrent, max_workers={workers}"


def modes_path(args):
    """Sync against concurrent at max_workers 1, 4 and None, in turns."""
    import torch

    systems = {_mode_label(m, w): _fused_stream_system(args, m, w) for m, w in MODES}
    out = {label: {"step_wall_ms": [], "makespan_ms": [], "profiled": []} for label in systems}
    for label in list(systems) + list(reversed(systems)):
        system = systems[label]
        torch.cuda.synchronize()
        reports = system.run(args.steps)
        out[label]["step_wall_ms"] += [r.wall_ms for r in reports]
        out[label]["makespan_ms"] += [r.makespan_ms for r in reports]
        out[label]["profiled"].append(_profiled(args.steps, system.step))
    for label, rec in out.items():
        prof = rec["profiled"]
        wall = statistics.median(rec["step_wall_ms"])
        busy = statistics.median(p["device_busy_ms_per_step"] for p in prof)
        rec.update({
            "segments": len(systems[label].backend.segments),
            "waves": [len(w) for w in systems[label].backend.segment_waves()],
            "step_wall_ms_median": wall,
            "makespan_ms_median": statistics.median(rec["makespan_ms"]),
            "device_busy_ms_per_step": busy,
            "device_kernel_ms_per_step": statistics.median(
                p["device_kernel_ms_per_step"] for p in prof),
            "device_idle_share_unprofiled": max(0.0, 1.0 - busy / wall),
            "host_launch_calls_per_step": prof[0]["host_launch_calls_per_step"],
            "graph_launches_per_step": prof[0]["graph_launches_per_step"],
            "card_operations_per_step": prof[0]["card_operations_per_step"],
            "capture": _capture_stats(systems[label].backend),
        })
        systems[label].close()
    return out


OBS_PLANES = {
    "off": {"metrics": False, "trace": False},
    "default": {"metrics": True, "trace": False},
    "traced": {"metrics": True, "trace": True},
}


def obs_path(args):
    """Telemetry overhead: the best window's ms per step of each plane."""
    import torch

    planes = args.obs.split(",")
    unknown = set(planes) - set(OBS_PLANES)
    if unknown:
        raise SystemExit(f"unknown --obs planes {sorted(unknown)}; choose from {sorted(OBS_PLANES)}")
    systems = {}
    for plane in planes:
        system = _fused_stream_system(args)
        system.configure_obs(**OBS_PLANES[plane])
        systems[plane] = system
    windows = {plane: [] for plane in planes}
    for w in range(args.windows):
        order = planes[w % len(planes):] + planes[:w % len(planes)]
        for plane in order:
            system = systems[plane]
            system.drain_spans()  # an empty ring: steady-state recording cost
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.run(args.steps)
            torch.cuda.synchronize()
            windows[plane].append((time.perf_counter() - t0) * 1e3 / args.steps)
    out = {"windows_ms_per_step": windows,
           "best_ms_per_step": {p: min(v) for p, v in windows.items()},
           "median_ms_per_step": {p: statistics.median(v) for p, v in windows.items()}}
    if "off" in planes:
        off = out["best_ms_per_step"]["off"]
        out["overhead_vs_off"] = {p: ms / off - 1.0 for p, ms in out["best_ms_per_step"].items()}
    for system in systems.values():
        system.close()
    return out


def _ablations(system):
    """name -> (switch off, switch back on) for the pieces of the sync step's
    bookkeeping, on ``system``'s backend; each leaves the state consistent,
    so the variants can take turns on one system."""
    import gc

    from repro_torch.kernels import build

    backend, broker = system.backend, system.backend.broker

    def metrics(on):
        backend.configure_obs(metrics=on)

    def stragglers(on):
        if on:
            del backend._update_stragglers
        else:
            backend._update_stragglers = lambda seg_ms: []

    def publish_bare(topic, batch):
        st = broker._topics.get(topic)
        if st is None:
            return type(broker).publish(broker, topic, batch)
        st.buffer = batch
        st.seq += 1

    def broker_locks(on):
        if on:
            del broker.publish, broker.fetch
        else:
            broker.publish = publish_bare
            broker.fetch = lambda topic, copy=False: broker._topics[topic].buffer

    add_launches = build.add_launches

    def add_bare(counts):
        for name, n in counts.items():
            build._launches[name] += n

    def count_lock(on):
        build.add_launches = add_launches if on else add_bare

    def collector(on):
        (gc.enable if on else gc.disable)()

    pieces = {"no metrics": [metrics], "no stragglers": [stragglers],
              "no broker locks": [broker_locks], "no count lock": [count_lock]}
    pieces["all off"] = [metrics, stragglers, broker_locks, count_lock]
    pieces["gc off"] = [collector]
    return pieces


def ablate_path(args):
    """The sync step's bookkeeping off piece by piece, on one system."""
    import torch

    system = _fused_stream_system(args, "sync")
    pieces = _ablations(system)
    variants = ["full"] + list(pieces)
    windows = {v: [] for v in variants}
    for w in range(args.windows):
        order = variants[w % len(variants):] + variants[:w % len(variants)]
        for variant in order:
            for switch in pieces.get(variant, ()):
                switch(False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.run(args.steps)
            torch.cuda.synchronize()
            windows[variant].append((time.perf_counter() - t0) * 1e3 / args.steps)
            for switch in pieces.get(variant, ()):
                switch(True)
    best = {v: min(ms) for v, ms in windows.items()}
    system.close()
    return {"windows_ms_per_step": windows, "best_ms_per_step": best,
            "median_ms_per_step": {v: statistics.median(ms) for v, ms in windows.items()},
            "saved_vs_full_ms": {v: best["full"] - ms for v, ms in best.items()}}


def host_path(args):
    """The steady fused step's host time by function, under cProfile."""
    import cProfile
    import pstats

    import torch

    system = _fused_stream_system(args)
    system.run(args.steps)  # steady before the profile
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    system.run(args.steps)
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    rows = []
    for (path, line, fn), (_cc, calls, own, cum, _callers) in pstats.Stats(prof).stats.items():
        where = f"{os.path.basename(path)}:{line}" if line else path
        rows.append({"function": f"{where}({fn})", "file": os.path.basename(path) or path,
                     "calls_per_step": calls / args.steps,
                     "own_us_per_step": own * 1e6 / args.steps,
                     "cum_us_per_step": cum * 1e6 / args.steps})
    rows.sort(key=lambda r: -r["own_us_per_step"])
    by_file = {}
    for r in rows:
        by_file[r["file"]] = by_file.get(r["file"], 0.0) + r["own_us_per_step"]
    waiting = sum(r["own_us_per_step"] for r in rows if "synchronize" in r["function"])
    getattr(system, "close", lambda: None)()  # an older checkout's system has none
    return {"step_wall_ms_profiled": wall_ms,
            "synchronize_us_per_step": waiting,
            "host_us_per_step_not_waiting": wall_ms * 1e3 - waiting,
            "python_calls_per_step": sum(r["calls_per_step"] for r in rows),
            "top_functions": rows[:40],
            "own_us_per_step_by_file": dict(sorted(by_file.items(), key=lambda kv: -kv[1]))}


PATHS = {"stream": stream_path, "session": session_path, "rw1": rw1_path, "modes": modes_path,
         "obs": obs_path, "ablate": ablate_path, "host": host_path}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16384)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--eager", action="store_true", help="TorchBackend(capture=False)")
    parser.add_argument("--step-mode", choices=("sync", "concurrent"), default="sync")
    parser.add_argument("--max-workers", type=int, default=None)
    parser.add_argument("--paths", default="stream,session,rw1")
    parser.add_argument("--obs", default="off,default,traced",
                        help="planes of the obs path: off, default, traced")
    parser.add_argument("--windows", type=int, default=5, help="timed windows per obs plane")
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
              "batch": args.batch, "steps": args.steps, "step_mode": args.step_mode,
              "max_workers": args.max_workers}
    mode = "eager" if args.eager else "default"
    print(f"card: {card}; port {report['src']} ({mode}, step_mode {args.step_mode}, max_workers "
          f"{args.max_workers}), base_batch {args.batch}")
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
    if "modes" in report:
        for label, r in report["modes"].items():
            print(f"modes, {label}: steady step wall median {r['step_wall_ms_median']:.3f} ms, "
                  f"makespan_ms median {r['makespan_ms_median']:.3f}, device busy "
                  f"{r['device_busy_ms_per_step']:.3f} ms (kernel time summed "
                  f"{r['device_kernel_ms_per_step']:.3f}), idle share "
                  f"{r['device_idle_share_unprofiled']:.3f}, {r['host_launch_calls_per_step']:.0f} "
                  f"host launch calls ({r['graph_launches_per_step']:.0f} graph launches), "
                  f"{r['card_operations_per_step']:.0f} operations on the card per step; waves "
                  f"{r['waves']}")
    if "obs" in report:
        r = report["obs"]
        for plane, ms in r["best_ms_per_step"].items():
            extra = ""
            if "overhead_vs_off" in r and plane != "off":
                extra = f", {100 * r['overhead_vs_off'][plane]:+.2f}% against off"
            print(f"obs, {plane}: best window {ms:.3f} ms per step (median "
                  f"{r['median_ms_per_step'][plane]:.3f}){extra}")
        if "overhead_vs_off" in r and "default" in r["overhead_vs_off"]:
            pct = 100 * r["overhead_vs_off"]["default"]
            print(f"obs: default telemetry {pct:+.2f}% of the off ms per step; the reference's "
                  f"bar is under 3% (benchmarks/obs_overhead_bench.py): "
                  f"{'within' if pct < 3.0 else 'OUTSIDE'} it")
    if "ablate" in report:
        r = report["ablate"]
        for variant, ms in r["best_ms_per_step"].items():
            print(f"ablate, {variant}: best window {ms:.3f} ms per step (median "
                  f"{r['median_ms_per_step'][variant]:.3f}), "
                  f"{1e3 * r['saved_vs_full_ms'][variant]:+.1f} us a step saved against full")
    if "host" in report:
        r = report["host"]
        print(f"host: step wall {r['step_wall_ms_profiled']:.3f} ms under cProfile, "
              f"{r['synchronize_us_per_step']:.1f} us a step waiting in synchronize, "
              f"{r['host_us_per_step_not_waiting']:.1f} us not waiting, "
              f"{r['python_calls_per_step']:.0f} profiled calls a step")
        for name, us in list(r["own_us_per_step_by_file"].items())[:14]:
            print(f"  host by file {us:9.1f} us/step  {name}")
        for f in r["top_functions"][:25]:
            print(f"  host {f['own_us_per_step']:9.1f} us/step own, {f['cum_us_per_step']:9.1f} cum, "
                  f"x{f['calls_per_step']:7.1f}  {f['function']}")
    for name in paths:
        if name in ("modes", "obs", "ablate", "host"):
            continue
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
