#!/usr/bin/env python3
"""Where a step of the port's worker-process plane spends its time, on the card.

Runs ``chip_smoke.py``'s stream script (the 21 RIoT dataflows plus the
kernel flows at ``--batch`` events per source: 3 steps, ``fuse()`` with
every chain accepted, 2 steps) on each configuration of ``--configs``,
one system each, then ``--steps`` steady steps:

  * ``torch-sync``, ``torch-concurrent``: the in-process torch backend;
  * ``mpN-sync``: ``backend="multiproc"`` over shm with N workers in sync
    mode, one RPC a segment; ``mpN-sync-chain`` the same with one
    ``step_chain`` RPC a worker; ``mpN-concurrent-chain`` concurrent mode
    with chain batching (one RPC a worker); a ``-supervised`` suffix
    (``mp2-sync-supervised``) arms the worker supervisor (``supervise=True``:
    spill snapshots each step, heartbeats) and reports the workers' spill
    ms a step.

With ``--turns N`` every configuration is built first and their steady
steps are taken in N rounds of ``--steps`` steps, the order reversed each
round, so two configurations (``--configs mp2-sync,mp2-sync-supervised``)
are compared in one call with less drift between them; the turns' walls
are reported beside each configuration's own window.

For each: the steady step wall (median, min, max); for the multiproc
ones also the workers' own segment ms summed over a step, the RPCs and
MiB published a step, and then, with the workers' tracers armed
(``configure_obs(trace=True)``) for ``--steps`` more steps, the ms a step
the workers spent in each phase of their segments' steps (``fetch``: the
boundary batches from the ring through pinned staging to the card;
``step``: the graph replays issued; ``wait``: the copies back to pinned
memory and the synchronize; ``publish``: the numpy batches into the ring)
and the coordinator's ms a step inside its step RPCs (summed over its
dispatch threads). ``mp1-sync`` against
``mp2-sync`` shows what a second process on the card costs each segment.

Needs a CUDA device. Prints each line with the card's name and power
limit, and writes JSON to ``--out``. Run from the repository root:
``python3 scripts/torch_worker_profile.py``.
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
PHASES = ("fetch", "step", "wait", "publish")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def build_system(config: str, batch: int):
    import torch

    from repro_torch.runtime.system import StreamSystem
    from repro_torch.runtime.worker import MultiprocBackend

    dev = torch.device("cuda", 0)
    if config.startswith("torch-"):
        return StreamSystem(base_batch=batch, device=dev, step_mode=config.split("-")[1])
    name, mode, *rest = config.split("-")
    workers = int(name[2:])
    backend = MultiprocBackend(workers=workers, transport="shm", chain_batching="chain" in rest,
                               device=str(dev))
    return StreamSystem(backend=backend, base_batch=batch, step_mode=mode,
                        max_workers=max(workers, 2), supervise="supervised" in rest)


def prepare(config: str, batch: int):
    """The configuration's system after the stream script."""
    import torch

    from repro_torch.workloads import kernel_flows, riot_workload

    system = build_system(config, batch)
    for df in riot_workload() + kernel_flows():
        system.submit(df)
    system.run(3)
    system.fuse(overhead_ms=1e9)  # every chain, as the in-process backend accepts
    system.run(2)
    torch.cuda.synchronize()
    return system


def summary(walls) -> dict:
    return {"median": statistics.median(walls), "min": min(walls), "max": max(walls)}


def profile(config: str, system, steps: int) -> dict:
    backend = system.backend
    multiproc = hasattr(backend, "transport")
    if multiproc:
        pub0 = backend.transport.counters()["bytes_published"]
        rpc0 = sum(backend._m_rpcs._values.values())
    reports = system.run(steps)
    walls = [r.wall_ms for r in reports]
    out = {"config": config, "segments": len(backend.segments), "wall_ms": summary(walls)}
    health = system.worker_health()
    if health and health.get("supervised"):
        out["spill_ms_per_step"] = health["spill_ms_per_step"]
    if multiproc:
        out["worker_segment_ms"] = statistics.median(sum(r.segment_ms.values()) for r in reports)
        out["mib_published"] = (backend.transport.counters()["bytes_published"] - pub0) / steps / 2**20
        out["rpcs"] = (sum(backend._m_rpcs._values.values()) - rpc0) / steps
        system.configure_obs(trace=True)
        system.drain_spans()
        system.run(steps)
        spans = system.drain_spans()
        phases = {p: 0.0 for p in PHASES}
        rpc_ms = 0.0
        for sp in spans:
            if sp["name"] in phases and sp["cat"] in ("transport", "segment"):
                phases[sp["name"]] += sp["dur"] / 1e3
            elif sp["cat"] == "rpc" and sp["name"].startswith("rpc:step"):
                rpc_ms += sp["dur"] / 1e3  # the step RPCs, not the drains' scrapes
        out["phase_ms"] = {p: ms / steps for p, ms in phases.items()}
        out["rpc_ms"] = rpc_ms / steps
    system.close()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16384)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--configs", default="torch-sync,torch-concurrent,mp1-sync,mp2-sync,"
                                             "mp2-sync-chain,mp4-concurrent-chain")
    parser.add_argument("--turns", type=int, default=0,
                        help="build every configuration, then step them in this many rounds")
    parser.add_argument("--out", default="chiprun_out/torch_worker_profile.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_worker_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    card = card_line()
    configs = args.configs.split(",")
    systems, turns = {}, {}
    if args.turns:
        for config in configs:
            systems[config] = prepare(config, args.batch)
            turns[config] = []
        for rnd in range(args.turns):
            for config in (configs if rnd % 2 == 0 else configs[::-1]):
                torch.cuda.synchronize()
                turns[config] += [r.wall_ms for r in systems[config].run(args.steps)]
    results = []
    for config in configs:
        t0 = time.perf_counter()
        system = systems.pop(config) if config in systems else prepare(config, args.batch)
        r = profile(config, system, args.steps)
        r["seconds"] = time.perf_counter() - t0
        results.append(r)
        line = (f"{config} ({card}): {r['segments']} segments, steady step wall ms median "
                f"{r['wall_ms']['median']:.3f} (min {r['wall_ms']['min']:.3f}, max "
                f"{r['wall_ms']['max']:.3f})")
        if config in turns:
            r["turns_wall_ms"] = summary(turns[config])
            line += (f"; in {args.turns} turns of {args.steps} steps median "
                     f"{r['turns_wall_ms']['median']:.3f} (min {r['turns_wall_ms']['min']:.3f}, "
                     f"max {r['turns_wall_ms']['max']:.3f})")
        if "spill_ms_per_step" in r:
            line += f"; the workers' spill ms a step {r['spill_ms_per_step']}"
        if "rpcs" in r:
            per = r["worker_segment_ms"] / r["segments"]
            line += (f"; workers' segment ms summed {r['worker_segment_ms']:.3f} a step ({per:.3f} a "
                     f"segment), {r['rpcs']:.1f} RPCs and {r['mib_published']:.2f} MiB published a "
                     f"step; traced, ms a step: " + ", ".join(
                         f"{p} {ms:.3f}" for p, ms in r["phase_ms"].items())
                     + f", inside the coordinator's step RPCs {r['rpc_ms']:.3f} (summed over "
                     f"its dispatch threads)")
        print(line, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "batch": args.batch, "steps": args.steps, "turns": args.turns,
                   "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
