"""The paper's trace-replay CLI on the port: replay an OPMW/RIoT
arrival-departure trace through the ExecutionBackend data plane behind
``repro_torch.api.ReuseSession``, on the card by default.

The port's copy of the trace mode (mode 2) of ``repro.launch.dryrun``;
its model-cell mode comes with the port's launch tools.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --trace opmw/rw1 \\
        [--backend torch|dryrun|multiproc|sharded] [--device cpu] \\
        [--steps-per-event 1] [--json out.json]

``--backend dryrun`` steps the cost model alone and gives the reference's
numbers; the default ``torch`` backend steps the dataflows on the card
(``--device cpu`` on the CPU).

Trace mode is crash-recoverable: ``--checkpoint-dir DIR`` writes one
durable checkpoint every ``--checkpoint-every`` events (default 1), and
``--restore`` resumes an interrupted trace from the newest valid
checkpoint — the control-plane journal length tells the CLI how many
events were already applied, so the replay continues exactly where the
crashed run stopped (``--max-events`` truncates a run, which is also how
the recovery tests simulate the crash):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --trace opmw/rw1 \\
        --checkpoint-dir /tmp/ckpts --max-events 40
    PYTHONPATH=src python -m repro_torch.launch.dryrun --trace opmw/rw1 \\
        --checkpoint-dir /tmp/ckpts --restore

The cluster plane's chaos smoke (``--backend multiproc``): ``--supervise``
arms worker supervision, ``--autoscale MIN:MAX`` the autoscaler, and
``--kill-worker-at N`` SIGKILLs a worker after trace event N; the replay
must still complete.
"""
import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional


def run_dataflow_trace(
    spec: str,
    backend: Optional[str] = None,
    strategy: str = "signature",
    device: Optional[str] = None,
    steps_per_event: int = 1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep_last: Optional[int] = None,
    checkpoint_background: bool = False,
    restore: bool = False,
    max_events: Optional[int] = None,
    step_mode: Optional[str] = None,
    max_workers: Optional[int] = None,
    transport: Optional[str] = None,
    workers: Optional[int] = None,
    supervise: bool = False,
    autoscale: Optional[Dict[str, Any]] = None,
    kill_worker_at: Optional[int] = None,
    kill_worker: int = 0,
    trace_out: Optional[str] = None,
    metrics_out: Optional[str] = None,
) -> Dict[str, Any]:
    """Replay ``workload/trace`` (e.g. ``opmw/rw1``) on an ExecutionBackend.

    With ``checkpoint_dir`` the session checkpoints durably every
    ``checkpoint_every`` events (pruned to the newest
    ``checkpoint_keep_last`` valid ones when set); ``restore=True`` resumes
    from the newest valid checkpoint, skipping the events the crashed run
    already applied (one journal op per trace event, so the journal length
    *is* the resume offset). ``max_events`` truncates the replay — the
    crash simulator. ``step_mode="concurrent"`` steps the deployment
    through the dependency-aware wave pipeline (on the dry-run backend the
    per-step ``makespan_ms`` then models concurrent wall-clock: wave max,
    not wave sum).

    ``backend=None`` steps on the port's ``torch`` backend (or, with
    ``restore``, the checkpointed one); ``device`` places a torch or
    multiproc data plane (the card unless ``"cpu"``); ``backend="dryrun"``
    gives the reference's cost-model numbers.

    Cluster-plane knobs (``backend="multiproc"`` only): ``supervise``
    arms self-healing worker supervision, ``autoscale`` passes
    :class:`~repro_torch.cluster.AutoscalePolicy` kwargs, and
    ``kill_worker_at=N`` SIGKILLs worker ``kill_worker`` after trace
    event ``N`` — the CI chaos smoke: the supervisor must recover it and
    the replay must still complete.

    The record is the reference's, plus ``sink_counts``: each running
    dataflow's sink event counts at the end of the replay.

    Telemetry (``repro_torch.obs``): ``trace_out=PATH`` arms span tracing and
    writes a Chrome/Perfetto trace of the whole replay;
    ``metrics_out=PATH`` writes one final Prometheus text scrape. Both
    export before the session closes so multiproc worker spans/metrics
    are harvested over RPC.
    """
    from repro_torch.api import ReuseSession
    from repro_torch.workloads import (
        opmw_workload,
        replay,
        riot_workload,
        rw_trace,
        seq_trace,
    )

    workload, _, trace = spec.partition("/")
    makers = {"opmw": opmw_workload, "riot": riot_workload}
    if workload not in makers or trace not in ("seq", "rw1", "rw2"):
        raise SystemExit(f"--trace must be {{opmw,riot}}/{{seq,rw1,rw2}}, got {spec!r}")
    dags = makers[workload]()
    seeds = {"seq": 3, "rw1": 11, "rw2": 23}
    events = (
        seq_trace(dags, seed=seeds[trace])
        if trace == "seq"
        else rw_trace(dags, seed=seeds[trace])
    )

    # the backends that place their data plane on one device take device=
    named = backend or ("torch" if not restore else None)
    placed = {"device": device} if device is not None and named in (
        "torch", "multiproc", None) else {}
    resumed_at = 0
    if restore:
        if not checkpoint_dir:
            raise SystemExit("--restore needs --checkpoint-dir")
        # backend=None honors the checkpointed backend; an explicit
        # --backend requests a cross-backend restore (torch ⇄ dryrun).
        # Likewise step_mode=None resumes in the checkpointed mode and an
        # explicit --step-mode restores a sync checkpoint into the
        # concurrent pipeline (or back) — the dependency DAG is rebuilt.
        session = ReuseSession.restore(
            checkpoint_dir,
            backend=backend,
            step_mode=step_mode,
            max_workers=max_workers,
            checkpoint_keep_last=checkpoint_keep_last,
            checkpoint_background=checkpoint_background or None,
            transport=transport,
            workers=workers,
            supervise=supervise,
            autoscale=autoscale,
            **placed,
        )
        resumed_at = len(session.manager.journal)  # events already applied
    else:
        session = ReuseSession(
            strategy=strategy,
            execute=True,
            backend=named,
            checkpoint_dir=checkpoint_dir,
            checkpoint_keep_last=checkpoint_keep_last if checkpoint_dir else None,
            checkpoint_background=(checkpoint_background or None) if checkpoint_dir else None,
            step_mode=step_mode,
            max_workers=max_workers,
            transport=transport,
            workers=workers,
            supervise=supervise,
            autoscale=autoscale,
            **placed,
        )
    if trace_out:
        session.enable_tracing()
    todo = events[resumed_at:]
    if max_events is not None:
        todo = todo[: max(0, max_events - resumed_at)]
    live, paused, cost, makespan = [], [], [], []
    t0 = time.time()
    # close() even on a failing replay: it flushes background checkpoints
    # and stops worker processes / shm session dirs (a crashed multiproc
    # trace must not leak orphan workers into the CI runner)
    try:
        for i, _ in enumerate(replay(session, dags, todo)):
            if kill_worker_at is not None and i == kill_worker_at:
                import signal

                be = session._system.backend
                victim = kill_worker % max(getattr(be, "n_workers", 1), 1)
                os.kill(be._procs[victim].pid, signal.SIGKILL)
            report = None
            for _ in range(steps_per_event):
                report = session.step()
            if report is None:  # steps_per_event=0: account without stepping
                l, p, c = session._system.backend.account()
                m = 0.0
            else:
                l, p, c = report.live_tasks, report.paused_tasks, report.cost
                m = report.makespan_ms
            live.append(l)
            paused.append(p)
            cost.append(round(c, 4))
            makespan.append(round(m, 4))
            # Checkpoint on event boundaries (not raw steps) so a restore
            # resumes exactly at the next un-applied trace event.
            if checkpoint_dir and (i + 1) % max(1, checkpoint_every) == 0:
                session.checkpoint()
        backend_obj = session._system.backend
        record_step_mode = backend_obj.step_mode
        transport_name = getattr(getattr(backend_obj, "transport", None), "name", None)
        workers_n = getattr(backend_obj, "n_workers", None)
        backend_name = session.backend_name
        strategy_name = session.strategy
        health = session.worker_health()
        # the sinks of the dataflows still running: what a killed and
        # recovered worker must not have changed
        sink_counts = {
            name: {s: int(d["count"]) for s, d in session.sink_digests(name).items()}
            for name in sorted(session.manager.submitted)
        }
        trace_spans = None
        if trace_out:
            trace_spans = session.export_chrome_trace(trace_out)
        if metrics_out:
            text = session.prometheus_text()
            os.makedirs(os.path.dirname(metrics_out) or ".", exist_ok=True)
            with open(metrics_out, "w") as f:
                f.write(text)
    finally:
        session.close()
    return {
        "trace_out": trace_out,
        "trace_spans": trace_spans,
        "metrics_out": metrics_out,
        "trace": spec,
        "backend": backend_name,
        "strategy": strategy_name,
        "step_mode": record_step_mode,
        "transport": transport_name,
        "workers": workers_n,
        "events": len(events),
        "events_applied": resumed_at + len(todo),
        "resumed_at_event": resumed_at,
        "wall_s": round(time.time() - t0, 3),
        "peak_live_tasks": max(live) if live else 0,
        "peak_paused_tasks": max(paused) if paused else 0,
        "peak_cores": max(cost) if cost else 0.0,
        "peak_makespan_ms": max(makespan) if makespan else 0.0,
        "worker_health": health,
        "sink_counts": sink_counts,
        "series": {
            "live_tasks": live,
            "paused_tasks": paused,
            "cores": cost,
            "makespan_ms": makespan,
        },
    }


def _parse_autoscale(spec: Optional[str]) -> Optional[Dict[str, Any]]:
    """``"MIN:MAX"`` -> AutoscalePolicy kwargs (None passes through)."""
    if not spec:
        return None
    try:
        lo, _, hi = spec.partition(":")
        return {"min_workers": int(lo), "max_workers": int(hi)}
    except ValueError:
        raise SystemExit(f"--autoscale wants MIN:MAX (e.g. 1:4), got {spec!r}") from None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--trace", required=True,
                    help="dataflow-trace mode: {opmw,riot}/{seq,rw1,rw2}")
    ap.add_argument(
        "--backend", default=None,
        help="ExecutionBackend for --trace (default: torch; with --restore, "
        "the checkpointed backend unless set explicitly)",
    )
    ap.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu, for the torch and multiproc backends",
    )
    ap.add_argument("--strategy", default="signature", help="merge strategy for --trace")
    ap.add_argument("--steps-per-event", type=int, default=1)
    ap.add_argument("--checkpoint-dir", help="durable checkpoints for --trace mode")
    ap.add_argument(
        "--checkpoint-every", type=int, default=1,
        help="checkpoint cadence in trace events (with --checkpoint-dir)",
    )
    ap.add_argument(
        "--checkpoint-keep-last", type=int, default=None,
        help="retain only the newest N valid checkpoints (GC; torn files reaped)",
    )
    ap.add_argument(
        "--restore", action="store_true",
        help="resume the trace from the newest valid checkpoint in --checkpoint-dir",
    )
    ap.add_argument(
        "--step-mode", choices=("sync", "concurrent"), default=None,
        help="data-plane stepping pipeline for --trace (default: sync; "
        "with --restore, the checkpointed mode unless set explicitly)",
    )
    ap.add_argument(
        "--max-workers", type=int, default=None,
        help="dispatch width for --step-mode concurrent (threads on the CPU, "
        "CUDA streams on the card)",
    )
    ap.add_argument(
        "--transport", choices=("inproc", "shm", "tcp"), default=None,
        help="stream transport for --trace (default: the backend's own; "
        "multiproc defaults to shm)",
    )
    ap.add_argument(
        "--workers", type=int, default=None,
        help="worker-process pool size for --backend multiproc",
    )
    ap.add_argument(
        "--supervise", action="store_true",
        help="arm the cluster plane on --backend multiproc: heartbeat "
        "supervision, crash/hang recovery, shadow-snapshot redeploys",
    )
    ap.add_argument(
        "--autoscale", default=None, metavar="MIN:MAX",
        help="EWMA-driven worker-pool autoscaling bounds for --backend "
        "multiproc (e.g. 1:4)",
    )
    ap.add_argument(
        "--kill-worker-at", type=int, default=None, metavar="EVENT",
        help="chaos smoke: SIGKILL --kill-worker after trace event N "
        "(pair with --supervise; the run must still complete)",
    )
    ap.add_argument(
        "--kill-worker", type=int, default=0,
        help="which worker --kill-worker-at kills (default 0)",
    )
    ap.add_argument(
        "--checkpoint-background", action="store_true",
        help="write checkpoints on a background thread (snapshot on the "
        "stepping thread, encode/fsync/rename off-thread)",
    )
    ap.add_argument(
        "--max-events", type=int, default=None,
        help="stop the trace after N events (crash simulation / smoke)",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="arm span tracing and write a Chrome/Perfetto trace of the "
        "replay (load in chrome://tracing or ui.perfetto.dev)",
    )
    ap.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write one final Prometheus text scrape of the telemetry "
        "registry when the trace completes",
    )
    ap.add_argument("--json", help="write the trace record to this path")
    args = ap.parse_args(argv)

    rec = run_dataflow_trace(
        args.trace,
        backend=args.backend,
        strategy=args.strategy,
        device=args.device,
        steps_per_event=args.steps_per_event,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        checkpoint_keep_last=args.checkpoint_keep_last,
        checkpoint_background=args.checkpoint_background,
        restore=args.restore,
        max_events=args.max_events,
        step_mode=args.step_mode,
        max_workers=args.max_workers,
        transport=args.transport,
        workers=args.workers,
        supervise=args.supervise,
        autoscale=_parse_autoscale(args.autoscale),
        kill_worker_at=args.kill_worker_at,
        kill_worker=args.kill_worker,
        trace_out=args.trace_out,
        metrics_out=args.metrics_out,
    )
    summary = {k: v for k, v in rec.items() if k != "series"}
    print(json.dumps(summary, indent=2))
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
