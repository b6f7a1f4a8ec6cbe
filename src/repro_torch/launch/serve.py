"""Serving entry point of the port, on the card by default.

Front-end daemon mode (the reference's subcommands): a
:class:`~repro_torch.serve.ServeFrontend` over a ``ReuseSession`` whose
dataflows step on the card (``--backend torch``, the default; ``--device
cpu`` for the CPU; ``--backend dryrun`` is the reference's default, the
cost model alone):

    PYTHONPATH=src python -m repro_torch.launch.serve start --port 7421 --slots 64
    PYTHONPATH=src python -m repro_torch.launch.serve submit --port 7421 \\
        --tenant alice --workload opmw --count 5
    PYTHONPATH=src python -m repro_torch.launch.serve status --port 7421 --stats
    PYTHONPATH=src python -m repro_torch.launch.serve stop --port 7421

Model mode (no subcommand; the reference's ``serve_model``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b

Every architecture serves: the dense family (granite, nemotron, qwen1.5,
qwen3), the moe family (mixtral; deepseek-v2 with MLA), the vlm family
(llama-3.2-vision), the ssm family (xlstm), the hybrid family (zamba2)
and the audio family (seamless). Random weights from a seeded
``torch.Generator`` on the serving device; from
``numpy.random.default_rng(0)`` in the reference's order, per request, a
prompt length of 4–11, the prompt and, for vlm and audio, a standard
normal memory of ``num_image_tokens`` or ``encoder_seq`` positions, so the
requests are the reference CLI's. Without ``--device cpu`` it needs a CUDA
device and raises when there is none.

Reuse mode (the reference's ``serve_reuse``): ``--tenants`` LM pipelines
over the ``urban``/``meter``/``taxi`` request streams through
:class:`~repro_torch.serve.ReuseServing` on the ``torch`` backend, each
sharing 3 of 4 backbone stages with the tenants of its stream, run for
``--ticks`` steps; it prints the reference's ``tenants=... running_tasks=...
deployed_cost=...`` line and each tenant's sink digests:

    PYTHONPATH=src python -m repro_torch.launch.serve --reuse --tenants 6
    PYTHONPATH=src python -m repro_torch.launch.serve --reuse --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import configs
from ..models import init_params
from ..serve.engine import Request, ServeEngine

_SUBCOMMANDS = ("start", "submit", "status", "stop")


def serving_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on the CPU")
    return dev


def serve_model(args) -> int:
    dev = serving_device(args.device)
    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12)).astype(np.int32)
        mem = (rng.standard_normal((eng.mem_len, cfg.d_model)).astype(np.float32)
               if eng.mem_len else None)
        eng.submit(Request(rid, prompt, max_new=args.max_new, memory=mem))
    results = eng.run()
    for r in sorted(results, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{r.prompt_len}] → {r.tokens}")
    print(f"served {len(results)} requests")
    return 0


def serve_reuse(args) -> int:
    from repro_torch.serve import ReuseServing, TenantPipeline

    rs = ReuseServing(strategy="signature", base_batch=args.slots,
                      device=serving_device(args.device))
    for i in range(args.tenants):
        rs.add_tenant(
            TenantPipeline(
                tenant=f"tenant{i}",
                stream=("urban", "meter", "taxi")[i % 3],
                shared_stages=3,
                n_stages=4,
                d=64,
                layers_per_stage=4,
            )
        )
    rs.run(args.ticks)
    s = rs.stats()
    print(f"tenants={s['tenants']} running_tasks={s['running_tasks']} "
          f"deployed_cost={s['deployed_cost']:.1f}")
    for t in list(rs.tenants):
        print(t, rs.tenant_output(t))
    rs.system.close()
    return 0


def model_main(argv) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", help="the reduced config of --arch")
    ap.add_argument("--reuse", action="store_true", help="multi-tenant reuse-serving")
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve_reuse(args) if args.reuse else serve_model(args)


# -- front-end daemon mode -------------------------------------------------------


def _addr_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)


def cmd_start(argv) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve start")
    _addr_args(ap)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--backend", default=None,
                    help="torch (default), multiproc, sharded or dryrun; with --restore, "
                         "the checkpointed backend unless set")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for the torch and multiproc backends")
    ap.add_argument("--strategy", default="signature")
    ap.add_argument("--max-slots", type=int, default=64, help="per-tenant slot quota")
    ap.add_argument("--max-pending", type=int, default=16, help="per-tenant queue depth")
    ap.add_argument("--retry-after", type=float, default=0.5)
    ap.add_argument("--defrag-every", type=int, default=None,
                    help="defragment after every N removals")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--restore", action="store_true",
                    help="restore session + ledgers from --checkpoint-dir")
    ap.add_argument("--step-interval", type=float, default=None,
                    help="step the data plane every S seconds while serving")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text over plain HTTP at /metrics "
                         "on this port (0 picks a free one)")
    ap.add_argument("--log-file", default=None)
    args = ap.parse_args(argv)

    import logging
    import threading

    from repro_torch.serve.frontend import ServeFrontend, TenantQuota

    if args.log_file:
        logging.basicConfig(
            filename=args.log_file,
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    quota = TenantQuota(max_slots=args.max_slots, max_pending=args.max_pending)
    backend = args.backend or ("torch" if not args.restore else None)
    # the backends that place their data plane on one device take --device
    placed = {"device": args.device} if (backend or "torch") in ("torch", "multiproc") else {}
    if args.restore:
        if not args.checkpoint_dir:
            ap.error("--restore needs --checkpoint-dir")
        if backend is not None:
            placed["backend"] = backend
        frontend = ServeFrontend.restore(
            args.checkpoint_dir,
            **placed,
            slots=args.slots,
            default_quota=quota,
            retry_after=args.retry_after,
            defrag_every=args.defrag_every,
            host=args.host,
            port=args.port,
            metrics_port=args.metrics_port,
        )
    else:
        frontend = ServeFrontend(
            slots=args.slots,
            strategy=args.strategy,
            backend=backend,
            **placed,
            default_quota=quota,
            retry_after=args.retry_after,
            defrag_every=args.defrag_every,
            host=args.host,
            port=args.port,
            metrics_port=args.metrics_port,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
        )
    host, port = frontend.start()
    print(f"serving on {host}:{port}", flush=True)
    if frontend._metrics_sock is not None:
        mhost, mport = frontend._metrics_sock.getsockname()[:2]
        print(f"metrics on http://{mhost}:{mport}/metrics", flush=True)

    stepper = None
    if args.step_interval:
        def _step_loop() -> None:
            while not frontend._shutdown_event.wait(args.step_interval):
                try:
                    frontend.step()
                except Exception:  # pragma: no cover - daemon resilience
                    logging.getLogger(__name__).exception("background step failed")

        stepper = threading.Thread(target=_step_loop, name="serve-stepper", daemon=True)
        stepper.start()
    try:
        frontend.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        frontend.close()
    return 0


def _workload(name: str):
    if name == "opmw":
        from repro_torch.workloads import opmw_workload

        return opmw_workload()
    if name == "riot":
        from repro_torch.workloads import riot_workload

        return riot_workload()
    raise SystemExit(f"unknown workload {name!r} (expected opmw or riot)")


def cmd_submit(argv) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve submit")
    _addr_args(ap)
    ap.add_argument("--tenant", required=True)
    ap.add_argument("--workload", default="opmw", help="opmw | riot")
    ap.add_argument("--count", type=int, default=1, help="dataflows to submit")
    ap.add_argument("--offset", type=int, default=0, help="skip the first N pool dataflows")
    ap.add_argument("--wait", action="store_true", help="sleep out RETRY_AFTER backpressure")
    args = ap.parse_args(argv)

    from repro_torch.serve.client import ServeClient, SubmitTimeout
    from repro_torch.workloads import tenant_copy

    pool = _workload(args.workload)
    picks = pool[args.offset: args.offset + args.count]
    if len(picks) < args.count:
        raise SystemExit(
            f"workload {args.workload!r} has {len(pool)} dataflows; "
            f"--offset {args.offset} --count {args.count} overruns it"
        )
    rc = 0
    with ServeClient((args.host, args.port)) as client:
        for df in picks:
            try:
                result = client.submit(
                    args.tenant, tenant_copy(df, args.tenant), wait=args.wait
                )
            except SubmitTimeout as e:
                print(json.dumps({"status": "TIMEOUT", "error": str(e)}), flush=True)
                rc = 1
                continue
            print(json.dumps(result), flush=True)
            if result.get("status") not in ("ADMITTED", "QUEUED"):
                rc = 1
    return rc


def cmd_status(argv) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve status")
    _addr_args(ap)
    ap.add_argument("--stats", action="store_true", help="include per-tenant ledgers")
    ap.add_argument("--tenant", default=None)
    args = ap.parse_args(argv)

    from repro_torch.serve.client import ServeClient

    with ServeClient((args.host, args.port)) as client:
        out = client.stats(args.tenant) if args.stats or args.tenant else client.status()
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_stop(argv) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve stop")
    _addr_args(ap)
    ap.add_argument("--no-drain", action="store_true", help="skip the final fair-share drain")
    ap.add_argument("--no-checkpoint", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.serve.client import ServeClient

    with ServeClient((args.host, args.port)) as client:
        if not args.no_drain:
            client.drain()
        out = client.shutdown(checkpoint=not args.no_checkpoint)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _SUBCOMMANDS:
        handler = {
            "start": cmd_start,
            "submit": cmd_submit,
            "status": cmd_status,
            "stop": cmd_stop,
        }[argv[0]]
        return handler(argv[1:])
    return model_main(argv)


if __name__ == "__main__":
    sys.exit(main())
