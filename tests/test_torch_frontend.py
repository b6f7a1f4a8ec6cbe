"""The port's multi-tenant front end (``repro_torch.serve``: ``ServeFrontend``,
its wire protocol and client, ``repro_torch.workloads.tenants`` and the
daemon subcommands of ``repro_torch.launch.serve``) against the reference's,
as ``tests/test_frontend.py`` holds the reference's.

  * The same request sequences (slot accounting, admission outcomes,
    quotas, backpressure, weighted fair-share drains, billing, the
    capacity trace) go to the reference's front end on ``dryrun`` and to
    the port's on ``dryrun`` and on ``torch`` (``device="cpu"``): the
    admission results, the ledgers, the queue order and the stats are the
    reference's.
  * Preview plans without committing; the wire protocol both ways (the
    reference's client against the port's server and the other way round),
    errors across the wire, shutdown, restart on the same port, client
    backoff.
  * Durability: ledgers, the queued submissions and the sink digests
    survive ``checkpoint``/``restore`` on both backends.
  * ``tenant_trace``/``tenant_copy`` equal the reference's; the daemon's
    ``start``/``submit``/``status``/``stop`` give the reference's ledgers
    on ``dryrun`` and run on ``torch --device cpu``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

import repro.api as ref_api
import repro.core as ref_core
import repro.serve as ref_serve
import repro.workloads as ref_workloads
import repro_torch.api as port_api
import repro_torch.core as port_core
import repro_torch.serve as port_serve
import repro_torch.workloads as port_workloads

ROOT = os.path.join(os.path.dirname(__file__), "..")

REF = SimpleNamespace(name="ref", serve=ref_serve, core=ref_core, api=ref_api,
                      workloads=ref_workloads, options={"backend": "dryrun"})
PORT_DRY = SimpleNamespace(name="port-dryrun", serve=port_serve, core=port_core, api=port_api,
                           workloads=port_workloads, options={"backend": "dryrun"})
PORT_TORCH = SimpleNamespace(name="port-torch", serve=port_serve, core=port_core, api=port_api,
                             workloads=port_workloads,
                             options={"backend": "torch", "device": "cpu"})
PORTS = [PORT_DRY, PORT_TORCH]


def frontend(pkg, **kwargs):
    kwargs.setdefault("slots", 32)
    for k, v in pkg.options.items():
        kwargs.setdefault(k, v)
    return pkg.serve.ServeFrontend(**kwargs)


def chain_df(pkg, name, source, chain, sink="store"):
    d = pkg.core.Dataflow(name)
    prev = d.add_task(pkg.core.Task.make(f"{name}.src.{source}", source, "SOURCE"))
    for i, (typ, cfg) in enumerate(chain):
        t = d.add_task(pkg.core.Task.make(f"{name}.{i}.{typ}", typ, cfg))
        d.add_stream(prev.id, t.id)
        prev = t
    snk = d.add_task(pkg.core.Task.make(f"{name}.sink.{sink}", sink, "SINK"))
    d.add_stream(prev.id, snk.id)
    return d


def fig1(pkg):
    pk = [("parse", {}), ("kalman", {"q": 0.1})]
    return (
        chain_df(pkg, "A", "urban", pk, "store_a"),
        chain_df(pkg, "B", "urban", pk + [("win", {"w": 10})], "store_b"),
        chain_df(pkg, "C", "urban", pk + [("win", {"w": 10}), ("avg", {})], "store_c"),
        chain_df(pkg, "D", "meter", pk, "store_d"),
    )


def cost_df(pkg, name, kind, n):
    """A chain costing exactly ``n`` slots, with kind-disjoint types."""
    return chain_df(pkg, name, f"{kind}_src",
                    [(f"{kind}_op{i}", {"k": i}) for i in range(n - 2)], sink=f"{kind}_sink")


def _quota(pkg, **kw):
    return pkg.serve.TenantQuota(**kw)


def _stats(fe):
    """The front end's stats without the backend's name; floats rounded."""
    out = json.loads(json.dumps(fe.stats()))
    out.pop("backend")
    for ledger in out["ledgers"].values():
        ledger["cost_total"] = round(ledger["cost_total"], 9)
    return out


# -- request sequences, each run against both packages ------------------------------
#
# Each takes the package and returns what a caller observes: admission
# results, remove() replies, the queue and the stats.


def s_reused_segments_cost_no_slots(pkg):
    fe = frontend(pkg)
    A, B, _, _ = fig1(pkg)
    log = [fe.submit("t1", A).to_json(), fe.submit("t2", B).to_json(), _stats(fe)]
    assert log[1]["slots_charged"] == len(B.tasks) - log[1]["reused"] and log[1]["reused"] > 0
    return fe, log


def s_identical_resubmission_is_free(pkg):
    fe = frontend(pkg)
    A = fig1(pkg)[0]
    log = [fe.submit("t1", A).to_json(), fe.submit("t2", A.copy("A2")).to_json()]
    assert log[1]["status"] == pkg.serve.protocol.ADMITTED and log[1]["slots_charged"] == 0
    return fe, log + [_stats(fe)]


def s_remove_frees_exactly_what_was_charged(pkg):
    fe = frontend(pkg)
    A, B, _, _ = fig1(pkg)
    log = [fe.submit("t1", A).to_json(), fe.submit("t1", B).to_json()]
    log.append(fe.remove("t1", "B"))
    assert log[-1]["slots_freed"] == log[1]["slots_charged"]
    return fe, log + [_stats(fe)]


def s_effective_capacity(pkg):
    fe = frontend(pkg)
    A = fig1(pkg)[0]
    fe.submit("t1", A)
    fe.submit("t2", A.copy("A2"))
    log = [_stats(fe)]
    fe.remove("t2", "A2")
    return fe, log + [_stats(fe)]


def s_quota_and_pool_and_duplicates_rejected(pkg):
    fe = frontend(pkg, slots=32, default_quota=_quota(pkg, max_slots=5))
    log = [fe.submit("t1", cost_df(pkg, "big", "a", 6)).to_json()]
    small = frontend(pkg, slots=4)
    log.append(small.submit("t1", cost_df(pkg, "big", "a", 6)).to_json())
    small.close()
    log.append(fe.submit("t1", cost_df(pkg, "x", "a", 3)).to_json())
    log.append(fe.submit("t1", cost_df(pkg, "x", "b", 3)).to_json())
    assert [r["status"] for r in log] == ["REJECTED", "REJECTED", "ADMITTED", "REJECTED"]
    return fe, log + [_stats(fe)]


def s_retry_after_then_resubmit(pkg):
    fe = frontend(pkg, slots=6, default_quota=_quota(pkg, max_slots=6, max_pending=0),
                  retry_after=0.25)
    log = [fe.submit("t1", cost_df(pkg, "block", "a", 6)).to_json(),
           fe.submit("t2", cost_df(pkg, "want", "b", 4)).to_json()]
    log.append(fe.remove("t1", "block"))
    log.append(fe.submit("t2", cost_df(pkg, "want", "b", 4)).to_json())
    assert [log[1]["status"], log[3]["status"]] == ["RETRY_AFTER", "ADMITTED"]
    return fe, log + [_stats(fe)]


def s_queue_admit_and_cancel(pkg):
    fe = frontend(pkg, slots=6, default_quota=_quota(pkg, max_slots=6, max_pending=4))
    log = [fe.submit("t1", cost_df(pkg, "block", "a", 6)).to_json(),
           fe.submit("t2", cost_df(pkg, "next", "b", 4)).to_json(),
           fe.submit("t3", cost_df(pkg, "gone", "c", 4)).to_json(),
           [p.df.name for p in fe._pending]]
    log.append(fe.remove("t3", "gone"))
    log.append(fe.remove("t1", "block"))
    assert [a["name"] for a in log[-1]["admitted"]] == ["next"]
    return fe, log + [dict(fe.tenant_of), _stats(fe)]


def s_zero_cost_when_saturated_and_draining(pkg):
    fe = frontend(pkg, slots=6)
    A = cost_df(pkg, "block", "a", 6)
    log = [fe.submit("t1", A).to_json(), fe.submit("t2", A.copy("free-rider")).to_json()]
    drained = fe.drain()
    log.append({k: drained[k] for k in ("ok", "admitted", "shed")})
    log.append(fe.submit("t1", cost_df(pkg, "late", "z", 3)).to_json())
    assert log[-1]["status"] == "REJECTED" and "draining" in log[-1]["reason"]
    return fe, log + [_stats(fe)]


def s_greedy_tenant_cannot_starve_light_one(pkg):
    fe = frontend(pkg, slots=9, default_quota=_quota(pkg, max_slots=9, max_pending=8))
    fe.submit("C", cost_df(pkg, "block", "c", 9))
    log = [fe.submit("A", cost_df(pkg, f"a{i}", f"a{i}", 3)).to_json() for i in range(5)]
    log.append(fe.submit("B", cost_df(pkg, "b0", "b0", 3)).to_json())
    out = fe.remove("C", "block")
    log.append(out)
    assert [a["name"] for a in out["admitted"]] == ["a0", "b0", "a1"]
    return fe, log + [[p.df.name for p in fe._pending], _stats(fe)]


def s_weights_scale_the_share(pkg):
    fe = frontend(pkg, slots=12, default_quota=_quota(pkg, max_slots=12, max_pending=8),
                  quotas={"B": _quota(pkg, max_slots=12, max_pending=8, weight=3.0)})
    fe.submit("C", cost_df(pkg, "block", "c", 12))
    for i in range(3):
        fe.submit("A", cost_df(pkg, f"a{i}", f"xa{i}", 3))
    for i in range(3):
        fe.submit("B", cost_df(pkg, f"b{i}", f"xb{i}", 3))
    out = fe.remove("C", "block")
    assert [a["name"] for a in out["admitted"]] == ["a0", "b0", "b1", "b2"]
    return fe, [out, [p.df.name for p in fe._pending], _stats(fe)]


def s_small_flow_fills_the_gap(pkg):
    fe = frontend(pkg, slots=8, default_quota=_quota(pkg, max_slots=8, max_pending=4))
    log = [fe.submit("t1", cost_df(pkg, "hold", "h", 5)).to_json(),
           fe.submit("t2", cost_df(pkg, "wide", "w", 4)).to_json(),
           fe.submit("t3", cost_df(pkg, "slim", "s", 3)).to_json()]
    assert [r["status"] for r in log] == ["ADMITTED", "QUEUED", "ADMITTED"]
    return fe, log + [_stats(fe)]


def s_billing(pkg):
    fe = frontend(pkg)
    A, B, _, _ = fig1(pkg)
    fe.submit("t1", A)
    fe.submit("t2", A.copy("A2"))
    fe.submit("t3", B)
    costs = [round(fe.step()["cost"], 9) for _ in range(3)]
    stats = _stats(fe)
    billed = sum(ledger["cost_total"] for ledger in stats["ledgers"].values())
    assert billed == pytest.approx(sum(costs), rel=1e-6)
    assert stats["ledgers"]["t1"]["cost_total"] == pytest.approx(
        stats["ledgers"]["t2"]["cost_total"])
    return fe, [costs, stats]


def s_capacity_trace(pkg):
    pool = pkg.workloads.opmw_workload()
    by_name = {d.name: d for d in pool}
    log = []
    for strategy in ("signature", "none"):
        fe = frontend(pkg, slots=64, strategy=strategy, defrag_every=32,
                      default_quota=_quota(pkg, max_slots=64, max_pending=4))
        for ev in pkg.workloads.tenant_trace(pool, ("a", "b"), events=150, seed=11):
            if ev.op == "add":
                log.append(fe.submit(
                    ev.tenant, pkg.workloads.tenant_copy(by_name[ev.pool_name], ev.tenant)
                ).to_json())
            elif ev.name in fe.tenant_of or any(p.df.name == ev.name for p in fe._pending):
                out = fe.remove(ev.tenant, ev.name)
                log.append({k: out[k] for k in sorted(out) if k != "ok"})
        log.append(_stats(fe))
        fe.close()
    admitted = [s["ledgers"] for s in log if isinstance(s, dict) and "ledgers" in s]
    assert (sum(v["admitted"] for v in admitted[0].values())
            > sum(v["admitted"] for v in admitted[1].values()))
    return None, log


SCENARIOS = [
    s_reused_segments_cost_no_slots,
    s_identical_resubmission_is_free,
    s_remove_frees_exactly_what_was_charged,
    s_effective_capacity,
    s_quota_and_pool_and_duplicates_rejected,
    s_retry_after_then_resubmit,
    s_queue_admit_and_cancel,
    s_zero_cost_when_saturated_and_draining,
    s_greedy_tenant_cannot_starve_light_one,
    s_weights_scale_the_share,
    s_small_flow_fills_the_gap,
    s_billing,
    s_capacity_trace,
]


def _observed(scenario, pkg):
    fe, log = scenario(pkg)
    if fe is not None:
        fe.close()
    return log


@pytest.mark.parametrize("pkg", PORTS, ids=lambda p: p.name)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_request_sequence_observes_what_the_reference_does(scenario, pkg):
    assert _observed(scenario, pkg) == _observed(scenario, REF)


# -- preview --------------------------------------------------------------------------


def test_preview_plans_without_committing_and_keeps_minted_ids():
    A, B, C, _ = fig1(PORT_DRY)
    session = port_api.ReuseSession(strategy="signature")
    session.submit(A)
    before = (dict(session.manager.phi), session.manager._task_counter,
              set(session.manager.running))
    plan = session.preview(B)
    session.preview(C)
    assert (dict(session.manager.phi), session.manager._task_counter,
            set(session.manager.running)) == before
    receipt = session.submit(B)
    assert (plan.num_created, plan.num_reused) == (receipt.num_created, receipt.num_reused)
    plain = port_api.ReuseSession(strategy="signature")
    plain.submit(A.copy())
    assert receipt.plan.task_map == plain.submit(B.copy()).plan.task_map
    with pytest.raises(port_core.DataflowError):
        session.preview(A)


# -- the wire, both ways --------------------------------------------------------------


@pytest.mark.parametrize("server,client", [(PORT_TORCH, REF), (REF, PORT_DRY),
                                           (PORT_DRY, PORT_DRY)],
                         ids=["port-server-ref-client", "ref-server-port-client", "port"])
def test_two_tenant_socket_session(server, client):
    fe = frontend(server, slots=32)
    host, port = fe.start()
    try:
        A, B, _, _ = fig1(client)
        with client.serve.ServeClient((host, port)) as alice, \
                client.serve.ServeClient((host, port)) as bob:
            ra = alice.submit("alice", A)
            rb = bob.submit("bob", B)
            assert ra["status"] == rb["status"] == "ADMITTED"
            assert rb["slots_charged"] < len(B.tasks)
            assert bob.step(3)["steps"] == 3
            status = alice.status()
            assert status["dataflows"] == 2
            assert status["slots_used"] == ra["slots_charged"] + rb["slots_charged"]
            stats = alice.stats()
            assert stats["effective_capacity"] > 1.0
            assert stats["ledgers"]["bob"]["slots_saved"] > 0
            assert "repro_serve" in alice.metrics()["text"]
            assert alice.remove("alice", "A")["ok"]
            assert bob.drain()["ok"]
            late = bob.submit("bob", cost_df(client, "late", "z", 3))
            assert late["status"] == "REJECTED"
            with pytest.raises(client.serve.protocol.ServeProtocolError, match="not admitted"):
                alice.remove("t1", "ghost")
            assert alice.ping()
            assert alice.shutdown(checkpoint=False)["ok"]
        deadline = time.monotonic() + 5.0
        while fe._sock is not None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fe._sock is None
    finally:
        fe.close()


def test_a_delayed_shutdown_reply_survives_the_daemons_close(monkeypatch):
    """The daemon's main thread runs serve_forever() and then close(); a
    SHUTDOWN reply still being written when serve_forever() returns must
    reach the client. The reply is held 0.3 s in send_response."""
    fe = frontend(PORT_DRY)
    host, port = fe.start()
    send = port_serve.protocol.send_response

    def delayed(conn, response):
        if fe._stop_ack is not None:
            time.sleep(0.3)
        return send(conn, response)

    monkeypatch.setattr(port_serve.protocol, "send_response", delayed)
    got = {}

    def ask():
        with port_serve.ServeClient((host, port)) as c:
            try:
                got["reply"] = c.shutdown(checkpoint=False)
            except Exception as e:  # noqa: BLE001 — the assertion names it
                got["error"] = repr(e)

    asker = threading.Thread(target=ask)
    asker.start()
    try:
        fe.serve_forever()
    finally:
        fe.close()
    asker.join(timeout=10.0)
    assert got.get("reply") == {"ok": True}, got
    assert fe._sock is None


def test_restart_rebinds_the_same_port_and_metrics_over_http():
    fe1 = frontend(PORT_DRY, metrics_port=0)
    host, port = fe1.start()
    mhost, mport = fe1._metrics_sock.getsockname()[:2]
    with socket.create_connection((mhost, mport)) as s:
        s.sendall(b"GET /metrics HTTP/1.0\r\n\r\n")
        body = b""
        while chunk := s.recv(65536):
            body += chunk
    assert b"200" in body.split(b"\r\n")[0] and b"repro_serve" in body
    stale = socket.create_connection((host, port))
    fe1.close()
    fe2 = frontend(PORT_DRY, host=host, port=port)
    try:
        assert fe2.start() == (host, port)
        with port_serve.ServeClient.wait_ready((host, port), timeout=5.0) as c:
            assert c.ping()
    finally:
        stale.close()
        fe2.close()


def test_client_waits_out_backpressure_and_times_out_typed():
    fe = frontend(PORT_DRY, slots=6, retry_after=0.05,
                  default_quota=_quota(PORT_DRY, max_slots=6, max_pending=0))
    host, port = fe.start()
    try:
        with port_serve.ServeClient((host, port)) as c:
            assert c.submit("t1", cost_df(PORT_DRY, "block", "a", 6))["status"] == "ADMITTED"
            with pytest.raises(port_serve.SubmitTimeout) as ei:
                c.submit("t2", cost_df(PORT_DRY, "late", "b", 6), wait=True, max_wait=0.3)
            assert ei.value.tenant == "t2" and ei.value.last["status"] == "RETRY_AFTER"

        def free_capacity():
            time.sleep(0.3)
            with port_serve.ServeClient((host, port)) as c2:
                c2.remove("t1", "block")

        t = threading.Thread(target=free_capacity)
        t.start()
        with port_serve.ServeClient((host, port)) as c3:
            r = c3.submit("t2", cost_df(PORT_DRY, "want", "b", 6), wait=True, max_wait=20.0)
        t.join(10)
        assert not t.is_alive() and r["status"] == "ADMITTED"
    finally:
        fe.close()


# -- durability -----------------------------------------------------------------------


def _drive(pkg, fe, steps=4):
    A, B, C, D = fig1(pkg)
    fe.submit("alice", A)
    fe.submit("bob", B)
    fe.submit("bob", D)
    fe.step(steps)
    fe.remove("bob", "D")
    fe.submit("alice", C)
    fe.step(steps)


@pytest.mark.parametrize("pkg", PORTS, ids=lambda p: p.name)
def test_restore_preserves_ledgers_queue_and_sink_digests(pkg, ckpt_dir):
    fe = frontend(pkg, checkpoint_dir=ckpt_dir, slots=12,
                  default_quota=_quota(pkg, max_slots=12, max_pending=4))
    _drive(pkg, fe)
    assert fe.submit("carol", cost_df(pkg, "next", "b", 8)).status == "QUEUED"
    want = _stats(fe)
    fe.checkpoint()
    fe.close()
    placed = {"device": "cpu"} if pkg is PORT_TORCH else {}
    restored = pkg.serve.ServeFrontend.restore(
        ckpt_dir, slots=12, default_quota=_quota(pkg, max_slots=12, max_pending=4), **placed)
    uninterrupted = frontend(pkg, slots=12,
                             default_quota=_quota(pkg, max_slots=12, max_pending=4))
    try:
        assert _stats(restored) == want
        assert [p.df.name for p in restored._pending] == ["next"]
        with open(os.path.join(ckpt_dir, "frontend-ledger.json")) as fh:
            sidecar = json.load(fh)
        assert sidecar["version"] == 2 and [p["tenant"] for p in sidecar["pending"]] == ["carol"]
        _drive(pkg, uninterrupted)
        for f in (restored, uninterrupted):
            f.step(3)
        for name in ("A", "B", "C"):
            assert restored.session.sink_digests(name) == uninterrupted.session.sink_digests(name)
        A = fig1(pkg)[0]
        r = restored.submit("dave", A.copy("A2"))
        assert r.status == "ADMITTED" and r.slots_charged == 0
    finally:
        restored.close()
        uninterrupted.close()


def test_a_reference_checkpoint_restores_on_the_port(ckpt_dir):
    fe = frontend(REF, checkpoint_dir=ckpt_dir, slots=6,
                  default_quota=_quota(REF, max_slots=6, max_pending=4))
    fe.submit("t1", cost_df(REF, "block", "a", 6))
    fe.submit("t2", cost_df(REF, "next", "b", 4))
    fe.step(2)
    want = _stats(fe)
    fe.checkpoint()
    fe.close()
    restored = port_serve.ServeFrontend.restore(
        ckpt_dir, slots=6, default_quota=_quota(PORT_DRY, max_slots=6, max_pending=4))
    try:
        assert _stats(restored) == want
        out = restored.remove("t1", "block")
        assert [a["name"] for a in out["admitted"]] == ["next"]
    finally:
        restored.close()


# -- the tenant workload --------------------------------------------------------------


def test_tenant_trace_and_copy_equal_the_references():
    port_pool, ref_pool = port_workloads.opmw_workload(), ref_workloads.opmw_workload()
    kw = dict(events=800, weights={"x": 3.0, "y": 1.0}, seed=5)
    got = [(e.op, e.tenant, e.name, e.pool_name)
           for e in port_workloads.tenant_trace(port_pool, ("x", "y"), **kw)]
    want = [(e.op, e.tenant, e.name, e.pool_name)
            for e in ref_workloads.tenant_trace(ref_pool, ("x", "y"), **kw)]
    assert got == want and any(op == "remove" for op, *_ in got)
    df = fig1(PORT_DRY)[0]
    c = port_workloads.tenant_copy(df, "alice")
    assert c.name == "alice/A" and set(c.tasks) == set(df.tasks) and c.streams == df.streams


# -- the daemon -----------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_cli(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)


def _daemon(module, port, *start_args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-m", module, "start", "--port", str(port),
                             "--slots", "128", *start_args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    line = proc.stdout.readline()
    assert line.startswith("serving on"), proc.stderr.read() if proc.poll() is not None else line
    return proc


def _drive_daemon(module, port, workload, excuse_lost_stop_reply=False):
    out = {}
    for tenant in ("alice", "bob"):
        proc = _serve_cli(module, "submit", "--port", str(port), "--tenant", tenant,
                          "--workload", workload, "--count", "5")
        assert proc.returncode == 0, proc.stderr
        out[tenant] = [json.loads(line) for line in proc.stdout.splitlines()]
    proc = _serve_cli(module, "status", "--port", str(port), "--stats")
    assert proc.returncode == 0, proc.stderr
    out["stats"] = json.loads(proc.stdout)
    proc = _serve_cli(module, "stop", "--port", str(port), "--no-checkpoint")
    if excuse_lost_stop_reply and proc.returncode != 0 and "ConnectionError" in proc.stderr:
        out["stop"] = "reply lost"
    else:
        assert proc.returncode == 0 and json.loads(proc.stdout)["ok"], proc.stderr
        out["stop"] = "ok"
    return out


def _reference_stop_race(stderr):
    """Whether a daemon's error output is the reference's second symptom of
    its shutdown race: the helper thread's stop() and the main thread's
    close() run stop() at once, and one finds the listener already gone."""
    lines = stderr.strip().splitlines()
    frames = [line.strip() for line in lines if line.strip().startswith('File "')]
    return (bool(frames) and "serve/frontend.py" in frames[-1] and frames[-1].endswith("in stop")
            and lines[-1].startswith("AttributeError: 'NoneType' object has no attribute"))


def _daemon_run(module, *args, excuse_lost_stop_reply=False):
    """Start a daemon, drive it, stop it; the daemon must exit 0 and leave
    its port free. ``excuse_lost_stop_reply`` is for the reference's daemon
    only: its front end sets the shutdown event before the SHUTDOWN reply is
    sent, so its own close() can cut the reply off under load, or run
    stop() beside the helper thread's and fail in it; the daemon still
    ends, and its port is free."""
    port = _free_port()
    proc = _daemon(module, port, *args)
    try:
        return _drive_daemon(module, port, "riot", excuse_lost_stop_reply)
    finally:
        proc.wait(timeout=30)
        err = proc.stderr.read()
        assert proc.returncode == 0 or (excuse_lost_stop_reply and _reference_stop_race(err)), err
        with socket.socket() as s:
            assert s.connect_ex(("127.0.0.1", port)) != 0
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))


@pytest.fixture(scope="module")
def ref_daemon():
    return _daemon_run("repro.launch.serve", "--backend", "dryrun", excuse_lost_stop_reply=True)


@pytest.mark.parametrize("args", [["--backend", "dryrun"], ["--device", "cpu"]],
                         ids=["dryrun", "torch"])
def test_daemon_subcommands_give_the_references_ledgers(ref_daemon, args):
    got = _daemon_run("repro_torch.launch.serve", *args)
    assert got["stop"] == "ok"
    assert got["alice"] == ref_daemon["alice"] and got["bob"] == ref_daemon["bob"]
    assert got["stats"]["ledgers"] == ref_daemon["stats"]["ledgers"]
    ledgers = got["stats"]["ledgers"]
    assert ledgers["bob"]["slots_held"] < ledgers["alice"]["slots_held"]
    assert got["stats"]["backend"] == ("dryrun" if "dryrun" in args else "torch")
