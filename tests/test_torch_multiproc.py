"""The port's worker-process plane (``backend="multiproc"``) against the
port's in-process backends and the reference, as ``tests/test_multiproc.py``
holds the reference's:

  * coordinator plumbing: registered, constructor validation (the
    reference's ``"jit"`` plane is the port's ``"torch"``), the inproc
    transport rejected, knobs reaching the backend from StreamSystem and
    ReuseSession, a worker error naming its log, ``close`` ending the
    workers, a worker asked for the card without one raising, and spawned
    workers importing neither JAX nor the reference;
  * the ``dry`` plane against the port's ``dryrun`` backend (Fig. 1
    counts), segments spread across workers, sticky placement across a
    checkpoint/restore, the tcp transport;
  * the ``torch`` plane on Fig. 1 churn (with ``defragment()``): sink
    digests bitwise equal to the port's ``torch`` backend in sync mode and
    in concurrent mode with chain batching, and within 2e-5 of the
    reference's ``inprocess``; checkpoint/restore continuity, restores
    across ``multiproc`` and ``torch`` both ways, and a payload the
    reference's ``multiproc`` wrote (``worker_plane: "jit"``);
  * straggler migration to the other worker (the in-process ``torch``
    backend flags and logs no redispatch);
  * an OPMW rw1 slice with counts equal to the reference's;
  * ``recover_worker`` (from shadow snapshots and from spill files) and
    ``resize_pool`` called directly, digests unchanged.

Workers run on the CPU here (``device="cpu"``), one pool per system.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro.api import flow as ref_flow
from repro.runtime.system import StreamSystem as RefSystem
from repro.runtime.worker import MultiprocBackend as RefMultiproc
from repro.workloads import opmw_workload as ref_opmw
from repro.workloads import rw_trace as ref_rw_trace
from repro_torch.api import ReuseSession, flow
from repro_torch.runtime.backend import available_backends, resolve_backend
from repro_torch.runtime.system import StreamSystem
from repro_torch.runtime.transport import TransportError
from repro_torch.runtime.worker import MultiprocBackend, RemoteSegment, WorkerError
from repro_torch.workloads import opmw_workload, rw_trace

BATCH = 16
CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
FIG1_OPS = [
    ("add", "A"),
    ("add", "B"),
    ("add", "C"),
    ("add", "D"),
    ("remove", "B"),
    ("defrag", ""),
    ("remove", "A"),
    ("add", "B"),
]


def _fig1(builder):
    """Paper Fig. 1: A, B, C share a source + prefix; D has another source."""

    def build_df(name, chain, source, sink):
        b = builder(name).source(source)
        for typ, cfg in chain:
            b.then(typ, **cfg)
        return b.sink(sink).build()

    pk = [("parse", {}), ("kalman", {"q": 0.1})]
    return {
        df.name: df
        for df in (
            build_df("A", pk, "urban", "store_a"),
            build_df("B", pk + [("win", {"w": 10})], "urban", "store_b"),
            build_df("C", pk + [("win", {"w": 10}), ("avg", {})], "urban", "store_c"),
            build_df("D", pk, "meter", "store_d"),
        )
    }


def _chain(name, q):
    return flow(name).source("urban").then("kalman", q=q).sink("store").build()


def _apply(system, dags, op, name):
    if op == "add":
        system.submit(dags[name].copy())
    elif op == "remove":
        system.remove(name)
    else:
        system.defragment()


def _digests(system):
    return {n: system.sink_digests(n) for n in sorted(system.manager.submitted)}


def _counts(digests):
    return {n: {s: int(d["count"]) for s, d in sinks.items()} for n, sinks in digests.items()}


def _multiproc(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("device", "cpu")
    return MultiprocBackend(**kw)


def _run_ops(backend, step_mode="sync", ops=FIG1_OPS, tail_steps=2, package="port", **kw):
    dags = _fig1(ref_flow if package == "ref" else flow)
    cls = RefSystem if package == "ref" else StreamSystem
    if package == "port" and backend == "torch":
        kw["device"] = "cpu"
    system = cls(strategy="signature", backend=backend, base_batch=BATCH, step_mode=step_mode,
                 **kw)
    for op, name in ops:
        _apply(system, dags, op, name)
        system.step()
    system.run(tail_steps)
    digests = _digests(system)
    system.close()
    return digests


@pytest.fixture(scope="module")
def fig1():
    """Fig. 1 churn on the port's torch backend and the reference's inprocess."""
    return {"torch": _run_ops("torch"), "ref": _run_ops("inprocess", package="ref")}


# -- coordinator plumbing -----------------------------------------------------------


class TestCoordinatorPlumbing:
    def test_registered_and_validated(self):
        assert "multiproc" in available_backends()
        with pytest.raises(ValueError, match="workers"):
            MultiprocBackend(workers=0)
        with pytest.raises(ValueError, match="worker_plane"):
            MultiprocBackend(worker_plane="quantum")
        be = MultiprocBackend(worker_plane="jit", device="cpu")
        assert be.worker_plane == "torch" and be.spawn_config()["worker_plane"] == "torch"
        be.close()

    def test_inproc_transport_rejected(self):
        with pytest.raises(TransportError, match="cannot span"):
            MultiprocBackend(workers=1, transport="inproc")

    def test_knobs_reach_the_backend(self):
        events = []
        system = StreamSystem(backend="multiproc", workers=1, device="cpu", transport="tcp",
                              backend_options={"worker_plane": "dry", "placement": "sticky"},
                              on_worker_event=events.append)
        try:
            be = system.backend
            assert isinstance(be, MultiprocBackend)
            assert (be.n_workers, be.worker_plane, be.transport.name, be.policy.name) == (
                1, "dry", "tcp", "sticky")
            assert be.on_worker_event == events.append
            assert system.worker_health()["workers"] == 1
        finally:
            system.close()
        system = StreamSystem(backend="multiproc", device="cpu", supervise=True)
        assert system.backend.self_heal and system.worker_health()["heartbeat_running"]
        system.close()
        with ReuseSession(execute=True, backend="multiproc", device="cpu",
                          autoscale={"max_workers": 3}) as session:
            assert session.worker_health()["autoscale"]["max_workers"] == 3
        with pytest.raises(ValueError, match="worker-pool backend"):
            StreamSystem(device="cpu", supervise=True)
        assert StreamSystem(device="cpu").worker_health() is None

    def test_errors_name_the_log_close_ends_the_workers_and_they_import_no_jax(self, tmp_path):
        be = _multiproc(log_dir=str(tmp_path))
        system = StreamSystem(backend=be, base_batch=BATCH)
        system.submit(_chain("S0", 0.1))
        system.step()
        with pytest.raises(WorkerError, match="unknown worker op"):
            be._call(0, {"op": "frobnicate"})
        log = tmp_path / "worker-0.log"
        assert log.exists() and "frobnicate" in log.read_text()
        procs = list(be._procs)
        assert all(p.is_alive() for p in procs)
        for w in range(2):
            reply = be._call(w, {"op": "ping"})
            assert reply["foreign_modules"] == [], reply["foreign_modules"]
        system.close()
        assert all(not p.is_alive() for p in procs)
        be.close()  # idempotent

    def test_a_worker_asked_for_a_card_it_does_not_have_raises(self):
        # the CPU here has no card; an index no card has fails on a machine with one
        system = StreamSystem(backend="multiproc", workers=1, device="cuda:97", base_batch=BATCH)
        try:
            with pytest.raises(WorkerError, match="(?i)cuda"):
                system.submit(_chain("S0", 0.1))
        finally:
            system.close()


# -- the dry plane ---------------------------------------------------------------------


class TestDryWorkerPlane:
    def test_fig1_counts_over_tcp_match_the_dryrun_backend(self):
        got = _run_ops(_multiproc(worker_plane="dry", transport="tcp"))
        want = _run_ops("dryrun")
        assert _counts(got) == _counts(want)

    def test_segments_spread_and_sticky_placement_across_restore(self):
        be = _multiproc(worker_plane="dry", placement="least_loaded")
        system = StreamSystem(strategy="none", backend=be, base_batch=BATCH)
        for i in range(4):
            system.submit(_chain(f"S{i}", float(i)))
        system.run(3)
        assert set(be.device_of.values()) == {0, 1}
        assert isinstance(next(iter(be.segments.values())), RemoteSegment)
        payload = system.checkpoint_payload()
        placed, want = dict(be.device_of), _counts(_digests(system))
        system.close()
        assert payload["backend_config"] == {
            "workers": 2, "transport": "shm", "worker_plane": "dry", "placement": "least_loaded"}
        restored = StreamSystem.from_payload(
            payload, backend=_multiproc(worker_plane="dry", placement="sticky"))
        assert restored.backend.device_of == placed
        assert _counts(_digests(restored)) == want
        restored.run(2)
        restored.close()


# -- the torch plane -------------------------------------------------------------------


class TestTorchWorkerPlane:
    @pytest.mark.parametrize("step_mode,chains", [("sync", False), ("concurrent", True)])
    def test_fig1_bitwise_the_torch_backend_and_close_to_the_reference(
            self, fig1, step_mode, chains):
        # sync: a StreamSystem, one RPC per segment; concurrent: a
        # ReuseSession, one step_chain RPC per worker per step
        if step_mode == "sync":
            got = _run_ops(_multiproc(chain_batching=chains), step_mode=step_mode)
        else:
            dags = _fig1(flow)
            with ReuseSession(execute=True, backend="multiproc", workers=2, transport="shm",
                              device="cpu", base_batch=BATCH, step_mode=step_mode,
                              backend_options={"chain_batching": chains}) as session:
                for op, name in FIG1_OPS:
                    _apply(session, dags, op, name)
                    session.step()
                session.run(2)
                got = {n: session.sink_digests(n) for n in session.names}
                assert session.worker_health()["workers"] == 2
        assert got == fig1["torch"]
        assert _counts(got) == _counts(fig1["ref"])
        for sub, sinks in fig1["ref"].items():
            for sink, dg in sinks.items():
                np.testing.assert_allclose(got[sub][sink]["checksum"], dg["checksum"],
                                           **CHECKSUM_TOL)

    def test_checkpoint_restore_continuity_and_across_backends(self, tmp_path):
        dags = _fig1(flow)
        system = StreamSystem(backend=_multiproc(), base_batch=BATCH,
                              checkpoint_dir=str(tmp_path))
        system.submit(dags["A"].copy())
        system.submit(dags["B"].copy())
        system.run(3)
        system.remove("B")
        system.step()
        path = system.checkpoint()
        at_ckpt = _digests(system)
        system.run(2)
        final = _digests(system)
        system.close()

        # multiproc -> torch, and torch -> multiproc (the reference's
        # multiproc payload below re-spawns a pool from its backend_config)
        on_torch = StreamSystem.restore(path, backend="torch", device="cpu")
        assert _digests(on_torch) == at_ckpt and on_torch.backend.template_fallbacks == 0
        on_torch.run(2)
        assert _digests(on_torch) == final
        back = StreamSystem.from_payload(on_torch.checkpoint_payload(), backend="multiproc",
                                         workers=2, device="cpu")
        assert _digests(back) == final
        back.run(1)
        on_torch.run(1)
        assert _digests(back) == _digests(on_torch)
        back.close()

    def test_restores_a_payload_the_references_multiproc_wrote(self):
        dags = _fig1(ref_flow)
        ref = RefSystem(backend=RefMultiproc(workers=1), base_batch=BATCH)
        ref.submit(dags["A"].copy())
        ref.submit(dags["D"].copy())
        ref.run(2)
        payload = ref.checkpoint_payload()
        ref.run(2)
        want = _digests(ref)
        ref.close()
        assert payload["backend"] == "multiproc"
        assert payload["backend_config"]["worker_plane"] == "jit"
        system = StreamSystem.from_payload(payload, device="cpu")
        try:
            # the pool re-spawned from the payload's backend_config
            assert isinstance(system.backend, MultiprocBackend)
            assert (system.backend.worker_plane, system.backend.n_workers) == ("torch", 1)
            system.run(2)
            got = _digests(system)
            assert _counts(got) == _counts(want)
            for sub, sinks in want.items():
                for sink, dg in sinks.items():
                    np.testing.assert_allclose(got[sub][sink]["checksum"], dg["checksum"],
                                               **CHECKSUM_TOL)
        finally:
            system.close()


# -- straggler migration -----------------------------------------------------------------


def _inject(be, victim, slow_ms=200.0):
    """Make ``victim``'s step report ``slow_ms`` (the others 2 ms)."""
    orig = type(be)._step_one

    def slowed(seg):
        out = orig(be, seg)
        if isinstance(be, MultiprocBackend):
            return slow_ms if seg.spec.name == victim else 2.0
        return out

    be._step_one = slowed


class TestStragglerMigration:
    def test_a_straggler_moves_to_the_other_worker(self):
        # chain batching ships one step_chain RPC per worker, so the per-
        # segment _step_one hook would never run: pin the per-segment path
        be = _multiproc(worker_plane="dry", placement="ewma_aware", chain_batching=False)
        system = StreamSystem(strategy="none", backend=be, base_batch=BATCH)
        for i in range(4):
            system.submit(_chain(f"S{i}", float(i)))
        victim = sorted(be.device_of)[0]
        before = be.device_of[victim]
        _inject(be, victim)
        for _ in range(12):
            report = system.step()
            if be.redispatches:
                break
        assert be.redispatches and be.redispatches[-1][1] == victim
        assert victim in report.stragglers
        assert be.device_of[victim] != before  # migrated to the other worker
        rep = system.step()  # the migrated segment still steps: its states moved with it
        assert rep.live_tasks == 4 * 3
        assert [c for sinks in _counts(_digests(system)).values() for c in sinks.values()] == [
            rep.step] * 4
        system.close()

    def test_the_torch_backend_flags_but_logs_no_redispatch(self):
        system = StreamSystem(strategy="none", device="cpu", base_batch=BATCH)
        for i in range(4):
            system.submit(_chain(f"S{i}", float(i)))
        be = system.backend
        victim = sorted(be.segments)[0]
        orig = type(be)._step_one
        be._step_one = lambda seg: (orig(be, seg), 200.0 if seg.name == victim else 2.0)[1]
        flagged = [n for _ in range(8) for n in system.step().stragglers]
        assert victim in flagged and be.redispatches == []


# -- OPMW rw1 ------------------------------------------------------------------------------


def test_rw1_slice_counts_are_the_references():
    """Ten rw1 events, one step each, in concurrent mode with chain batching,
    against the reference's dryrun (whose counts the reference's tests hold
    equal to its inprocess)."""
    events = [(ev.op, ev.name) for ev in rw_trace(opmw_workload(), seed=11)][:10]
    ref_events = [(ev.op, ev.name) for ev in ref_rw_trace(ref_opmw(), seed=11)][:10]
    assert events == ref_events
    trails = {}
    for label, system, dags in (
        ("port", StreamSystem(backend=_multiproc(), base_batch=BATCH, step_mode="concurrent"),
         {d.name: d for d in opmw_workload()}),
        ("ref", RefSystem(backend="dryrun", base_batch=BATCH), {d.name: d for d in ref_opmw()}),
    ):
        trail = []
        for op, name in events:
            _apply(system, dags, op, name)
            system.step()
            trail.append(_counts(_digests(system)))
        system.close()
        trails[label] = trail
    assert trails["port"] == trails["ref"]
