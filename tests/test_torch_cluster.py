"""The port's cluster plane (``repro_torch.cluster``: the worker supervisor
and the autoscaler) against the reference's, as ``tests/test_cluster.py``
holds the reference's:

  * ``AutoscalePolicy``: the reference's units (patience, hysteresis,
    cooldown, bounds, validation) and, on drawn observation sequences, the
    same decisions as the reference's policy;
  * the scheduler's self-healing seam (``run_ready_queue(recover=)``);
  * attach validation and the ``snapshot_mode`` resolution (spill for the
    local launcher, wire otherwise);
  * a worker SIGKILLed mid-trace under supervision, on the dry plane (Fig.
    1 churn in spill and wire mode, an OPMW rw1 slice at a seeded step:
    sink counts those of the un-killed run) and on the torch plane (Fig. 1
    in spill and wire mode: sink digests bitwise those of the in-process
    ``torch`` backend);
  * the reference's ``ValueError`` from ``supervise=``/``autoscale=`` on a
    backend without a worker pool.

The elasticity half (resize, autoscale, heartbeats, health, the session
knobs) is ``tests/test_torch_cluster_elastic.py``.

Workers run on the CPU (``device="cpu"``).
"""
from __future__ import annotations

import os
import random
import signal

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.cluster import AutoscalePolicy as RefPolicy
from repro_torch.api import ReuseSession
from repro_torch.cluster import Autoscaler, AutoscalePolicy, WorkerSupervisor
from repro_torch.cluster.events import SEGMENT_REDEPLOYED, WORKER_RESPAWNED
from repro_torch.core import Dataflow, Task
from repro_torch.runtime.backend import resolve_backend
from repro_torch.runtime.scheduler import run_ready_queue
from repro_torch.runtime.system import StreamSystem
from repro_torch.runtime.worker import MultiprocBackend

BATCH = 16
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


def chain_df(name, source, chain, sink="store"):
    """source → chain[0] → … → chain[-1] → sink (``tests/helpers.py`` on
    the port's graph)."""
    d = Dataflow(name)
    prev = d.add_task(Task.make(f"{name}.src.{source}", source, "SOURCE"))
    for i, (typ, cfg) in enumerate(chain):
        t = d.add_task(Task.make(f"{name}.{i}.{typ}", typ, cfg))
        d.add_stream(prev.id, t.id)
        prev = t
    snk = d.add_task(Task.make(f"{name}.sink.{sink}", sink, "SINK"))
    d.add_stream(prev.id, snk.id)
    return d


def fig1():
    pk = [("parse", {}), ("kalman", {"q": 0.1})]
    return {
        "A": chain_df("A", "urban", pk, "store_a"),
        "B": chain_df("B", "urban", pk + [("win", {"w": 10})], "store_b"),
        "C": chain_df("C", "urban", pk + [("win", {"w": 10}), ("avg", {})], "store_c"),
        "D": chain_df("D", "meter", pk, "store_d"),
    }


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
    return {n: {s: int(d["count"]) for s, d in v.items()} for n, v in digests.items()}


def _pool(workers=2, plane="dry", **kw):
    return MultiprocBackend(workers=workers, worker_plane=plane, device="cpu", **kw)


def _run_fig1(backend, ops=FIG1_OPS, tail_steps=3, kill_at=None, victim=1, supervise=None):
    """Replay Fig. 1 churn; optionally SIGKILL worker ``victim`` just before
    stepping event ``kill_at``. Returns (digests, event kinds, respawns)."""
    dags = fig1()
    system = StreamSystem(strategy="signature", backend=backend, base_batch=BATCH)
    sup = None
    if supervise is not None:
        sup = WorkerSupervisor(system.backend, **supervise).start()
    for i, (op, name) in enumerate(ops):
        _apply(system, dags, op, name)
        if kill_at is not None and i == kill_at:
            be = system.backend
            os.kill(be._procs[victim % be.n_workers].pid, signal.SIGKILL)
        system.step()
    for _ in range(tail_steps):
        system.step()
    digests = _digests(system)
    kinds = [e.kind for e in getattr(system.backend, "worker_events", [])]
    respawns = len(getattr(system.backend, "respawns", []))
    if sup is not None:
        sup.stop()
    system.close()
    return digests, kinds, respawns


@pytest.fixture(scope="module")
def fig1_torch():
    """The un-killed Fig. 1 run on the in-process torch backend."""
    return _run_fig1(resolve_backend("torch", device="cpu"))[0]


# -- policy units ----------------------------------------------------------------


class TestAutoscalePolicy:
    def _policy(self, **kw):
        kw.setdefault("min_workers", 1)
        kw.setdefault("max_workers", 4)
        kw.setdefault("high_ms", 10.0)
        kw.setdefault("low_ms", 1.0)
        kw.setdefault("patience", 3)
        kw.setdefault("cooldown", 0)
        return AutoscalePolicy(**kw)

    def test_grow_needs_patience_consecutive_highs(self):
        p = self._policy()
        assert [p.decide(50.0, 1) for _ in range(3)] == [1, 1, 2]

    def test_shrink_needs_patience_consecutive_lows(self):
        p = self._policy()
        assert [p.decide(0.1, 3) for _ in range(3)] == [3, 3, 2]

    def test_in_band_observation_resets_streaks(self):
        p = self._policy()
        p.decide(50.0, 1)
        p.decide(50.0, 1)
        assert p.decide(5.0, 1) == 1
        assert [p.decide(50.0, 1) for _ in range(3)] == [1, 1, 2]

    def test_cooldown_suppresses_followup_action(self):
        p = self._policy(patience=1, cooldown=2)
        assert [p.decide(50.0, 1), p.decide(50.0, 2), p.decide(50.0, 2),
                p.decide(50.0, 2)] == [2, 2, 2, 3]

    def test_bounds_are_hard(self):
        p = self._policy(patience=1, max_workers=2)
        assert p.decide(50.0, 2) == 2
        assert p.decide(0.1, 1) == 1

    def test_constructor_validation(self):
        with pytest.raises(ValueError, match="min_workers"):
            AutoscalePolicy(min_workers=0)
        with pytest.raises(ValueError, match="max_workers"):
            AutoscalePolicy(min_workers=3, max_workers=2)
        with pytest.raises(ValueError, match="hysteresis"):
            AutoscalePolicy(low_ms=10.0, high_ms=10.0)

    @settings(max_examples=200, deadline=None)
    @given(
        pressures=st.lists(st.floats(0.0, 100.0, allow_nan=False), max_size=40),
        patience=st.integers(1, 4),
        cooldown=st.integers(0, 3),
        lo=st.floats(0.5, 20.0),
        span=st.floats(0.5, 40.0),
        bounds=st.tuples(st.integers(1, 3), st.integers(0, 3)),
    )
    def test_decisions_equal_the_references(self, pressures, patience, cooldown, lo, span,
                                            bounds):
        kw = dict(min_workers=bounds[0], max_workers=bounds[0] + bounds[1], low_ms=lo,
                  high_ms=lo + span, patience=patience, cooldown=cooldown)
        port, ref = AutoscalePolicy(**kw), RefPolicy(**kw)
        n_port = n_ref = bounds[0]
        for p in pressures:
            n_port, n_ref = port.decide(p, n_port), ref.decide(p, n_ref)
            assert n_port == n_ref


# -- scheduler self-healing seam -------------------------------------------------


class TestRunReadyQueueRecovery:
    def test_recovered_item_is_requeued_and_completes(self):
        calls = {"a": 0, "b": 0}

        def runner(n):
            calls[n] += 1
            if n == "a" and calls["a"] == 1:
                raise RuntimeError("boom")
            return 1.0

        healed = []
        out = run_ready_queue({"a": [], "b": ["a"]}, runner, 2,
                              recover=lambda n, e: healed.append(n) or True)
        assert out == {"a": 1.0, "b": 1.0} and healed == ["a"]
        assert calls == {"a": 2, "b": 1}

    def test_retries_are_bounded(self):
        calls = {"a": 0}

        def runner(n):
            calls[n] += 1
            raise RuntimeError("always broken")

        with pytest.raises(RuntimeError, match="always broken"):
            run_ready_queue({"a": []}, runner, 2, recover=lambda n, e: True, max_retries=2)
        assert calls["a"] == 3

    def test_declined_recovery_raises(self):
        def runner(n):
            raise RuntimeError("fatal")

        with pytest.raises(RuntimeError, match="fatal"):
            run_ready_queue({"a": []}, runner, 2, recover=lambda n, e: False)


# -- attach validation + snapshot-mode resolution --------------------------------


class TestAttach:
    def test_supervisor_and_autoscaler_reject_a_backend_without_a_pool(self):
        with pytest.raises(ValueError, match="worker-pool backend"):
            WorkerSupervisor(resolve_backend("dryrun"))
        with pytest.raises(ValueError, match="resizable worker pool"):
            Autoscaler(resolve_backend("torch", device="cpu"))

    def test_bad_options_rejected_and_modes_resolved(self):
        be = _pool(workers=1)
        try:
            with pytest.raises(ValueError, match="snapshot_mode"):
                WorkerSupervisor(be, snapshot_mode="telepathy")
            with pytest.raises(ValueError, match="not both"):
                Autoscaler(be, policy=AutoscalePolicy(), high_ms=9.0)
            WorkerSupervisor(be)
            assert be.snapshot_mode == "spill" and be.self_heal and not be.shadow_states
            WorkerSupervisor(be, snapshot_mode="wire", rpc_timeout=30.0, snapshot_every=2)
            assert be.snapshot_mode == "wire" and be.shadow_states
            assert (be.rpc_timeout, be.snapshot_every) == (30.0, 2)
        finally:
            be.close()

    def test_system_and_session_raise_the_references_error_without_a_pool(self):
        with pytest.raises(ValueError, match="worker-pool backend"):
            StreamSystem(strategy="none", backend="dryrun", supervise=True)
        with pytest.raises(ValueError, match="worker-pool backend"):
            ReuseSession(execute=True, backend="torch", device="cpu", supervise=True)
        with pytest.raises(ValueError, match="resizable worker pool"):
            StreamSystem(strategy="none", backend="dryrun", autoscale=True)
        system = StreamSystem(strategy="none", backend="dryrun")
        assert system.worker_health() is None
        system.close()


# -- crash recovery conformance --------------------------------------------------


class TestKillRecoveryConformance:
    @pytest.mark.parametrize("snapshot_mode", ["spill", "wire"])
    def test_dry_plane_fig1_counts_survive_mid_trace_kill(self, snapshot_mode):
        want, _, _ = _run_fig1(resolve_backend("dryrun"))
        got, kinds, respawns = _run_fig1(
            _pool(), kill_at=4,
            supervise=dict(heartbeat_interval=5.0, snapshot_mode=snapshot_mode))
        assert _counts(got) == _counts(want)
        assert respawns >= 1 and WORKER_RESPAWNED in kinds and SEGMENT_REDEPLOYED in kinds

    @pytest.mark.parametrize("snapshot_mode", ["spill", "wire"])
    def test_torch_plane_fig1_digests_bitwise_across_a_kill(self, fig1_torch, snapshot_mode):
        got, kinds, respawns = _run_fig1(
            _pool(plane="torch"), kill_at=4,
            supervise=dict(heartbeat_interval=5.0, snapshot_mode=snapshot_mode))
        assert got == fig1_torch
        assert respawns >= 1 and WORKER_RESPAWNED in kinds

    def test_opmw_rw1_slice_kill_at_seeded_random_step(self):
        from repro_torch.workloads import opmw_workload, rw_trace

        dags = {d.name: d for d in opmw_workload()}
        events = [(ev.op, ev.name) for ev in rw_trace(dags.values(), seed=11)][:16]
        kill_at = random.Random(117).randrange(2, len(events) - 2)

        def run(backend, kill):
            system = StreamSystem(strategy="signature", backend=backend)
            sup = None
            if kill:
                sup = WorkerSupervisor(system.backend, heartbeat_interval=5.0).start()
            for i, (op, name) in enumerate(events):
                _apply(system, dags, op, name)
                if kill and i == kill_at:
                    os.kill(system.backend._procs[1].pid, signal.SIGKILL)
                system.step()
            counts = _counts(_digests(system))
            respawns = len(getattr(system.backend, "respawns", []))
            if sup is not None:
                sup.stop()
            system.close()
            return counts, respawns

        want, _ = run(resolve_backend("dryrun"), kill=False)
        got, respawns = run(_pool(), kill=True)
        assert got == want and respawns >= 1
