"""The port's cluster plane under a changing pool, as the elasticity half of
``tests/test_cluster.py`` holds the reference's: ``resize_pool``, the
autoscaler end to end (forced pressure grows then shrinks the pool; the
``autoscale=`` knob binds and reports), the heartbeat catching an idle
crash, the synchronous check (which never probes a worker still
spawning), the health and event hooks, the subprocess launcher, and
``ReuseSession(execute=True, backend="multiproc", supervise=..., autoscale=...)``
recovering a worker killed between two steps with sink digests bitwise
the in-process ``torch`` backend's, then restoring with ``supervise=``.

Workers run on the CPU (``device="cpu"``); the dataflow helpers and runners are
``tests/test_torch_cluster.py``'s.
"""
from __future__ import annotations

import os
import signal
import time

import pytest

from repro_torch.api import ReuseSession
from repro_torch.cluster import Autoscaler, WorkerSupervisor
from repro_torch.cluster.events import (
    HEARTBEAT_MISSED,
    POOL_GROWN,
    POOL_SHRUNK,
    SCALE_DOWN,
    SCALE_UP,
    WORKER_RESPAWNED,
)
from repro_torch.runtime.backend import resolve_backend
from repro_torch.runtime.system import StreamSystem

from test_torch_cluster import (
    BATCH,
    FIG1_OPS,
    _apply,
    _counts,
    _digests,
    _pool,
    _run_fig1,
    chain_df,
    fig1,
)


@pytest.fixture(scope="module")
def fig1_torch():
    """The un-killed Fig. 1 run on the in-process torch backend."""
    return _run_fig1(resolve_backend("torch", device="cpu"))[0]


# -- elasticity ------------------------------------------------------------------


class TestResizePool:
    def test_grow_and_shrink_preserve_counts(self):
        def run(backend, resize):
            system = StreamSystem(strategy="none", backend=backend)
            for i in range(5):
                system.submit(chain_df(f"R{i}", "urban", [("kalman", {"q": float(i)})]))
            system.run(2)
            if resize:
                backend.resize_pool(4)
            system.run(2)
            if resize:
                backend.resize_pool(1)
                assert set(backend.device_of.values()) == {0}
            system.run(2)
            counts = _counts(_digests(system))
            kinds = [e.kind for e in getattr(backend, "worker_events", [])]
            system.close()
            return counts, kinds

        want, _ = run(resolve_backend("dryrun"), resize=False)
        be = _pool()
        with pytest.raises(ValueError, match=">= 1"):
            be.resize_pool(0)
        got, kinds = run(be, resize=True)
        assert got == want
        assert POOL_GROWN in kinds and POOL_SHRUNK in kinds


class TestAutoscalerEndToEnd:
    def test_forced_pressure_grows_then_shrinks_pool(self, monkeypatch):
        be = _pool(workers=1)
        seen = []
        system = StreamSystem(strategy="none", backend=be, on_worker_event=seen.append)
        for i in range(4):
            system.submit(chain_df(f"A{i}", "urban", [("kalman", {"q": float(i)})]))
        system.step()
        scaler = Autoscaler(be, min_workers=1, max_workers=3,
                            high_ms=10.0, low_ms=1.0, patience=2, cooldown=0)
        monkeypatch.setattr(scaler, "pressure", lambda: 100.0)
        for _ in range(4):
            system.step()
            scaler.observe()
        assert be.n_workers > 1
        monkeypatch.setattr(scaler, "pressure", lambda: 0.01)
        for _ in range(6):
            system.step()
            scaler.observe()
        assert be.n_workers == 1
        assert [(a["from"], a["to"]) for a in scaler.actions][0] == (1, 2)
        kinds = [e.kind for e in seen]
        assert SCALE_UP in kinds and SCALE_DOWN in kinds
        assert POOL_GROWN in kinds and POOL_SHRUNK in kinds
        report = system.step()
        assert report.live_tasks == be.live_task_count
        system.close()

    def test_system_autoscale_knob_binds_and_reports(self):
        system = StreamSystem(
            strategy="none", backend=_pool(workers=1),
            autoscale={"min_workers": 1, "max_workers": 2, "high_ms": 1e9, "low_ms": 1e-9},
        )
        system.submit(chain_df("K0", "urban", [("kalman", {"q": 1.0})]))
        system.step()  # observe() runs inside step()
        health = system.worker_health()
        assert health["autoscale"]["max_workers"] == 2
        assert health["autoscale"]["actions"] == []
        assert health["autoscale"]["pressure_ms"] >= 0.0
        system.close()


class TestHeartbeatAndHealth:
    def test_heartbeat_detects_idle_crash(self):
        be = _pool()
        system = StreamSystem(strategy="none", backend=be)
        for i in range(2):
            system.submit(chain_df(f"H{i}", "urban", [("kalman", {"q": float(i)})]))
        system.step()
        sup = WorkerSupervisor(be, heartbeat_interval=0.05).start()
        os.kill(be._procs[1].pid, signal.SIGKILL)
        deadline = time.monotonic() + 20.0
        while not be.respawns and time.monotonic() < deadline:
            time.sleep(0.02)  # no step issued: only the heartbeat can notice
        assert be.respawns, "heartbeat never recovered the idle crash"
        assert HEARTBEAT_MISSED in [e.kind for e in be.worker_events]
        assert be.worker_alive(1)
        system.step()
        sup.stop()
        assert not sup.running
        system.close()

    def test_check_is_synchronous_and_probes_only_spawned_workers(self):
        be = _pool()
        system = StreamSystem(strategy="none", backend=be)
        system.submit(chain_df("C0", "urban", [("kalman", {"q": 1.0})]))
        system.step()
        sup = WorkerSupervisor(be)  # not started: no background thread
        assert be.worker_ready(0)  # it answered the deploy and the step
        os.kill(be._procs[0].pid, signal.SIGKILL)
        time.sleep(0.1)
        assert sup.check() == [0]
        assert be.worker_alive(0)
        # the respawned worker answered its redeploys: it is probed again
        assert be.worker_ready(0) and sup.check() == []
        be.resize_pool(3)
        # a worker that has not answered yet is not pinged (it may still
        # be importing torch), so no timeout can respawn it
        assert not be.worker_ready(2)
        pinged = []
        be.ping_worker = lambda i, timeout=5.0: pinged.append(i) or True
        assert sup.check() == [] and 2 not in pinged
        system.close()

    def test_supervise_knob_surfaces_worker_health(self):
        system = StreamSystem(strategy="none", backend=_pool(), supervise=True)
        system.submit(chain_df("W0", "urban", [("kalman", {"q": 1.0})]))
        system.step()
        health = system.worker_health()
        assert health["workers"] == 2 and health["alive"] == [True, True]
        assert health["supervised"] is True
        assert health["snapshot_mode"] in ("spill", "wire")
        assert "spill_ms_per_step" in health
        assert health["heartbeat_running"] is True
        system.close()  # stops the supervisor thread
        assert system._supervisor.running is False

    def test_event_hook_receives_pool_events(self):
        seen = []
        be = _pool(workers=1)
        system = StreamSystem(strategy="none", backend=be, on_worker_event=seen.append)
        system.submit(chain_df("E0", "urban", [("kalman", {"q": 1.0})]))
        system.step()
        be.resize_pool(2)
        be.resize_pool(1)
        kinds = [e.kind for e in seen]
        assert POOL_GROWN in kinds and POOL_SHRUNK in kinds
        system.close()


class TestSubprocessLauncher:
    def test_end_to_end_counts_match_the_dryrun_backend(self):
        want, _, _ = _run_fig1(resolve_backend("dryrun"), ops=FIG1_OPS[:4], tail_steps=1)
        be = _pool(launcher="subprocess")
        assert be.launcher.supports_spill  # same host, no command_prefix
        got, _, _ = _run_fig1(be, ops=FIG1_OPS[:4], tail_steps=1)
        assert _counts(got) == _counts(want)


# -- the knobs through the session and a restore ----------------------------------


def test_session_supervised_autoscaled_pool_recovers_a_kill_and_restores(fig1_torch, tmp_path):
    """``ReuseSession(execute=True, backend="multiproc", supervise=True,
    autoscale={...})`` on the torch plane: a worker killed between two
    steps is recovered in the step that finds it dead, digests bitwise the
    in-process run's; a checkpoint restores with ``supervise=`` armed."""
    dags = fig1()
    events = []
    with ReuseSession(execute=True, backend="multiproc", workers=2, device="cpu",
                      base_batch=BATCH, supervise={"heartbeat_interval": 5.0},
                      autoscale={"min_workers": 1, "max_workers": 3, "high_ms": 1e9,
                                 "low_ms": 1e-9},
                      on_worker_event=events.append, checkpoint_dir=str(tmp_path)) as session:
        be = session._system.backend
        for i, (op, name) in enumerate(FIG1_OPS):
            _apply(session, dags, op, name)
            if i == 4:
                os.kill(be._procs[0].pid, signal.SIGKILL)
            session.step()
        session.run(3)
        got = {n: session.sink_digests(n) for n in sorted(session.manager.submitted)}
        health = session.worker_health()
        path = session.checkpoint()
    assert got == fig1_torch
    assert health["respawns"] >= 1 and health["autoscale"]["max_workers"] == 3
    assert WORKER_RESPAWNED in [e.kind for e in events]
    restored = StreamSystem.restore(path, device="cpu", supervise=True)
    try:
        assert restored._supervisor.running and restored.backend.self_heal
        assert _digests(restored) == got
        restored.step()
    finally:
        restored.close()
