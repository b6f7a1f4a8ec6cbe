"""Concurrent stepping in the port against the reference (``tests/test_concurrent.py``).

The port's wave scheduler (``compute_waves``, ``run_ready_queue``), its
broker's per-topic sequencing and ``step_mode="concurrent"`` of
``StreamSystem``/``ReuseSession``, held on the CPU:

  * the scheduler units give the reference's waves and dispatch order;
  * the broker's topics sequence, block, drop and count as the
    reference's, with torch tensors for batches;
  * on the paper's Fig. 1 churn (``FIG1_OPS``, one step after each event),
    the port in concurrent mode matches the reference's ``inprocess``
    backend in concurrent mode: sink counts exact, checksums within 2e-5,
    the live/paused/cost series and the wave events' segment names and
    indices equal; the port's concurrent digests are bitwise its sync
    ones, and a checkpoint taken in either mode restores in either mode,
    a reference payload taken in concurrent mode on ``torch`` included;
  * a 30-event prefix of the OPMW rw1 trace (``rw_trace(seed=11)``) in
    concurrent mode gives per-event sink counts equal to both packages'
    ``dryrun``;
  * the dry run's makespan is the sum over waves of the wave max in
    concurrent mode and the plain sum in sync mode, as the reference's;
  * kernel launch counting is per thread: two threads, each recording,
    each get only their own launches.

``MAX_WORKERS`` is 4 (the reference's default for its stress job); width
never changes a result.
"""
from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.api import ReuseSession as RefSession
from repro.api import flow as ref_flow
from repro.ops.costs import LatencyModel as RefLatencyModel
from repro.runtime.broker import Broker as RefBroker
from repro.runtime.scheduler import compute_waves as ref_compute_waves
from repro.runtime.scheduler import run_ready_queue as ref_run_ready_queue
from repro.runtime.system import StreamSystem as RefSystem
from repro.workloads import opmw_workload as ref_opmw
from repro.workloads import rw_trace as ref_rw_trace
from repro_torch.api import ReuseSession, WaveEvent, flow
from repro_torch.core import DataflowError
from repro_torch.kernels import build
from repro_torch.ops.costs import LatencyModel
from repro_torch.runtime.broker import Broker, topic_for
from repro_torch.runtime.dryrun import DryRunBackend
from repro_torch.runtime.scheduler import compute_waves, run_ready_queue
from repro_torch.runtime.system import StreamSystem
from repro_torch.workloads import opmw_workload, replay, rw_trace

CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
BATCH = 16
MAX_WORKERS = 4
RW1_SEED = 11
PREFIX = 30  # rw1 events (tests/test_torch_traces.py)

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


def _system(package, backend="torch", **kw):
    kw.setdefault("base_batch", BATCH)
    kw.setdefault("max_workers", MAX_WORKERS)
    if package == "ref":
        return RefSystem(strategy="signature", backend=backend, **kw)
    extra = {"device": "cpu"} if backend == "torch" else {}
    return StreamSystem(strategy="signature", backend=backend, **extra, **kw)


def _apply(system, dags, op, name):
    if op == "add":
        system.submit(dags[name].copy())
    elif op == "remove":
        system.remove(name)
    else:
        system.defragment()


def _digests(system):
    return {n: system.sink_digests(n) for n in system.manager.submitted}


def _counts(digests):
    return {n: {s: d["count"] for s, d in sinks.items()} for n, sinks in digests.items()}


def _run_ops(package, backend, step_mode, ops=FIG1_OPS, tail_steps=3, **kw):
    """One step after each event, then ``tail_steps``; returns the
    live/paused/cost series, the digests, the wave events and the system."""
    waves = []
    system = _system(package, backend, step_mode=step_mode, on_wave=waves.append, **kw)
    dags = _fig1(ref_flow if package == "ref" else flow)
    series = []
    for op, name in ops:
        _apply(system, dags, op, name)
        rep = system.step()
        series.append((rep.live_tasks, rep.paused_tasks, round(rep.cost, 6)))
    for _ in range(tail_steps):
        rep = system.step()
        series.append((rep.live_tasks, rep.paused_tasks, round(rep.cost, 6)))
    digests = _digests(system)
    system.close()
    return series, digests, waves, system


def _assert_close(port, ref):
    assert _counts(port) == _counts(ref)
    for sub, sinks in ref.items():
        for sink, dg in sinks.items():
            np.testing.assert_allclose(port[sub][sink]["checksum"], dg["checksum"], **CHECKSUM_TOL)


@pytest.fixture(scope="module")
def fig1_runs():
    """Fig. 1 churn: the reference's inprocess in concurrent mode, the
    port's torch backend in concurrent and in sync mode."""
    return {
        "ref": _run_ops("ref", "inprocess", "concurrent"),
        "port": _run_ops("port", "torch", "concurrent"),
        "port sync": _run_ops("port", "torch", "sync"),
    }


# -- wave scheduler units ---------------------------------------------------------


class TestComputeWaves:
    @pytest.mark.parametrize("deps,order,want", [
        ({}, None, []),
        ({"a": set(), "b": {"a"}, "c": {"b"}}, None, [["a"], ["b"], ["c"]]),
        ({"a": set(), "b": {"a"}, "c": {"a"}, "d": {"b", "c"}}, None, [["a"], ["b", "c"], ["d"]]),
        ({"x": set(), "y": set(), "z": set()}, {"x": 3, "y": 1, "z": 2}, [["y", "z", "x"]]),
    ], ids=["empty", "chain", "diamond", "order breaks ties"])
    def test_waves_are_the_references(self, deps, order, want):
        assert compute_waves(deps, order) == ref_compute_waves(deps, order) == want

    def test_cycle_raises(self):
        with pytest.raises(ValueError, match="cycle"):
            compute_waves({"a": {"b"}, "b": {"a"}})


class TestRunReadyQueue:
    def test_respects_dependencies(self):
        deps = {"a": set(), "b": {"a"}, "c": {"a"}, "d": {"b", "c"}}
        done, lock = [], threading.Lock()

        def runner(name):
            time.sleep(0.005)
            with lock:
                done.append(name)
            return 1.0

        out = run_ready_queue(deps, runner, max_workers=MAX_WORKERS)
        assert out == ref_run_ready_queue(deps, lambda n: 1.0, max_workers=MAX_WORKERS)
        assert done.index("a") < done.index("b") and done.index("a") < done.index("c")
        assert done.index("d") == 3

    def test_independent_segments_genuinely_overlap(self):
        """Both runners must be in flight at once or the rendezvous hangs."""
        ev_a, ev_b = threading.Event(), threading.Event()

        def runner(name):
            mine, theirs = (ev_a, ev_b) if name == "a" else (ev_b, ev_a)
            mine.set()
            assert theirs.wait(timeout=10.0), "independent segments serialized"
            return 1.0

        assert set(run_ready_queue({"a": set(), "b": set()}, runner, max_workers=2)) == {"a", "b"}

    def test_error_propagates_and_halts_dependents(self):
        ran = []

        def runner(name):
            ran.append(name)
            if name == "a":
                raise RuntimeError("boom")
            return 1.0

        with pytest.raises(RuntimeError, match="boom"):
            run_ready_queue({"a": set(), "b": {"a"}, "c": set()}, runner, max_workers=1)
        assert "b" not in ran  # the failed segment's dependent is never dispatched

    def test_cycle_raises(self):
        with pytest.raises(RuntimeError, match="cycle"):
            run_ready_queue({"a": {"b"}, "b": {"a"}}, lambda n: 0.0)

    def test_external_pool_reused_not_shut_down(self):
        pool = ThreadPoolExecutor(max_workers=2)
        try:
            for _ in range(3):
                assert run_ready_queue({"a": set(), "b": {"a"}}, lambda n: 0.5, pool=pool) == {
                    "a": 0.5, "b": 0.5}
            assert pool.submit(lambda: 42).result() == 42  # the caller owns it
        finally:
            pool.shutdown()

    def test_backend_keeps_persistent_pool(self):
        system = _system("port", step_mode="concurrent", max_workers=2)
        dags = _fig1(flow)
        for name in "AB":
            system.submit(dags[name].copy())
        system.step()
        pool = system.backend._pool
        assert pool is not None
        system.step()
        assert system.backend._pool is pool  # reused, not re-created per step
        system.backend.configure_stepping(max_workers=3)  # a resize drops the pool
        assert system.backend._pool is None
        system.step()
        assert system.backend._pool is not None
        system.close()
        assert system.backend._pool is None


# -- the broker's topics -------------------------------------------------------------


def _batch(fill=1.0, n=4):
    return torch.full((n, 8), fill, dtype=torch.float32)


class TestBrokerTopics:
    def test_sequence_advances_per_publish(self):
        port, ref = Broker(), RefBroker()
        for b in (port, ref):
            assert b.seq("t") == 0
        for fill in (1.0, 2.0):
            port.publish("t", _batch(fill))
            ref.publish("t", _batch(fill).numpy())
        assert port.seq("t") == ref.seq("t") == 2
        assert port.sequences() == ref.sequences() == {"t": 2}

    def test_fetch_synced_returns_once_sequence_reached(self):
        b = Broker()
        b.publish("t", _batch(7.0))
        assert float(b.fetch_synced("t", 1)[0, 0]) == 7.0

    def test_fetch_synced_blocks_until_producer_publishes(self):
        b = Broker()
        got = []
        t = threading.Thread(target=lambda: got.append(b.fetch_synced("t", 1, timeout=10.0)))
        t.start()
        time.sleep(0.02)
        assert not got  # still waiting on the producer
        b.publish("t", _batch(3.0))
        t.join(timeout=10.0)
        assert not t.is_alive() and float(got[0][0, 0]) == 3.0

    def test_drop_wakes_blocked_fetch_with_keyerror(self):
        b = Broker()
        b.publish("t", _batch())
        errs = []

        def consumer():
            try:
                b.fetch_synced("t", 2, timeout=10.0)
            except KeyError as e:
                errs.append(e)

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.02)
        b.drop("t")  # kill/unmerge mid-step: the waiter must not deadlock
        t.join(timeout=10.0)
        assert not t.is_alive() and len(errs) == 1

    def test_drop_then_republish_resets_sequence(self):
        b = Broker()
        b.publish("t", _batch())
        b.drop("t")
        assert not b.has("t")
        with pytest.raises(KeyError):
            b.fetch("t")
        b.publish("t", _batch())
        assert b.seq("t") == 1  # fresh topic state after the drop

    def test_len_and_topics_count_only_published(self):
        b = Broker()
        b.publish("a", _batch())
        b.publish("b", _batch())
        b.drop("a")
        assert len(b) == 1 and set(b.topics()) == {"b"}

    def test_publish_and_fetch_counters_thread_safe(self):
        b = Broker()
        batch = _batch()
        b.publish("x", batch)

        def blast(topic):
            for _ in range(200):
                b.publish(topic, batch)
                b.fetch("x")

        threads = [threading.Thread(target=blast, args=(f"t{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
        assert b.publishes == 801 and b.fetch_count == 800
        assert b.bytes_published == 801 * batch.numel() * batch.element_size()


class TestTopicLifecycle:
    """Per-topic state never outlives its segment."""

    @staticmethod
    def _live_task_topics(backend):
        return {topic_for(t) for seg in backend.segments.values() for t in seg.spec.task_ids}

    def test_no_topic_leaks_across_churn_concurrent(self):
        system = _system("port", step_mode="concurrent")
        dags = _fig1(flow)
        for op, name in FIG1_OPS:
            _apply(system, dags, op, name)
            system.step()
            assert set(system.backend.broker._topics) <= self._live_task_topics(system.backend)
        system.close()

    def test_defragment_drops_boundary_topics(self):
        system = _system("port", step_mode="concurrent")
        dags = _fig1(flow)
        for name in "ABC":
            system.submit(dags[name].copy())
        system.run(2)
        assert len(system.backend.broker) > 0  # incremental merges: boundary topics
        system.defragment()
        system.run(2)
        assert all(not d for d in system.backend.seg_deps.values())
        assert set(system.backend.broker._topics) <= self._live_task_topics(system.backend)
        system.close()

    def test_remove_sole_submission_drops_all_topics(self):
        system = StreamSystem(strategy="none", device="cpu", base_batch=BATCH,
                              step_mode="concurrent", max_workers=MAX_WORKERS)
        system.submit(_fig1(flow)["A"].copy())
        system.step()
        system.remove("A")  # Default: segments killed, topics dropped
        assert not system.backend.segments and not system.backend.broker._topics
        assert system.backend.seg_deps == {}
        system.close()


# -- the determinism contract, against the reference --------------------------------


class TestConcurrentDeterminism:
    def test_fig1_churn_matches_the_references_concurrent_run(self, fig1_runs):
        port_series, port_digests, _, _ = fig1_runs["port"]
        ref_series, ref_digests, _, _ = fig1_runs["ref"]
        assert port_series == ref_series
        _assert_close(port_digests, ref_digests)

    def test_fig1_churn_concurrent_equals_sync_bitwise(self, fig1_runs):
        conc_series, conc_digests, _, _ = fig1_runs["port"]
        sync_series, sync_digests, _, _ = fig1_runs["port sync"]
        assert conc_series == sync_series
        assert conc_digests == sync_digests

    @pytest.mark.parametrize("backend", ["torch", "dryrun"])
    def test_restore_lands_in_either_mode(self, backend, fig1_runs, tmp_path):
        """A checkpoint taken in one mode restores into the other (and back)
        and finishes with the uninterrupted run's digests (bitwise on
        torch, counts on dryrun)."""
        want = fig1_runs["port sync"][1]
        dags = _fig1(flow)
        kill_at = 4
        for ckpt_mode, restore_mode in (("sync", "concurrent"), ("concurrent", "sync")):
            ckpt = str(tmp_path / f"{backend}-{ckpt_mode}")
            system = _system("port", backend, checkpoint_dir=ckpt, step_mode=ckpt_mode)
            for op, name in FIG1_OPS[: kill_at + 1]:
                _apply(system, dags, op, name)
                system.step()
            system.checkpoint()
            system.close()
            del system  # the crash
            extra = {"device": "cpu"} if backend == "torch" else {}
            restored = StreamSystem.restore(ckpt, step_mode=restore_mode, **extra)
            assert restored.backend.step_mode == restore_mode
            for op, name in FIG1_OPS[kill_at + 1:]:
                _apply(restored, dags, op, name)
                restored.step()
            restored.run(3)
            got = _digests(restored)
            if backend == "torch":
                assert got == want
            else:
                assert _counts(got) == _counts(want)
            restored.close()

    def test_restore_defaults_to_checkpointed_mode(self, tmp_path):
        ckpt = str(tmp_path / "ck")
        system = _system("port", checkpoint_dir=ckpt, step_mode="concurrent")
        system.submit(_fig1(flow)["A"].copy())
        system.step()
        system.checkpoint()
        system.close()
        restored = StreamSystem.restore(ckpt, device="cpu")
        assert restored.backend.step_mode == "concurrent"
        assert restored.backend.max_workers == MAX_WORKERS
        restored.close()

    def test_reference_concurrent_payload_restores_on_torch(self, fig1_runs):
        """A payload of the reference's taken in concurrent mode restores on
        ``torch`` in that mode and steps on like the reference."""
        ref_system = _system("ref", "inprocess", step_mode="concurrent")
        port_twin = _system("port", step_mode="concurrent")
        for system, fl in ((ref_system, ref_flow), (port_twin, flow)):
            dags = _fig1(fl)
            for op, name in FIG1_OPS[:5]:
                _apply(system, dags, op, name)
                system.step()
        payload = ref_system.checkpoint_payload()
        assert payload["step_mode"] == "concurrent"
        restored = StreamSystem.from_payload(payload, backend="torch", device="cpu")
        assert restored.backend.step_mode == "concurrent"
        assert restored.backend.template_fallbacks == 0
        for system in (restored, ref_system, port_twin):
            system.run(3)
        _assert_close(_digests(restored), _digests(ref_system))
        for system in (restored, ref_system, port_twin):
            system.close()


class TestJitDigestIdentity:
    def test_checksums_bit_identical_across_modes(self):
        """Sink checksums are bitwise the same in both modes, because
        per-topic sequencing hands every consumer its producer's batch of
        the same step."""
        out = {}
        for mode in ("sync", "concurrent"):
            system = _system("port", step_mode=mode)
            for df in _fig1(flow).values():
                system.submit(df.copy())
            system.run(5)
            out[mode] = _digests(system)
            system.close()
        assert out["sync"] == out["concurrent"]


class TestRw1Prefix:
    def test_rw1_prefix_concurrent_counts_equal_both_dryruns(self):
        def trail(session, dags, events):
            got = []
            for _ev, _receipt in replay(session, dags, events):
                session.step()
                got.append({n: {s: d["count"] for s, d in session.sink_digests(n).items()}
                            for n in session.names})
            session.close()
            return got

        dags = opmw_workload()
        events = rw_trace(dags, seed=RW1_SEED)[:PREFIX]
        conc = trail(ReuseSession(execute=True, device="cpu", base_batch=4,
                                  step_mode="concurrent", max_workers=MAX_WORKERS), dags, events)
        dry = trail(ReuseSession(execute=True, backend="dryrun", step_mode="concurrent"),
                    dags, events)
        ref_dags = ref_opmw()
        ref = trail(RefSession(execute=True, backend="dryrun", step_mode="concurrent"), ref_dags,
                    ref_rw_trace(ref_dags, seed=RW1_SEED)[:PREFIX])
        assert len(conc) == PREFIX
        assert conc == dry == ref


# -- wave observers, makespan and knobs -----------------------------------------------


class TestWaveObserversAndKnobs:
    def test_wave_events_are_the_references(self, fig1_runs):
        port_waves, ref_waves = fig1_runs["port"][2], fig1_runs["ref"][2]
        assert [(e.step, e.index, e.segments) for e in port_waves] == [
            (e.step, e.index, e.segments) for e in ref_waves]

    def test_on_wave_covers_every_segment_once(self):
        events = []
        session = ReuseSession(execute=True, device="cpu", base_batch=BATCH,
                               step_mode="concurrent", on_wave=events.append)
        dags = _fig1(flow)
        session.submit(dags["A"])
        session.submit(dags["B"])
        rep = session.step()
        assert all(isinstance(e, WaveEvent) for e in events)
        assert [e.index for e in events] == list(range(len(events)))
        stepped = [n for e in events for n in e.segments]
        assert sorted(stepped) == sorted(session._system.backend.segments)
        assert [list(e.segments) for e in events] == session._system.backend.segment_waves()
        assert sum(e.wave_ms for e in events) == pytest.approx(rep.makespan_ms)
        session.close()

    def test_step_event_exposes_makespan(self):
        seen = []
        session = ReuseSession(execute=True, device="cpu", base_batch=BATCH, on_step=seen.append)
        session.submit(_fig1(flow)["A"])
        rep = session.step()
        assert seen[0].makespan_ms == rep.makespan_ms > 0

    def test_invalid_step_mode_rejected(self):
        with pytest.raises(ValueError, match="step_mode"):
            DryRunBackend(step_mode="warp")
        with pytest.raises(ValueError, match="step_mode"):
            DryRunBackend().configure_stepping(step_mode="warp")

    def test_control_plane_session_rejects_stepping_knobs(self):
        with pytest.raises(DataflowError, match="step_mode"):
            ReuseSession(step_mode="concurrent")
        with pytest.raises(DataflowError, match="report_history"):
            ReuseSession(report_history=8)

    def test_wrapping_a_system_applies_stepping_knobs(self):
        system = StreamSystem(strategy="signature", device="cpu")
        session = ReuseSession(system=system, step_mode="concurrent", max_workers=3,
                               report_history=7)
        assert system.backend.step_mode == "concurrent"
        assert system.backend.max_workers == 3
        assert system.backend.history_limit == 7
        session.close()
        with pytest.raises(DataflowError, match="checkpoint_dir"):
            ReuseSession(system=system, checkpoint_dir="unused")

    def test_mode_switch_mid_run_preserves_results(self, fig1_runs):
        system = _system("port", step_mode="sync")
        dags = _fig1(flow)
        for i, (op, name) in enumerate(FIG1_OPS):
            _apply(system, dags, op, name)
            system.step()
            system.backend.configure_stepping(step_mode="concurrent" if i % 2 == 0 else "sync")
        system.run(3)
        assert _digests(system) == fig1_runs["port sync"][1]
        system.close()

    def test_makespan_wave_max_vs_wave_sum(self):
        """The dry run's concurrent makespan is the sum over waves of the
        wave max, sync the plain sum — the reference's numbers."""
        per_mode = {}
        for mode in ("sync", "concurrent"):
            got = {}
            for package in ("port", "ref"):
                system = _system(package, "dryrun", step_mode=mode)
                model = LatencyModel if package == "port" else RefLatencyModel
                system.backend.calibrate(model({}, default_ms_per_unit=1.0))
                for df in _fig1(flow if package == "port" else ref_flow).values():
                    system.submit(df.copy())
                rep = system.step()
                waves = system.backend.segment_waves()
                assert len(waves) > 1 and any(len(w) > 1 for w in waves)
                agg = max if mode == "concurrent" else sum
                assert rep.makespan_ms == pytest.approx(
                    sum(agg(rep.segment_ms[n] for n in w) for w in waves))
                got[package] = (waves, rep.makespan_ms)
            assert got["port"][0] == got["ref"][0]
            assert got["port"][1] == pytest.approx(got["ref"][1])
            per_mode[mode] = got["port"][1]
        assert per_mode["concurrent"] < per_mode["sync"]

    def test_stragglers_and_ewmas_survive_restore(self, tmp_path):
        system = _system("port", "dryrun", report_history=4, checkpoint_dir=str(tmp_path))
        system.backend.calibrate(LatencyModel({}, default_ms_per_unit=1.0))
        for df in _fig1(flow).values():
            system.submit(df.copy())
        system.run(3)
        assert system.backend.ewma_ms
        # the port moves no segment; a reference payload's log is carried on
        system.backend.redispatches = [(2, "seg-moved-by-the-reference")]
        system.checkpoint()
        restored = StreamSystem.restore(str(tmp_path))
        assert restored.backend.ewma_ms == system.backend.ewma_ms
        assert restored.backend.redispatches == [(2, "seg-moved-by-the-reference")]
        assert [(r.stragglers, r.makespan_ms) for r in restored.backend.reports] == [
            (r.stragglers, r.makespan_ms) for r in system.backend.reports]


# -- kernel launch counting across threads --------------------------------------------


def test_launch_recordings_belong_to_their_thread():
    build.reset_launch_counts()
    ready, go = threading.Barrier(2), threading.Event()
    recorded = {}

    def record(name, n):
        with build.recording_launches() as mine:
            ready.wait(timeout=10.0)
            for _ in range(n):
                build.count_launch(name)
            go.wait(timeout=10.0)
        recorded[name] = dict(mine)

    threads = [threading.Thread(target=record, args=("rmsnorm", 3)),
               threading.Thread(target=record, args=("kalman_scan", 5))]
    for t in threads:
        t.start()
    time.sleep(0.05)
    build.count_launch("map_chain")  # this thread records nothing: it counts
    go.set()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert recorded == {"rmsnorm": {"rmsnorm": 3}, "kalman_scan": {"kalman_scan": 5}}
    counts = build.launch_counts()
    assert counts["map_chain"] == 1 and counts["rmsnorm"] == counts["kalman_scan"] == 0
    build.reset_launch_counts()


def test_launch_counts_thread_safe():
    build.reset_launch_counts()

    def blast():
        for _ in range(500):
            build.count_launch("rmsnorm")
            build.add_launches({"kalman_scan": 2})

    threads = [threading.Thread(target=blast) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    counts = build.launch_counts()
    assert counts["rmsnorm"] == 4000 and counts["kalman_scan"] == 8000
    build.reset_launch_counts()
