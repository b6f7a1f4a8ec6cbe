"""The port's ReuseSession against the reference's (``tests/test_api.py``).

Both packages run the same script on the paper's Fig. 1 flows, the port
with ``execute=True, backend="torch", device="cpu"``, the reference with
``backend="inprocess"``. Reuse counts, running task ids and sink counts are
exact; checksums are allclose at rtol 2e-5 (``torch.sum`` and ``jnp.sum``
reduce in different orders: tests/test_torch_system.py). Within the port,
``defragment()`` keeps the digests, and fused and unfused runs stay
bitwise equal after it. ``defragment()`` builds its segments as the
reference does: not fusion-built, so the peephole leaves them alone.
"""
import numpy as np
import pytest
import torch

from repro.api import ReuseSession as RefSession
from repro.api import flow as ref_flow
from repro_torch.api import ReuseSession, StepEvent, flow
from repro_torch.core import DataflowError, ReuseManager
from repro_torch.kernels import ops as kernel_ops
from repro_torch.runtime.system import StreamSystem
from repro_torch.workloads import kernel_flows, replay, riot_workload, seq_trace

CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
BATCH = 16


def _fig1(builder):
    """Paper Fig. 1: A, B, C share a source + prefix; D has another source."""

    def build(name, chain, source, sink):
        b = builder(name).source(source)
        for typ, cfg in chain:
            b.then(typ, **cfg)
        return b.sink(sink).build()

    pk = [("parse", {}), ("kalman", {"q": 0.1})]
    return [
        build("A", pk, "urban", "store_a"),
        build("B", pk + [("win", {"w": 10})], "urban", "store_b"),
        build("C", pk + [("win", {"w": 10}), ("avg", {})], "urban", "store_c"),
        build("D", pk, "meter", "store_d"),
    ]


def _linear(name, extra="win", fl=flow):
    return (
        fl(name)
        .source("urban")
        .then("senml_parse", schema="urban")
        .then("kalman", q=0.1)
        .then(extra, w=8)
        .sink("store")
    )


def _port(**kw):
    return ReuseSession(execute=True, device="cpu", base_batch=BATCH, **kw)


def _session_script(session, flows, fuse):
    """submit_many, 2 steps, [fuse], 2 steps, remove B, defragment, 2 steps."""
    session.submit_many(flows)
    session.run(2)
    if fuse:
        session.fuse()
    session.run(2)
    session.remove("B")
    session.defragment()
    session.run(2)
    return {n: session.sink_digests(n) for n in session.names}


def _assert_match(port, ref):
    assert port.keys() == ref.keys()
    for sub in ref:
        assert port[sub].keys() == ref[sub].keys()
        for sink in ref[sub]:
            assert port[sub][sink]["count"] == ref[sub][sink]["count"], (sub, sink)
            np.testing.assert_allclose(
                port[sub][sink]["checksum"], ref[sub][sink]["checksum"], **CHECKSUM_TOL
            )


# -- against the reference ------------------------------------------------------


@pytest.fixture(scope="module")
def fig1_runs():
    ref = RefSession(execute=True, backend="inprocess", base_batch=BATCH)
    ref_digests = _session_script(ref, _fig1(ref_flow), fuse=True)
    port = _port()
    port_digests = _session_script(port, _fig1(flow), fuse=True)
    unfused = _port()
    unfused_digests = _session_script(unfused, _fig1(flow), fuse=False)
    return dict(ref=ref, ref_digests=ref_digests, port=port, port_digests=port_digests,
                unfused_digests=unfused_digests)


def test_fig1_session_matches_reference(fig1_runs):
    port, ref = fig1_runs["port"], fig1_runs["ref"]
    _assert_match(fig1_runs["port_digests"], fig1_runs["ref_digests"])
    assert port.reuse_counts() == ref.reuse_counts()
    assert port.running_task_count == ref.running_task_count
    running = lambda s: {n: sorted(d.tasks) for n, d in s.manager.running.items()}  # noqa: E731
    assert running(port) == running(ref)
    # after the defrag one segment per running DAG, the same on both sides
    assert port.stats().segments == ref.stats().segments == len(port.manager.running)
    assert port.stats().deployed_task_count == ref.stats().deployed_task_count


def test_fig1_fused_equals_unfused_after_defragment(fig1_runs):
    assert fig1_runs["port_digests"] == fig1_runs["unfused_digests"]


def _kernel_flows_script(fuse, defrag):
    """The kernel flows behind the urban source: 3 steps, [fuse], 2 steps,
    [defragment], 2 steps; returns (digests, the peephole's runs at the
    end)."""
    session = ReuseSession(execute=True, device="cpu", base_batch=8)
    urban_kalman = next(df for df in riot_workload() if df.name == "urban_kalman")
    session.submit_many([urban_kalman] + kernel_flows())
    session.run(3)
    if fuse:
        session.fuse()
    session.run(2)
    if defrag:
        ev = session.defragment()
        segments = session._system.backend.segments.values()
        assert ev.segments_after == len(segments) == len(session.manager.running)
        assert not any(seg.spec.fused for seg in segments)
    session.run(2)
    defs = session._system.backend.task_defs
    runs = sorted(
        tuple(defs[t].type for t in run)
        for seg in session._system.backend.segments.values()
        for run in seg.fused_runs.values()
    )
    return {n: session.sink_digests(n) for n in session.names}, runs


def test_defragment_rebuilds_through_the_peephole_bitwise():
    """defragment() rebuilds every segment as the reference does, not
    fusion-built: the peephole leaves them alone, whether or not fuse() put
    the senml runs on the multi-op kernels before it, and every digest
    equals the run that was never fused nor defragmented."""
    plain, plain_runs = _kernel_flows_script(fuse=False, defrag=False)
    unfused, unfused_runs = _kernel_flows_script(fuse=False, defrag=True)
    fused, fused_runs = _kernel_flows_script(fuse=True, defrag=True)
    _, fused_only_runs = _kernel_flows_script(fuse=True, defrag=False)
    assert plain_runs == fused_runs == unfused_runs == []
    assert ("senml_parse", "senml_parse") in fused_only_runs
    assert fused == unfused == plain


# -- session ≡ StreamSystem ------------------------------------------------------


def test_session_parity_with_stream_system():
    dags = [d for d in riot_workload() if d.name.startswith("urban")]
    direct = StreamSystem(strategy="signature", base_batch=8, device="cpu")
    session = ReuseSession(strategy="signature", execute=True, base_batch=8, device="cpu")
    for d in dags:
        direct.submit(d.copy())
        session.submit(d.copy())
    assert session.running_task_count == direct.running_task_count
    direct.run(3)
    session.run(3)
    for d in dags:
        assert session.sink_digests(d.name) == direct.sink_digests(d.name)
    direct.remove(dags[0].name)
    session.remove(dags[0].name)
    assert session.running_task_count == direct.running_task_count
    direct.defragment()
    ev = session.defragment()
    assert ev.segments_after == len(direct.backend.segments)
    direct.run(2)
    session.run(2)
    for d in dags[1:]:
        assert session.sink_digests(d.name) == direct.sink_digests(d.name)


def test_control_plane_session_rejects_data_plane_ops():
    session = ReuseSession()
    session.submit(_linear("a"))
    with pytest.raises(DataflowError):
        session.run(1)
    with pytest.raises(DataflowError):
        session.defragment()
    with pytest.raises(DataflowError, match="device"):
        ReuseSession(device="cpu")


def test_session_stats_and_hooks():
    session = _port()
    merges, unmerges, defrags, steps = [], [], [], []
    session.on_merge(merges.append)
    session.on_unmerge(unmerges.append)
    session.on_defrag(defrags.append)
    session.on_step(steps.append)
    session.submit(_linear("a"))
    session.submit(_linear("b", extra="avg"))
    st = session.stats()
    assert st.submitted_task_count == 10
    assert st.running_task_count == 7
    assert 0.29 < st.task_reduction < 0.31
    assert st.reuse_histogram.get(2) == 3  # shared prefix used by both
    ref = RefSession(execute=True, backend="inprocess", base_batch=BATCH)
    ref.submit(_linear("a", fl=ref_flow))
    ref.submit(_linear("b", extra="avg", fl=ref_flow))
    ref_st = ref.stats()
    assert st.backend == "torch"
    assert (st.compile_cache_hits, st.compile_cache_misses) == (
        ref_st.compile_cache_hits, ref_st.compile_cache_misses) == (0, 2)
    assert [m.name for m in merges] == ["a", "b"]
    assert merges[1].num_reused == 3 and not merges[1].batched
    session.run(2)
    assert [e.step for e in steps] == [1, 2] and all(isinstance(e, StepEvent) for e in steps)
    assert session.stats().steps_run == 2
    session.remove("a")
    assert len(unmerges) == 1 and unmerges[0].name == "a"
    assert unmerges[0].terminated_tasks  # a's win + sink die
    session.defragment()
    assert len(defrags) == 1 and defrags[0].deployed_tasks_after == session.running_task_count


def test_session_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ReuseSession(execute=True)
    assert ReuseSession(execute=True, device="cpu").backend_name == "torch"


@pytest.mark.parametrize("arg", [
    {"transport": "shm"}, {"workers": 2}, {"supervise": True}, {"autoscale": True},
    {"on_worker_event": print}, {"backend_options": {"placement": "least_loaded"}},
])
def test_trimmed_planes_raise(arg):
    # the worker-process and cluster planes are ported: their arguments
    # reach a multiproc backend (nothing spawns before a deploy); the
    # supervisor and the autoscaler on a backend without a worker pool
    # raise the reference's ValueError
    if "supervise" in arg or "autoscale" in arg:
        with pytest.raises(ValueError, match="worker-pool backend|resizable worker pool"):
            ReuseSession(execute=True, device="cpu", **arg)
    session = ReuseSession(execute=True, device="cpu", backend="multiproc", **arg)
    try:
        backend = session._system.backend
        assert backend.self_heal == ("supervise" in arg)
        assert ("autoscale" in session.worker_health()) == ("autoscale" in arg)
        assert session.backend_name == "multiproc" and backend.device == "cpu"
        assert backend.transport.name == arg.get("transport", "shm")
        assert backend.n_workers == arg.get("workers", 2)
        assert backend.policy.name == arg.get("backend_options", {}).get("placement", "round_robin")
        assert backend.on_worker_event is arg.get("on_worker_event")
        assert session.worker_health()["workers"] == backend.n_workers
    finally:
        session.close()


def test_concurrent_step_mode_raises():
    # concurrent stepping is the reference's: it needs a data plane, as
    # there, and a mode neither package has raises
    with pytest.raises(DataflowError, match="step_mode, max_workers"):
        ReuseSession(step_mode="concurrent", max_workers=2)
    with pytest.raises(ValueError, match="step_mode"):
        ReuseSession(execute=True, device="cpu", step_mode="warp")
    session = ReuseSession(execute=True, device="cpu", step_mode="concurrent", max_workers=2,
                           on_wave=print)
    assert (session._system.backend.step_mode, session._system.backend.max_workers) == (
        "concurrent", 2)
    session.close()


# -- batched submission and traces ------------------------------------------------


@pytest.mark.parametrize("preload", [0, 7])
def test_submit_many_equals_sequential(preload):
    dags = riot_workload()
    seq = ReuseManager(strategy="signature", check_invariants=True)
    bat = ReuseManager(strategy="signature", check_invariants=True)
    for d in dags[:preload]:
        seq.submit(d.copy())
        bat.submit(d.copy())
    for d in dags[preload:]:
        seq.submit(d.copy())
    receipts = bat.submit_many([d.copy() for d in dags[preload:]])
    assert len(receipts) == len(dags) - preload
    assert bat.running_task_count == seq.running_task_count
    assert bat.phi == seq.phi and bat.delta == seq.delta
    assert bat.task_maps == seq.task_maps


def test_submit_many_sink_digests_match_sequential():
    dags = [d for d in riot_workload() if d.name.startswith("meter")]
    seq = ReuseSession(execute=True, base_batch=8, device="cpu")
    bat = ReuseSession(execute=True, base_batch=8, device="cpu")
    for d in dags:
        seq.submit(d.copy())
    receipt = bat.submit_many([d.copy() for d in dags])
    assert receipt.names == [d.name for d in dags]
    seq.run(3)
    bat.run(3)
    for d in dags:
        assert bat.sink_digests(d.name) == seq.sink_digests(d.name)


def test_trace_replay_through_session():
    dags = riot_workload()
    session = ReuseSession(check_invariants=True)
    events = seq_trace(dags, seed=3)
    seen = [ev.name for ev, _ in replay(session, dags, events)]
    assert len(seen) == len(events)
    assert session.running_task_count == 0  # seq trace fully drains


def test_session_restore_from_journal(tmp_path):
    path = str(tmp_path / "j.jsonl")
    session = ReuseSession(journal_path=path)
    session.submit(_linear("a"))
    session.submit(_linear("b", extra="avg"))
    session.remove("a")
    n_lines = sum(1 for _ in open(path))
    restored = ReuseSession.restore(path)
    restored.verify()
    assert restored.running_task_count == session.running_task_count
    assert sum(1 for _ in open(path)) == n_lines


def test_session_launches_no_kernel_on_the_cpu():
    kernel_ops.reset_launch_counts()
    session = _port()
    _session_script(session, _fig1(flow), fuse=True)
    assert set(kernel_ops.launch_counts().values()) == {0}
