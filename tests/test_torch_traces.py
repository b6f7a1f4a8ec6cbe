"""The OPMW workload and the paper's traces in the port, against the reference.

The port's ``opmw_workload()`` and its traces equal the reference's task for
task and event for event. The OPMW rw1 trace (``rw_trace(seed=11)``, the
trace ``benchmarks/workload_traces.py`` and ``repro.launch.dryrun`` call
rw1) replays through the port's ``ReuseSession`` with one step after each
event: in full on ``torch`` (on the CPU, at a small batch), where every
submission's sink counts after every event equal those of the port's and
the reference's ``dryrun``; and its first events against the reference's
``inprocess``, with counts exact and checksums within 2e-5 (the jit
backend compiles every segment, so the prefix is kept short).
"""
import numpy as np
import pytest

from repro.api import ReuseSession as RefSession
from repro.workloads import opmw_workload as ref_opmw
from repro.workloads import riot_workload as ref_riot
from repro.workloads import rw_trace as ref_rw_trace
from repro.workloads import seq_trace as ref_seq_trace
from repro_torch.api import ReuseSession
from repro_torch.workloads import opmw_workload, replay, riot_workload, rw_trace, seq_trace

CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
RW1_SEED = 11
PREFIX = 30  # events of rw1 against inprocess: 28 adds, 2 removals (one re-added)


def _dags(dags):
    return [
        (d.name, sorted((t.id, t.type, t.config) for t in d.tasks.values()), sorted(d.streams))
        for d in dags
    ]


def _events(events):
    return [(e.op, e.name) for e in events]


def test_opmw_workload_equals_the_references():
    port, ref = opmw_workload(), ref_opmw()
    assert _dags(port) == _dags(ref)
    assert sum(len(d) for d in port) == 471


@pytest.mark.parametrize("seed", [1, RW1_SEED, 23])
def test_rw_trace_equals_the_references(seed):
    assert _events(rw_trace(opmw_workload(), seed=seed)) == _events(ref_rw_trace(ref_opmw(), seed=seed))
    assert _events(rw_trace(riot_workload(), seed=seed)) == _events(ref_rw_trace(ref_riot(), seed=seed))


@pytest.mark.parametrize("seed", [0, 3])
def test_seq_trace_equals_the_references(seed):
    assert _events(seq_trace(opmw_workload(), seed=seed)) == _events(ref_seq_trace(ref_opmw(), seed=seed))


def _replay(session, dags, events):
    """One step after each event; per event, every present submission's
    sink digests, and the peaks of submitted and running tasks."""
    trail, peak_sub, peak_run = [], 0, 0
    for _ev, _receipt in replay(session, dags, events):
        session.step()
        trail.append({n: session.sink_digests(n) for n in session.names})
        peak_sub = max(peak_sub, session.submitted_task_count)
        peak_run = max(peak_run, session.running_task_count)
    return trail, (peak_sub, peak_run)


def _counts(trail):
    return [{n: {s: d["count"] for s, d in sinks.items()} for n, sinks in t.items()} for t in trail]


@pytest.fixture(scope="module")
def rw1():
    dags = opmw_workload()
    return dags, rw_trace(dags, seed=RW1_SEED)


def test_full_rw1_on_torch_counts_equal_dryrun(rw1):
    dags, events = rw1
    torch_trail, torch_peaks = _replay(
        ReuseSession(execute=True, device="cpu", base_batch=4), dags, events
    )
    dry_trail, dry_peaks = _replay(ReuseSession(execute=True, backend="dryrun"), dags, events)
    ref_dags = ref_opmw()
    ref_trail, ref_peaks = _replay(
        RefSession(execute=True, backend="dryrun"), ref_dags, ref_rw_trace(ref_dags, seed=RW1_SEED)
    )
    assert len(torch_trail) == len(events) == 156
    assert _counts(torch_trail) == _counts(dry_trail) == _counts(ref_trail)
    assert torch_peaks == dry_peaks == ref_peaks == (471, 277)
    assert all(np.isfinite(d["checksum"]) for t in torch_trail for s in t.values() for d in s.values())


def test_rw1_prefix_matches_inprocess(rw1):
    dags, events = rw1
    port_trail, _ = _replay(ReuseSession(execute=True, device="cpu", base_batch=8), dags,
                            events[:PREFIX])
    ref_dags = ref_opmw()
    ref_trail, _ = _replay(RefSession(execute=True, backend="inprocess", base_batch=8), ref_dags,
                           ref_rw_trace(ref_dags, seed=RW1_SEED)[:PREFIX])
    assert [e.op for e in events[:PREFIX]].count("remove") == 2
    assert _counts(port_trail) == _counts(ref_trail)
    last_port, last_ref = port_trail[-1], ref_trail[-1]
    for sub, sinks in last_ref.items():
        for sink, dg in sinks.items():
            np.testing.assert_allclose(last_port[sub][sink]["checksum"], dg["checksum"],
                                       **CHECKSUM_TOL)


def test_rw1_restored_mid_trace_finishes_like_the_uninterrupted_run(rw1, ckpt_dir):
    """A checkpoint at the middle event, restored, finishes the trace with
    the sink digests of the run that never stopped (bitwise, on the CPU)."""
    dags, events = rw1
    mid = len(events) // 2
    whole, _ = _replay(ReuseSession(execute=True, device="cpu", base_batch=4), dags, events)
    first = ReuseSession(execute=True, device="cpu", base_batch=4, checkpoint_dir=ckpt_dir)
    head, _ = _replay(first, dags, events[:mid])
    first.checkpoint()
    restored = ReuseSession.restore(ckpt_dir, device="cpu")
    tail, _ = _replay(restored, dags, events[mid:])
    assert head + tail == whole
