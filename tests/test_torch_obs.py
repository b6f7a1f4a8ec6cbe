"""The port's telemetry plane against the reference's (``tests/test_obs.py``).

``repro_torch.obs`` is a copy of ``repro.obs``: the same operations on a
registry or a tracer give the same snapshots, the same Prometheus text and
the same span shapes in both packages. Wired into the port's data plane,
on the paper's Fig. 1 flows, in sync and in concurrent mode:

  * the reuse, compile-cache and transport counters (and the step and
    checkpoint counters) of ``metrics_snapshot()`` equal those of the
    reference's ``inprocess`` backend after the same script;
  * the control spans' names and categories come in the reference's
    order, and every span category counts what the reference's does
    (durations ignored);
  * the accessors (``segment_latency_ms``, ``prometheus_text``,
    ``export_chrome_trace``) and ``configure_obs``'s registry swap behave
    as the reference's.
"""
from __future__ import annotations

import json
import os
from collections import Counter

import pytest

from repro import obs as ref_obs
from repro.api import ReuseSession as RefSession
from repro.api import flow as ref_flow
from repro_torch import obs
from repro_torch.api import ReuseSession, flow
from repro_torch.core import ReuseManager
from repro_torch.obs import (
    DEFAULT_MS_BUCKETS,
    MetricsRegistry,
    NULL_REGISTRY,
    NullRegistry,
    Tracer,
    chrome_trace_json,
    merge_snapshots,
    parse_prometheus,
    render_prometheus,
    write_chrome_trace,
)
from repro_torch.runtime.system import StreamSystem

BATCH = 16
# counters and gauges whose values the port must give exactly as the
# reference does after the same script (the float cost counter apart)
EXACT = (
    "repro_steps_total",
    "repro_tasks_live",
    "repro_tasks_paused",
    "repro_transport_publishes_total",
    "repro_transport_bytes_published_total",
    "repro_transport_fetches_total",
    "repro_compile_cache_hits_total",
    "repro_compile_cache_misses_total",
    "repro_compile_cache_evictions_total",
    "repro_compile_cache_entries",
    "repro_reuse_tasks_saved",
    "repro_reuse_tasks_submitted_total",
    "repro_reuse_tasks_reused_total",
    "repro_merge_events_total",
    "repro_unmerge_events_total",
    "repro_fusion_segments_saved_total",
    "repro_checkpoints_total",
)


def sample(families, name, **labels):
    want = {k: str(v) for k, v in labels.items()}
    for lbls, value in families.get(name, []):
        if lbls == want:
            return value
    return None


def snap_value(snapshot, name, **labels):
    """Scalar of one labelset in a registry snapshot, or None."""
    entry = snapshot.get(name)
    if entry is None:
        return None
    want = {k: str(v) for k, v in labels.items()}
    for lbls, value in entry["values"]:
        if lbls == want:
            return value
    return None


def _fig1(builder):
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


# -- primitives: the same operations, the same snapshots -------------------------------


def _both(fn):
    """``fn`` run on the port's obs module and on the reference's."""
    return fn(obs), fn(ref_obs)


class TestMetricsPrimitives:
    def test_counter_inc_labels_and_clamped_set_total(self):
        m = MetricsRegistry()
        c = m.counter("ops_total", "ops")
        c.inc()
        c.inc(2.5)
        c.inc(1, op="merge")
        assert c.value() == 3.5 and c.value(op="merge") == 1.0
        c.set_total(10.0)
        c.set_total(4.0)  # clamped: counters never decrease
        assert c.value() == 10.0
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_gauge_set_inc_dec(self):
        def run(o):
            g = o.MetricsRegistry().gauge("depth", "queue depth")
            g.set(5)
            g.inc(2)
            g.dec()
            return g.value()

        assert _both(run) == (6.0, 6.0)

    def test_histogram_buckets_sum_count(self):
        def run(o):
            m = o.MetricsRegistry()
            h = m.histogram("lat_ms", "latency", buckets=(1.0, 10.0))
            for v in (0.5, 5.0, 50.0, 10.0):  # 10.0 lands in le=10 (inclusive)
                h.observe(v)
            return m.snapshot()

        port, ref = _both(run)
        assert port == ref
        cell = snap_value(port, "lat_ms")
        assert cell["counts"] == [1, 2, 1] and cell["count"] == 4
        assert cell["sum"] == pytest.approx(65.5)
        assert DEFAULT_MS_BUCKETS == ref_obs.DEFAULT_MS_BUCKETS == tuple(sorted(DEFAULT_MS_BUCKETS))

    def test_registry_get_or_create_and_kind_mismatch(self):
        m = MetricsRegistry()
        assert m.counter("x") is m.counter("x")
        with pytest.raises(ValueError):
            m.gauge("x")

    def test_merge_adds_counters_and_histogram_cells(self):
        def run(o):
            a, b = o.MetricsRegistry(), o.MetricsRegistry()
            for m, n in ((a, 2), (b, 3)):
                m.counter("steps_total").inc(n)
                m.gauge("live").set(n)
                m.histogram("ms", buckets=(1.0,)).observe(0.5)
            return o.merge_snapshots([a.snapshot(), b.snapshot()])

        port, ref = _both(run)
        assert port == ref
        assert snap_value(port, "steps_total") == 5.0 and snap_value(port, "live") == 5.0
        assert snap_value(port, "ms")["counts"] == [2, 0]
        assert merge_snapshots is obs.merge_snapshots

    def test_null_registry_is_inert(self):
        assert isinstance(NULL_REGISTRY, NullRegistry)
        NULL_REGISTRY.counter("whatever").inc(5)
        NULL_REGISTRY.add_collector(lambda: 1 / 0)
        assert NULL_REGISTRY.snapshot() == {}

    def test_collectors_run_at_snapshot_and_failures_are_swallowed(self):
        m = MetricsRegistry()
        m.add_collector(lambda: m.gauge("mirrored").set(42))
        m.add_collector(lambda: 1 / 0)  # must not kill the scrape
        assert snap_value(m.snapshot(), "mirrored") == 42.0


class TestPrometheusText:
    def test_render_parse_round_trip_is_the_references(self):
        def run(o):
            m = o.MetricsRegistry()
            m.counter("req_total", "requests").inc(3, tenant="a/b", code="200")
            m.gauge("temp").set(-1.5)
            m.histogram("ms", buckets=(1.0, 5.0)).observe(0.2)
            return o.render_prometheus(m.snapshot())

        text, ref_text = _both(run)
        assert text == ref_text
        fams = parse_prometheus(text)
        assert sample(fams, "req_total", tenant="a/b", code="200") == 3.0
        assert sample(fams, "temp") == -1.5
        assert sample(fams, "ms_count") == 1.0
        assert sample(fams, "ms_bucket", le="1") == sample(fams, "ms_bucket", le="+Inf") == 1.0

    def test_label_escaping_survives_round_trip(self):
        m = MetricsRegistry()
        m.counter("c").inc(1, topic='we"ird\\label\nx')
        fams = parse_prometheus(render_prometheus(m.snapshot()))
        assert sample(fams, "c", topic='we"ird\\label\nx') == 1.0

    def test_parse_rejects_malformed_lines(self):
        with pytest.raises(ValueError):
            parse_prometheus("this is not exposition format\n")


class TestTracer:
    def test_disabled_records_nothing(self):
        t = Tracer(enabled=False)
        with t.span("x"):
            pass
        assert t.drain() == []

    def test_span_shape_is_the_references(self):
        def run(o):
            t = o.Tracer(enabled=True)
            with t.span("step", "step", step=3):
                pass
            (s,) = t.drain()
            return {k: v for k, v in s.items() if k not in ("ts", "dur")}

        port, ref = _both(run)
        assert port == ref
        assert port["name"] == "step" and port["cat"] == "step" and port["ph"] == "X"
        assert port["args"] == {"step": 3} and port["pid"] == os.getpid()

    def test_stride_sampling_per_name(self):
        t = Tracer(enabled=True, sample_stride=3)
        for _ in range(9):
            with t.span("a"):
                pass
        for _ in range(2):
            with t.span("b"):
                pass
        names = [s["name"] for s in t.drain()]
        assert names.count("a") == 3 and names.count("b") == 1  # stride state is per name

    def test_ring_buffer_drops_oldest(self):
        t = Tracer(enabled=True, capacity=4)
        for i in range(10):
            with t.span("s", i=i):
                pass
        assert [s["args"]["i"] for s in t.drain()] == [6, 7, 8, 9]

    def test_error_span_recorded_and_raises(self):
        t = Tracer(enabled=True)
        with pytest.raises(RuntimeError):
            with t.span("boom"):
                raise RuntimeError("x")
        (s,) = t.drain()
        assert s["args"]["error"] == "RuntimeError"

    def test_chrome_trace_export(self, tmp_path):
        t = Tracer(enabled=True)
        with t.span("work", "segment"):
            pass
        doc = chrome_trace_json(t.spans())
        metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert len(metas) == 1 and metas[0]["args"]["name"].startswith("repro pid")
        path = write_chrome_trace(str(tmp_path / "trace.json"), t.drain())
        with open(path) as f:
            assert any(e["ph"] == "X" for e in json.load(f)["traceEvents"])


# -- the data plane's telemetry, against the reference's inprocess backend ------------


def _script(session, flows, ckpt_dir):
    """Traced: submit Fig. 1, 3 steps, fuse, a step, remove B, defragment,
    2 steps, a checkpoint; returns (snapshot, spans)."""
    session.configure_obs(trace=True)
    for df in flows:
        session.submit(df)
    session.run(3)
    session.fuse()
    session.step()
    session.remove("B")
    session.defragment()
    session.run(2)
    session.checkpoint(ckpt_dir)
    return session.metrics_snapshot(), session.drain_spans()


@pytest.fixture(scope="module", params=["sync", "concurrent"])
def fig1_obs(request, tmp_path_factory):
    mode = request.param
    root = tmp_path_factory.mktemp(f"obs-{mode}")
    out = {}
    for package, cls, fl, kw in (
        ("port", ReuseSession, flow, {"device": "cpu"}),
        ("ref", RefSession, ref_flow, {"backend": "inprocess"}),
    ):
        session = cls(execute=True, base_batch=BATCH, step_mode=mode, max_workers=4, **kw)
        snapshot, spans = _script(session, _fig1(fl), str(root / package))
        out[package] = (session, snapshot, spans)
    yield mode, out
    for session, _, _ in out.values():
        session.close()


class TestSystemObs:
    def test_counters_equal_the_references(self, fig1_obs):
        _, out = fig1_obs
        port, ref = out["port"][1], out["ref"][1]
        for name in EXACT:
            assert snap_value(port, name) == snap_value(ref, name), name
        assert snap_value(port, "repro_transport_fetches_total") > 0
        assert snap_value(port, "repro_fusion_segments_saved_total") > 0
        assert snap_value(port, "repro_reuse_core_steps_avoided_total") == pytest.approx(
            snap_value(ref, "repro_reuse_core_steps_avoided_total"), rel=1e-9)
        for hist in ("repro_step_wall_ms", "repro_segment_step_ms", "repro_checkpoint_save_ms"):
            assert snap_value(port, hist)["count"] == snap_value(ref, hist)["count"], hist

    def test_control_spans_in_the_references_order(self, fig1_obs):
        _, out = fig1_obs
        control = {p: [s["name"] for s in out[p][2] if s["cat"] == "control"] for p in out}
        assert control["port"] == control["ref"]
        assert {"merge", "unmerge", "fuse", "defrag"} <= set(control["port"])

    def test_span_categories_count_the_references(self, fig1_obs):
        mode, out = fig1_obs
        counts = {p: Counter((s["cat"], s["name"]) for s in out[p][2]) for p in out}
        assert counts["port"] == counts["ref"]
        cats = {cat for cat, _ in counts["port"]}
        assert {"step", "segment", "control", "compile", "checkpoint", "transport"} <= cats
        assert (("step", "wave_dispatch") in counts["port"]) == (mode == "concurrent")

    def test_reuse_savings_metrics_match_manager_ground_truth(self, fig1_obs):
        _, out = fig1_obs
        session, snap, _ = out["port"]
        mgr = session.manager
        assert snap_value(snap, "repro_reuse_tasks_saved") == (
            mgr.submitted_task_count - mgr.running_task_count)
        oc = mgr.op_counts
        assert snap_value(snap, "repro_reuse_tasks_submitted_total") == oc["tasks_submitted"]
        assert snap_value(snap, "repro_merge_events_total") == oc["merge_events"]
        assert snap_value(snap, "repro_unmerge_events_total") == 1.0
        assert oc["tasks_submitted"] == oc["tasks_reused"] + oc["tasks_created"]

    def test_prometheus_text_and_chrome_trace(self, fig1_obs, tmp_path):
        _, out = fig1_obs
        session = out["port"][0]
        fams = parse_prometheus(session.prometheus_text())
        for name in ("repro_steps_total", "repro_segment_step_ms_count",
                     "repro_reuse_tasks_reused_total", "repro_merge_events_total"):
            assert sample(fams, name) is not None, name
        session.step()
        path = str(tmp_path / "trace.json")
        n = session.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert n > 0 and len([e for e in events if e["ph"] == "X"]) == n
        assert session.drain_spans() == []  # export drains

    def test_op_counts_survive_journal_replay(self, tmp_path):
        journal = str(tmp_path / "journal.jsonl")
        system = StreamSystem(strategy="signature", backend="dryrun", journal_path=journal)
        for df in _fig1(flow):
            system.submit(df)
        system.remove("A")
        want = dict(system.manager.op_counts)
        system.close()
        assert ReuseManager.restore(journal, strategy="signature").op_counts == want

    def test_configure_obs_registry_swap_keeps_collectors(self):
        system = StreamSystem(strategy="signature", device="cpu", base_batch=BATCH)
        for df in _fig1(flow):
            system.submit(df)
        assert snap_value(system.metrics_snapshot(), "repro_reuse_tasks_saved") is not None
        system.configure_obs(metrics=False)
        assert system.metrics_snapshot() == {}
        assert system.prometheus_text() == "\n"
        system.configure_obs(metrics=True)  # a fresh registry, the collector re-wired
        assert snap_value(system.metrics_snapshot(), "repro_reuse_tasks_saved") is not None
        system.close()

    def test_segment_latency_accessor_matches_report_history(self):
        system = StreamSystem(strategy="signature", device="cpu", base_batch=BATCH,
                              report_history=64)
        for df in _fig1(flow):
            system.submit(df)
        system.run(6)
        stats = system.segment_latency_ms()
        reports = system.backend.reports
        assert stats and reports
        for name, cell in stats.items():
            series = [r.segment_ms[name] for r in reports if name in r.segment_ms]
            assert cell["samples"] == len(series)
            assert cell["mean_ms"] == pytest.approx(sum(series) / len(series))
            assert cell["last_ms"] == pytest.approx(series[-1])
            assert cell["max_ms"] == pytest.approx(max(series))
        assert len(system.backend.latency_samples()) == sum(c["samples"] for c in stats.values())
        system.close()

    def test_checkpoint_metrics_and_spans(self, tmp_path):
        system = StreamSystem(strategy="signature", device="cpu", base_batch=BATCH,
                              checkpoint_dir=str(tmp_path / "ck"))
        system.configure_obs(trace=True)
        for df in _fig1(flow):
            system.submit(df)
        system.run(2)
        system.checkpoint()
        snap = system.metrics_snapshot()
        assert snap_value(snap, "repro_checkpoints_total") == 1.0
        assert snap_value(snap, "repro_checkpoint_save_ms")["count"] == 1
        names = {s["name"] for s in system.drain_spans() if s["cat"] == "checkpoint"}
        assert {"ckpt_encode", "ckpt_fsync"} <= names
        system.close()

    def test_control_plane_session_has_no_metrics(self):
        from repro_torch.core import DataflowError

        session = ReuseSession()
        with pytest.raises(DataflowError):
            session.metrics_snapshot()
        with pytest.raises(DataflowError):
            session.configure_obs(trace=True)
