"""The port's segment-step cache against the reference's compile cache.

``repro_torch.runtime.compile_cache`` is a copy of
``repro.runtime.compile_cache`` whose artifact is the canonical torch step
instead of a jitted executable. Held here on the CPU:

  * ``structural_signature`` returns the reference's hex string for the
    same specs (unfused and fused, fan-in order, external parents, batch
    and config changes, publish sets);
  * ``TorchBackend.compile_cache_stats()`` equals the reference's
    ``inprocess`` backend's exactly on the scenarios of
    ``tests/test_fusion_optimizer.py::TestCompileCache``, on Fig. 1 and on
    a prefix of the OPMW rw1 trace (``rw_trace(seed=11)``), after every
    event, ``defragment()`` included;
  * after ``defragment()`` the checkpoint payload's segment specs are the
    reference's;
  * segments that hit the cache share the canonical operators, and their
    sink digests equal those of the segment that missed;
  * ``fuse()`` under ``checkpoint_background`` builds the reference's
    segment specs (not fused), so payloads and cache keys agree;
  * what of the captured step runs without a card: ``capture`` has no
    effect on the CPU, and a capture takes back the kernel launches it
    counted, which each replay adds again.
"""
import pytest
import torch

from repro.api import ReuseSession as RefSession
from repro.api import flow as ref_flow
from repro.core.graph import Dataflow as RefDataflow
from repro.core.graph import Task as RefTask
from repro.runtime.backend import SegmentSpec as RefSpec
from repro.runtime.compile_cache import CompileCache as RefCache
from repro.runtime.compile_cache import structural_signature as ref_signature
from repro.runtime.segment import build_segment as ref_build_segment
from repro.runtime.system import StreamSystem as RefSystem
from repro.workloads import opmw_workload as ref_opmw
from repro.workloads import rw_trace as ref_rw_trace
from repro_torch.api import ReuseSession, flow
from repro_torch.core.graph import Dataflow, Task
from repro_torch.runtime.backend import SegmentSpec
from repro_torch.runtime.compile_cache import CompileCache, structural_signature
from repro_torch.runtime.segment import build_segment, donation_report
from repro_torch.runtime.system import StreamSystem
from repro_torch.workloads import opmw_workload, replay, rw_trace

PREFIX = 30  # rw1 events against inprocess (as tests/test_torch_traces.py)
STAGES = [("senml_parse", {"scale": 2.0, "offset": 0.5}), ("kalman", {"q": 0.1})]
PACKAGES = {
    "port": (Dataflow, Task, SegmentSpec, structural_signature),
    "ref": (RefDataflow, RefTask, RefSpec, ref_signature),
}


def _chain(package, name, stages, source="urban", sink="store"):
    """source → stages → sink, as tests/helpers.py:chain_df, in either package."""
    dataflow, task = PACKAGES[package][:2]
    d = dataflow(name)
    prev = d.add_task(task.make(f"{name}.src.{source}", source, "SOURCE"))
    for i, (typ, cfg) in enumerate(stages):
        t = d.add_task(task.make(f"{name}.{i}.{typ}", typ, cfg))
        d.add_stream(prev.id, t.id)
        prev = t
    snk = d.add_task(task.make(f"{name}.sink.{sink}", sink, "SINK"))
    d.add_stream(prev.id, snk.id)
    return d


def _fig1(fl):
    """Paper Fig. 1: A, B, C share a source + prefix; D has another source."""

    def build(name, chain, source, sink):
        b = fl(name).source(source)
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


# -- structural signatures --------------------------------------------------------

# (task ids, {task: (type, config)}, parents, options): each case names a
# structure; the signature must be the reference's byte for byte
SIG_CASES = {
    "unfused": (["a.k", "a.s"], {"a.k": ("kalman", {"q": 0.1}), "a.s": ("store", "SINK")},
                {"a.k": ["up.x"], "a.s": ["a.k"]}, {}),
    "fused": (["a.k", "a.s"], {"a.k": ("kalman", {"q": 0.1}), "a.s": ("store", "SINK")},
              {"a.k": ["up.x"], "a.s": ["a.k"]}, {"fused": True}),
    "renamed": (["b.k2", "b.s9"], {"b.k2": ("kalman", {"q": 0.1}), "b.s9": ("store", "SINK")},
                {"b.k2": ["up.y"], "b.s9": ["b.k2"]}, {}),
    "fan-in": (["p", "q", "j"], {"p": ("senml_parse", {"scale": 2.0}), "q": ("avg", {}),
                                 "j": ("join", {})},
               {"p": ["x1"], "q": ["x2"], "j": ["p", "q"]}, {}),
    "fan-in reversed": (["p", "q", "j"], {"p": ("senml_parse", {"scale": 2.0}), "q": ("avg", {}),
                                         "j": ("join", {})},
                        {"p": ["x1"], "q": ["x2"], "j": ["q", "p"]}, {}),
    "external parents": (["j", "k"], {"j": ("join", {}), "k": ("kalman", {"q": 0.3})},
                         {"j": ["e2", "e1"], "k": ["j", "e1"]}, {}),
    "batch 16": (["a.k", "a.s"], {"a.k": ("kalman", {"q": 0.1}), "a.s": ("store", "SINK")},
                 {"a.k": ["up.x"], "a.s": ["a.k"]}, {"batch": 16}),
    "config change": (["a.k", "a.s"], {"a.k": ("kalman", {"q": 0.2}), "a.s": ("store", "SINK")},
                      {"a.k": ["up.x"], "a.s": ["a.k"]}, {}),
    "published": (["a.k", "a.s"], {"a.k": ("kalman", {"q": 0.1}), "a.s": ("store", "SINK")},
                  {"a.k": ["up.x"], "a.s": ["a.k"]}, {"publish": ("a.k",)}),
}


def _signature(package, case):
    tids, tasks, parents, opts = SIG_CASES[case]
    dataflow, task, spec_cls, signature = PACKAGES[package]
    df = dataflow("d")
    for tid in tids:
        df.add_task(task.make(tid, *tasks[tid]))
    batch = opts.get("batch", 8)
    spec = spec_cls(
        name="s", dag_name="d", task_ids=list(tids),
        parents={t: list(parents[t]) for t in tids}, publish=set(opts.get("publish", ())),
        batch_of={t: batch for t in tids}, fused=opts.get("fused", False),
    )
    return signature(spec, df)


@pytest.mark.parametrize("case", sorted(SIG_CASES))
def test_structural_signature_is_the_references(case):
    got = _signature("port", case)
    assert len(got) == 64 and got == _signature("ref", case)


def test_structural_signature_keeps_what_the_step_depends_on():
    sig = {case: _signature("port", case) for case in SIG_CASES}
    assert sig["renamed"] == sig["unfused"] == sig["published"]  # names, topics, publish erased
    for case in ("fused", "batch 16", "config change"):
        assert sig[case] != sig["unfused"], case
    assert sig["fan-in"] != sig["fan-in reversed"]  # concatenation order is semantics


# -- cache counters against the reference's inprocess backend --------------------------


def _systems(**kw):
    """The same StreamSystem in both packages: the port on the CPU, the
    reference on its inprocess backend."""
    return (StreamSystem(device="cpu", **kw), RefSystem(backend="inprocess", **kw))


def _cache(session):
    st = session.stats()
    return {k: getattr(st, f"compile_cache_{k}") for k in ("hits", "misses", "evictions", "entries")}


def _stats(port, ref):
    return port.backend.compile_cache_stats(), ref.backend.compile_cache_stats()


def test_identical_resubmissions_hit_and_share_the_step():
    port, ref = _systems(strategy="none")
    for i in range(3):  # Default strategy: each copy deploys its own segment
        port.submit(_chain("port", f"c{i}", STAGES))
        ref.submit(_chain("ref", f"c{i}", STAGES))
    port.run(2)
    ref.run(2)
    got, want = _stats(port, ref)
    assert got == want == {"hits": 2, "misses": 1, "evictions": 0, "entries": 1}
    # cache-hit segments step the canonical operators under their own ids
    segs = list(port.backend.segments.values())
    ops = [list(s.operators.values()) for s in segs]
    assert all(a is b for a, b in zip(ops[0], ops[1])) and all(a is b for a, b in zip(ops[0], ops[2]))
    d = [port.sink_digests(f"c{i}") for i in range(3)]
    assert list(d[0].values()) == list(d[1].values()) == list(d[2].values())
    ref.close()


def test_config_change_misses():
    port, ref = _systems(strategy="none")
    other = [("senml_parse", {"scale": 3.0}), ("kalman", {"q": 0.1})]
    for system, package in ((port, "port"), (ref, "ref")):
        system.submit(_chain(package, "a", STAGES))
        system.submit(_chain(package, "b", other))
        system.step()
    got, want = _stats(port, ref)
    assert got == want and got["misses"] == 2 and got["hits"] == 0
    ref.close()


def test_a_fresh_backend_starts_cold():
    for _ in range(2):
        port, ref = _systems(strategy="none")
        port.submit(_chain("port", "a", STAGES))
        ref.submit(_chain("ref", "a", STAGES))
        port.step()
        ref.step()
        got, want = _stats(port, ref)
        assert got == want == {"hits": 0, "misses": 1, "evictions": 0, "entries": 1}
        ref.close()


def test_restore_is_cold_then_hits(tmp_path):
    stats = {}
    for package, cls, kw in (("port", StreamSystem, {"device": "cpu"}),
                             ("ref", RefSystem, {"backend": "inprocess"})):
        root = str(tmp_path / package)
        system = cls(strategy="none", checkpoint_dir=root, **kw)
        system.submit(_chain(package, "a", STAGES))
        system.run(3)
        want = system.sink_digests("a")
        system.checkpoint()
        system.close()
        restored = cls.restore(root, **({"device": "cpu"} if package == "port" else {}))
        cold = restored.backend.compile_cache_stats()
        assert restored.sink_digests("a") == want
        restored.submit(_chain(package, "b", STAGES))  # the same structure: warm now
        restored.step()
        stats[package] = (cold, restored.backend.compile_cache_stats())
        restored.close()
    assert stats["port"] == stats["ref"]
    cold, warm = stats["port"]
    assert cold["hits"] == 0 and cold["misses"] == 1 and warm["hits"] == 1


def test_lru_eviction_at_capacity_one():
    port_cache, ref_cache = CompileCache("cpu", capacity=1), RefCache(capacity=1)
    for q in (0.1, 0.2, 0.3):
        for package, cache, build in (("port", port_cache, build_segment),
                                      ("ref", ref_cache, ref_build_segment)):
            dataflow, task, spec_cls, _ = PACKAGES[package]
            df = dataflow("d")
            df.add_task(task.make("t", "kalman", {"q": q}))
            spec = spec_cls(name="s", dag_name="d", task_ids=["t"], parents={"t": ["x"]},
                            publish=set(), batch_of={"t": 8})
            if package == "port":
                build(spec, df, cache=cache, device="cpu")
            else:
                build(spec, df, cache=cache)
    assert port_cache.stats() == ref_cache.stats() == {
        "hits": 0, "misses": 3, "evictions": 2, "entries": 1}


def test_a_cache_serves_one_device():
    """Each device gets a canonical step of its own beneath one structural
    key, counted once, as the reference's one cache counts a structure for
    every device; an uncounted build (a move) counts nothing."""
    df = Dataflow("d")
    df.add_task(Task.make("t", "kalman", {"q": 0.1}))
    spec = SegmentSpec(name="s", dag_name="d", task_ids=["t"], parents={"t": ["x"]},
                       publish=set(), batch_of={"t": 8})
    cache = CompileCache("meta")
    on_meta = build_segment(spec, df, cache=cache, device="meta")
    on_cpu = build_segment(spec, df, cache=cache, device="cpu")
    again = build_segment(spec, df, cache=cache, device="cpu", count=False)
    assert cache.stats() == {"hits": 1, "misses": 1, "evictions": 0, "entries": 1}
    assert on_meta.step_fn._fn is not on_cpu.step_fn._fn
    assert again.step_fn._fn is on_cpu.step_fn._fn
    assert on_cpu.states["t"]["p"].device.type == "cpu"


def test_session_stats_surface():
    port = ReuseSession(strategy="none", execute=True, device="cpu")
    ref = RefSession(strategy="none", execute=True, backend="inprocess")
    for session, fl in ((port, flow), (ref, ref_flow)):
        for name in ("a", "b"):
            session.submit(fl(name).source("urban").then("senml_parse", scale=2.0, offset=0.5)
                           .then("kalman", q=0.1).sink("store"))
        session.step()
    got, want = port.stats(), ref.stats()
    for key in ("hits", "misses", "entries", "evictions"):
        assert getattr(got, f"compile_cache_{key}") == getattr(want, f"compile_cache_{key}"), key
    assert (got.compile_cache_hits, got.compile_cache_misses) == (1, 1)
    ref.close()


@pytest.mark.parametrize("strategy", ["signature", "none"])
def test_fig1_counters_equal_the_references_after_every_event(strategy):
    # submit, step after each; fuse; remove B and submit it again; defragment
    port = ReuseSession(strategy=strategy, execute=True, device="cpu", base_batch=8)
    ref = RefSession(strategy=strategy, execute=True, backend="inprocess", base_batch=8)
    trail = {"port": [], "ref": []}
    for key, session, fl in (("port", port, flow), ("ref", ref, ref_flow)):
        flows = _fig1(fl)
        for df in flows:
            session.submit(df)
            session.step()
            trail[key].append(_cache(session))
        session.fuse()
        session.step()
        trail[key].append(_cache(session))
        session.remove("B")
        session.step()
        session.submit(flows[1])
        session.step()
        trail[key].append(_cache(session))
        session.defragment()
        session.step()
        trail[key].append(_cache(session))
    assert trail["port"] == trail["ref"]
    assert trail["port"][-1]["misses"] >= 4
    ref.close()


def test_rw1_prefix_counters_equal_the_references():
    dags = opmw_workload()
    port = ReuseSession(execute=True, device="cpu", base_batch=4)
    ref_dags = ref_opmw()
    ref = RefSession(execute=True, backend="inprocess", base_batch=4)
    trails = []
    for session, ds, events in ((port, dags, rw_trace(dags, seed=11)[:PREFIX]),
                                (ref, ref_dags, ref_rw_trace(ref_dags, seed=11)[:PREFIX])):
        trail = []
        for _ev, _receipt in replay(session, ds, events):
            session.step()
            trail.append(_cache(session))
        session.defragment()
        session.step()
        trail.append(_cache(session))
        trails.append(trail)
    assert len(trails[0]) == PREFIX + 1
    assert trails[0] == trails[1]
    assert trails[0][-1]["misses"] > 0
    ref.close()


def test_defragment_payload_specs_are_the_references():
    # the defragment repair: the relaunched segments are not fusion-built,
    # so their specs (and cache keys) are the reference's
    specs = {}
    for package, cls, fl, kw in (("port", StreamSystem, flow, {"device": "cpu"}),
                                 ("ref", RefSystem, ref_flow, {"backend": "inprocess"})):
        system = cls(strategy="signature", base_batch=8, **kw)
        for df in _fig1(fl):
            system.submit(df)
        system.run(2)
        system.remove("B")
        system.defragment()
        system.run(1)
        specs[package] = [{k: v for k, v in rec.items() if k != "states"}
                          for rec in system.checkpoint_payload()["data"]["segments"]]
        system.close()
    assert specs["port"] == specs["ref"]
    assert specs["port"] and not any(rec["fused"] for rec in specs["port"])


# -- fuse() under background checkpointing ---------------------------------------------


def test_fuse_under_background_checkpoints_builds_the_references_specs(tmp_path):
    specs = {}
    for package, cls, kw in (("port", StreamSystem, {"device": "cpu"}),
                             ("ref", RefSystem, {"backend": "inprocess"})):
        system = cls(strategy="signature", checkpoint_dir=str(tmp_path / package),
                     checkpoint_every=1, checkpoint_background=True, **kw)
        for name, stages in (("A", STAGES), ("B", STAGES + [("win", {"w": 4})])):
            system.submit(_chain(package, name, stages))
        system.run(2)
        assert system.fuse()
        system.run(1)
        payload = system.checkpoint_payload()
        specs[package] = [{k: v for k, v in rec.items() if k != "states"}
                          for rec in payload["data"]["segments"]]
        system.close()
    assert specs["port"] == specs["ref"]
    assert not any(rec["fused"] for rec in specs["port"])


def test_donation_report_on_the_cpu_aliases_nothing():
    port = StreamSystem(strategy="signature", device="cpu")
    port.submit(_chain("port", "a", STAGES))
    port.run(1)
    seg = next(iter(port.backend.segments.values()))
    report = donation_report(seg, {})
    assert report == {"fused": False, "donation_holds": False, "alias_size_in_bytes": 0}


def test_one_process_cache_per_device():
    from repro_torch.runtime.compile_cache import process_compile_cache

    cache = process_compile_cache("cpu")
    assert cache is process_compile_cache(torch.device("cpu"))
    assert cache.device == torch.device("cpu") and isinstance(cache, CompileCache)


# -- the captured step's bookkeeping that runs on the CPU -------------------------------


def test_capture_has_no_effect_on_the_cpu():
    from repro_torch.runtime.executor import TorchBackend

    backend = TorchBackend(device="cpu", capture=True)
    port = StreamSystem(strategy="none", backend=backend)
    port.submit(_chain("port", "a", STAGES))
    port.run(2)
    assert not backend.capture
    assert all(seg.graphs is None for seg in backend.segments.values())
    assert backend.capture_stats.graphs == 0


def test_a_capture_takes_its_launches_back_and_each_replay_adds_them():
    from repro_torch.kernels import build

    build.reset_launch_counts()
    build.count_launch("kalman_scan")
    with build.recording_launches() as recorded:
        build.count_launch("rmsnorm")
        build.count_launch("kalman_scan")
        build.count_launch("kalman_scan")
    assert recorded == {"rmsnorm": 1, "kalman_scan": 2}
    counts = build.launch_counts()
    assert counts["kalman_scan"] == 1 and counts["rmsnorm"] == 0
    for _ in range(3):
        build.add_launches(recorded)
    counts = build.launch_counts()
    assert counts["kalman_scan"] == 7 and counts["rmsnorm"] == 3
    build.reset_launch_counts()
