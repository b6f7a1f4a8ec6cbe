"""Crash recovery of the port, and checkpoints across the packages
(``tests/test_recovery.py``'s contract).

Kill the data plane after any event, restore from the newest on-disk
checkpoint, and the resumed run's sink digests, Fig. 2 series and
``account()`` totals equal an uninterrupted run's: bitwise on the same
backend. Checkpoints cross backends and packages: the reference's
``inprocess`` → the port's ``torch`` and back (counts exact, checksums
within 2e-5, as between the two data planes in tests/test_torch_system.py,
and no state leaf reset to its operator's template), ``torch`` ⇄
``dryrun`` (counts exact).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.api import flow as ref_flow
from repro.ops import operator_for_task as ref_operator_for_task
from repro.runtime.checkpoint import decode_pytree as ref_decode_pytree
from repro.runtime.system import StreamSystem as RefSystem
from repro_torch.api import ReuseSession, flow
from repro_torch.core.graph import Task
from repro_torch.ops import operator_for_task
from repro_torch.runtime.checkpoint import (
    CheckpointError,
    CheckpointStore,
    DeferredState,
    decode_pytree,
    encode_deferred,
    encode_pytree,
    is_checkpoint_path,
)
from repro_torch.runtime.system import StreamSystem

CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
BATCH = 16

# (op, name); every event is followed by exactly one step() (as in
# tests/test_recovery.py)
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
    def build(name, chain, source, sink):
        b = builder(name).source(source)
        for typ, cfg in chain:
            b.then(typ, **cfg)
        return b.sink(sink).build()

    pk = [("parse", {}), ("kalman", {"q": 0.1})]
    return {
        df.name: df
        for df in (
            build("A", pk, "urban", "store_a"),
            build("B", pk + [("win", {"w": 10})], "urban", "store_b"),
            build("C", pk + [("win", {"w": 10}), ("avg", {})], "urban", "store_c"),
            build("D", pk, "meter", "store_d"),
        )
    }


def _new(package, backend, **kw):
    if package == "ref":
        return RefSystem(strategy="signature", backend=backend, base_batch=BATCH, **kw)
    extra = {"device": "cpu"} if backend == "torch" else {}
    return StreamSystem(strategy="signature", backend=backend, base_batch=BATCH, **extra, **kw)


def _apply(system, dags, op, name):
    if op == "add":
        system.submit(dags[name].copy())
    elif op == "remove":
        system.remove(name)
    else:
        system.defragment()


def _final(system):
    digests = {n: system.sink_digests(n) for n in system.manager.submitted}
    return digests, system.backend.account()


def _run(package, backend, ops=FIG1_OPS):
    system = _new(package, backend)
    dags = _fig1(ref_flow if package == "ref" else flow)
    series = []
    for op, name in ops:
        _apply(system, dags, op, name)
        rep = system.step()
        series.append((rep.live_tasks, rep.paused_tasks, rep.cost))
    return series, *_final(system), system


def _run_with_crash(package, backend, kill_at, ckpt_dir, restore=("port", "torch"), ops=FIG1_OPS):
    """Checkpoint every step, 'crash' after event ``kill_at``, restore from
    disk into ``restore`` = (package, backend), finish the trace."""
    system = _new(package, backend, checkpoint_dir=ckpt_dir, checkpoint_every=1)
    dags = _fig1(ref_flow if package == "ref" else flow)
    series = []
    for op, name in ops[: kill_at + 1]:
        _apply(system, dags, op, name)
        rep = system.step()
        series.append((rep.live_tasks, rep.paused_tasks, rep.cost))
    del system  # the crash: only the checkpoints remain
    r_package, r_backend = restore
    if r_package == "ref":
        restored = RefSystem.restore(ckpt_dir, backend=r_backend)
    else:
        extra = {"device": "cpu"} if r_backend == "torch" else {}
        restored = StreamSystem.restore(ckpt_dir, backend=r_backend, **extra)
    dags = _fig1(ref_flow if r_package == "ref" else flow)
    for op, name in ops[kill_at + 1:]:
        _apply(restored, dags, op, name)
        rep = restored.step()
        series.append((rep.live_tasks, rep.paused_tasks, rep.cost))
    return series, *_final(restored), restored


def _assert_same_run(base, crashed, checksums="bitwise"):
    b_series, b_digests, b_acct, _ = base
    c_series, c_digests, c_acct, _ = crashed
    assert [s[:2] for s in c_series] == [s[:2] for s in b_series]
    np.testing.assert_allclose([s[2] for s in c_series], [s[2] for s in b_series], rtol=1e-12)
    assert c_acct[:2] == b_acct[:2]
    assert c_digests.keys() == b_digests.keys()
    for sub in b_digests:
        assert c_digests[sub].keys() == b_digests[sub].keys()
        for sink, dg in b_digests[sub].items():
            got = c_digests[sub][sink]
            assert got["count"] == dg["count"], (sub, sink)
            if checksums == "bitwise":
                assert got["checksum"] == dg["checksum"], (sub, sink)
            elif checksums == "close":
                np.testing.assert_allclose(got["checksum"], dg["checksum"], **CHECKSUM_TOL)


_BASELINES = {}


def _baseline(package, backend):
    if (package, backend) not in _BASELINES:
        _BASELINES[package, backend] = _run(package, backend)
    return _BASELINES[package, backend]


# -- the codec on torch tensors ------------------------------------------------------


class TestTensorCodec:
    @pytest.mark.parametrize("tensor", [
        torch.arange(12, dtype=torch.float32).reshape(3, 4),
        torch.tensor(5, dtype=torch.int32),  # 0-d: the sink count
        torch.tensor(-0.0),
        torch.arange(8.0)[::2],  # a strided view
        torch.zeros((0, 4), dtype=torch.float64),
        torch.tensor([True, False]),
        torch.tensor([float("nan"), float("inf"), 1e-45]),
    ], ids=["2d", "0d-int", "0d-negzero", "strided", "empty", "bool", "nonfinite"])
    def test_round_trips_bit_exact(self, tensor):
        enc = encode_pytree({"s": (tensor,)})
        out = decode_pytree(json.loads(json.dumps(enc)))["s"][0]
        assert out.shape == tuple(tensor.shape) and out.dtype == tensor.numpy().dtype
        assert out.tobytes() == tensor.contiguous().numpy().tobytes()
        # the reference decodes what the port encodes, byte for byte
        assert ref_decode_pytree(enc)["s"][0].tobytes() == out.tobytes()

    def test_bfloat16_raises(self):
        with pytest.raises(CheckpointError, match="bfloat16"):
            encode_pytree({"x": torch.ones(2, dtype=torch.bfloat16)})

    def test_deferred_state_waits_on_its_event(self):
        class Ready:
            waited = 0

            def synchronize(self):
                Ready.waited += 1

        enc = encode_deferred({"a": DeferredState(torch.ones(2), Ready()), "b": [DeferredState(3)]})
        assert Ready.waited == 1 and enc["b"] == [3]
        assert np.array_equal(decode_pytree(enc["a"]), np.ones(2, np.float32))


# -- kill and restore on the same backend ---------------------------------------------


@pytest.mark.parametrize("kill_at", range(len(FIG1_OPS)))
def test_torch_kill_and_restore_is_bitwise(kill_at, ckpt_dir):
    base = _baseline("port", "torch")
    crashed = _run_with_crash("port", "torch", kill_at, ckpt_dir)
    _assert_same_run(base, crashed, checksums="bitwise")


@pytest.mark.parametrize("kill_at", [0, 4, 6])
def test_dryrun_kill_and_restore(kill_at, ckpt_dir):
    base = _baseline("port", "dryrun")
    crashed = _run_with_crash("port", "dryrun", kill_at, ckpt_dir, restore=("port", "dryrun"))
    _assert_same_run(base, crashed)


# -- across backends and packages ----------------------------------------------------


@pytest.mark.parametrize("kill_at", [3, 5])
def test_inprocess_checkpoint_restores_on_torch(kill_at, ckpt_dir):
    base = _baseline("ref", "inprocess")
    crashed = _run_with_crash("ref", "inprocess", kill_at, ckpt_dir, restore=("port", "torch"))
    assert crashed[3].backend.name == "torch"
    assert crashed[3].backend.template_fallbacks == 0
    _assert_same_run(base, crashed, checksums="close")


@pytest.mark.parametrize("kill_at", [3, 5])
def test_torch_checkpoint_restores_on_inprocess(kill_at, ckpt_dir):
    base = _baseline("port", "torch")
    crashed = _run_with_crash("port", "torch", kill_at, ckpt_dir, restore=("ref", "inprocess"))
    assert crashed[3].backend.name == "inprocess"
    _assert_same_run(base, crashed, checksums="close")


def test_torch_checkpoint_restores_on_dryrun(ckpt_dir):
    base = _baseline("port", "torch")
    crashed = _run_with_crash("port", "torch", 4, ckpt_dir, restore=("port", "dryrun"))
    assert crashed[3].backend.name == "dryrun"
    _assert_same_run(base, crashed, checksums=None)


def test_dryrun_checkpoint_restores_on_torch(ckpt_dir):
    base = _baseline("port", "torch")
    crashed = _run_with_crash("port", "dryrun", 4, ckpt_dir, restore=("port", "torch"))
    restored = crashed[3]
    assert restored.backend.name == "torch"
    # a dry-run checkpoint holds sink counters only: every other leaf, and
    # the sinks' last batches, start from their templates
    assert restored.backend.template_fallbacks > 0
    _assert_same_run(base, crashed, checksums=None)


def _leaf_misses(value, template):
    """Leaves of ``template`` that ``value`` does not match in structure,
    shape or dtype (what a restore would reset or cast)."""
    if isinstance(template, dict):
        if not isinstance(value, dict) or value.keys() != template.keys():
            return [template]
        return [m for k in template for m in _leaf_misses(value[k], template[k])]
    if isinstance(template, (tuple, list)):
        if not isinstance(value, (tuple, list)) or len(value) != len(template):
            return [template]
        return [m for v, t in zip(value, template) for m in _leaf_misses(v, t)]
    t = template.numpy() if isinstance(template, torch.Tensor) else np.asarray(template)
    v = np.asarray(value)
    return [] if (v.shape, v.dtype) == (t.shape, t.dtype) else [(v.shape, v.dtype, t.shape, t.dtype)]


def _misses_against(payload, make_op):
    misses = {}
    for rec in payload["data"]["segments"]:
        for tid, enc in rec["states"].items():
            task = rec["tasks"][tid]
            batch = rec["batch_of"][tid]
            op = make_op(Task.make(tid, task["type"], task["config"]), batch)
            got = _leaf_misses(decode_pytree(enc), op.init_state(batch))
            if got:
                misses[tid] = got
    return misses


@pytest.mark.parametrize("stop", [4, 6, 8])
def test_no_leaf_falls_back_between_inprocess_and_torch(stop):
    """Every state leaf of either package's checkpoint has the other's
    template shape and dtype, and both checkpoints deploy the same segments."""
    port, ref = _new("port", "torch"), _new("ref", "inprocess")
    for system, builder in ((port, flow), (ref, ref_flow)):
        dags = _fig1(builder)
        for op, name in FIG1_OPS[:stop]:
            _apply(system, dags, op, name)
            system.step()
    port_payload, ref_payload = port.checkpoint_payload(), ref.checkpoint_payload()
    layout = lambda p: [(r["name"], r["task_ids"], r["batch_of"], r["publish"])  # noqa: E731
                        for r in p["data"]["segments"]]
    assert layout(port_payload) == layout(ref_payload)
    untimed = lambda p: [{k: v for k, v in e.items() if k != "ts"} for e in p["journal"]]  # noqa: E731
    assert untimed(port_payload) == untimed(ref_payload)
    assert _misses_against(ref_payload, lambda t, b: operator_for_task(t, batch=b)) == {}
    assert _misses_against(port_payload, lambda t, b: ref_operator_for_task(t, batch=b)) == {}


# -- durable lifecycle ----------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "dryrun"])
def test_payload_roundtrip_is_fixed_point(backend):
    system = _new("port", backend)
    dags = _fig1(flow)
    for op, name in FIG1_OPS[:6]:
        _apply(system, dags, op, name)
        system.step()
    payload = system.checkpoint_payload()
    blob = json.dumps(payload, sort_keys=True)
    extra = {"device": "cpu"} if backend == "torch" else {}
    restored = StreamSystem.from_payload(json.loads(blob), **extra)
    assert restored.checkpoint_payload() == payload
    assert restored.backend.snapshot() == system.backend.snapshot()


def test_restore_into_used_backend_raises(ckpt_dir):
    dags = _fig1(flow)
    system = _new("port", "torch")
    system.submit(dags["A"].copy())
    system.checkpoint(ckpt_dir)
    dirty = _new("port", "torch")
    dirty.submit(dags["B"].copy())
    with pytest.raises(ValueError, match="fresh backend"):
        dirty.backend.restore_state(CheckpointStore(ckpt_dir).latest_payload()["data"])


def test_concurrent_payload_raises(ckpt_dir):
    # a payload taken in concurrent mode restores in it (or in sync mode on
    # request); only a step mode neither package has raises
    system = _new("port", "torch")
    system.submit(_fig1(flow)["A"])
    payload = dict(system.checkpoint_payload(), step_mode="concurrent", max_workers=2)
    restored = StreamSystem.from_payload(payload, device="cpu")
    assert (restored.backend.step_mode, restored.backend.max_workers) == ("concurrent", 2)
    assert StreamSystem.from_payload(payload, device="cpu", step_mode="sync").backend.step_mode == "sync"
    with pytest.raises(ValueError, match="step_mode"):
        StreamSystem.from_payload(dict(payload, step_mode="warp"), device="cpu")
    restored.close()


def test_broker_buffers_and_counters_survive(ckpt_dir):
    dags = _fig1(flow)
    system = _new("port", "torch")
    system.submit(dags["A"].copy())
    system.submit(dags["B"].copy())
    system.run(2)
    broker = system.backend.broker
    assert broker.topics()
    system.checkpoint(ckpt_dir)
    rbroker = StreamSystem.restore(ckpt_dir, device="cpu").backend.broker
    assert set(rbroker.topics()) == set(broker.topics())
    for t, batch in broker.topics().items():
        assert torch.equal(rbroker.fetch(t), batch)
    assert rbroker.counters() == broker.counters()


def test_checkpoint_cadence_with_background_writer(ckpt_dir):
    dags = _fig1(flow)
    system = _new("port", "torch", checkpoint_dir=ckpt_dir, checkpoint_every=2,
                  checkpoint_background=True, checkpoint_keep_last=2)
    for name in "ABCD":
        system.submit(dags[name].copy())
    system.run(5)  # checkpoints after steps 2 and 4
    system.flush_checkpoints()
    store = CheckpointStore(ckpt_dir)
    assert store.list_ids() == [1, 2]
    assert store.latest_payload()["data"]["step_count"] == 4
    system.step()  # step 6: a third, and retention keeps the newest two
    system.close()
    assert store.list_ids() == [2, 3]
    restored = StreamSystem.restore(ckpt_dir, device="cpu")
    assert restored.checkpoint_payload() == system.checkpoint_payload()
    assert restored.checkpoint_every == 2 and restored.checkpoint_background


def test_session_restore_reattaches_hooks(ckpt_dir):
    dags = _fig1(flow)
    session = ReuseSession(execute=True, device="cpu", base_batch=BATCH, checkpoint_dir=ckpt_dir)
    session.submit_many([dags["A"], dags["B"]])
    session.run(2)
    path = session.checkpoint()
    assert is_checkpoint_path(path) and is_checkpoint_path(ckpt_dir)
    assert os.path.basename(path) == "ckpt-00000001.json"
    steps = []
    restored = ReuseSession.restore(ckpt_dir, device="cpu", on_step=steps.append)
    restored.run(1)
    session.run(1)
    assert [e.step for e in steps] == [3]
    for name in "AB":
        assert restored.sink_digests(name) == session.sink_digests(name)
    assert restored.stats() == session.stats()


def test_report_history_ring_buffer_survives_restore(ckpt_dir):
    system = _new("port", "torch", report_history=3)
    system.submit(_fig1(flow)["A"])
    system.run(5)
    assert [r.step for r in system.backend.reports] == [3, 4, 5]
    system.checkpoint(ckpt_dir)
    restored = StreamSystem.restore(ckpt_dir, device="cpu")
    assert restored.backend.history_limit == 3
    assert restored.backend.reports == system.backend.reports
    restored.step()
    assert [r.step for r in restored.backend.reports] == [4, 5, 6]


def test_backend_defragment_carries_the_dags_states():
    """The backend verb relaunches the segments deployed under one DAG's
    name as one segment, its states carried over (Default strategy: each
    submission's DAG keeps its name and its segment)."""
    from repro_torch.core.defrag import plan_defrag
    from repro_torch.runtime.backend import SegmentSpec

    dags = _fig1(flow)
    system, twin = (StreamSystem(strategy="none", base_batch=BATCH, device="cpu") for _ in "12")
    for s in (system, twin):
        for name in "AB":
            s.submit(dags[name].copy())
        s.run(2)
    fused = plan_defrag(system.manager.running).fused[0]
    spec = SegmentSpec(name="defrag1", dag_name=fused.dag_name, task_ids=fused.order,
                       parents=fused.parents, publish=set(),
                       batch_of={t: system.task_batch[t] for t in fused.order})
    before = set(system.backend.segments)
    system.backend.defragment(fused.dag_name, spec, system.manager.running[fused.dag_name])
    assert len(before - set(system.backend.segments)) == 1 and "defrag1" in system.backend.segments
    system.run(2)
    twin.run(2)
    assert _final(system)[0] == _final(twin)[0]
