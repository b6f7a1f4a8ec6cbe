"""The port's in-process ``torch`` backend over each stream transport, and
the reference accessors of its system and backends.

  * ``StreamSystem(backend="torch", transport=t)`` for ``t`` in inproc,
    shm and tcp: Fig. 1 churn (with ``defragment()``) gives sink digests
    bitwise equal across the three, in sync and concurrent mode, and
    within 2e-5 of the reference's ``inprocess`` backend over the same
    transport (counts exact);
  * over shm and tcp a boundary batch crosses the host as a private copy:
    no state aliases the ring, and the boundary topics hold numpy arrays;
  * the transport is recorded in ``spawn_config`` and a checkpoint's
    ``backend_config``; a payload restores onto the same transport, and a
    reference ``inprocess`` payload written over shm restores on ``torch``
    over shm, with its broker buffers;
  * ``StreamSystem.executor``, ``.strategy``, ``.placement()`` and
    ``ExecutionBackend.live_task_count`` equal the reference's on Fig. 1,
    and ``available_backends()`` lists the reference's backends (with
    ``torch`` for ``inprocess``).

Everything steps on the CPU (``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.api import flow as ref_flow
from repro.runtime.backend import available_backends as ref_available_backends
from repro.runtime.system import StreamSystem as RefSystem
from repro_torch.api import flow
from repro_torch.runtime.backend import available_backends
from repro_torch.runtime.staging import HostStaging
from repro_torch.runtime.system import StreamSystem
from repro_torch.runtime.transport import InProcTransport, ShmTransport, TcpTransport

BATCH = 16
CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
TRANSPORTS = ["inproc", "shm", "tcp"]
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


def _assert_close_to_reference(got, want):
    assert _counts(got) == _counts(want)
    for sub, sinks in want.items():
        for sink, dg in sinks.items():
            np.testing.assert_allclose(got[sub][sink]["checksum"], dg["checksum"], **CHECKSUM_TOL)


def _run(package, transport, step_mode="sync", tail_steps=2):
    dags = _fig1(ref_flow if package == "ref" else flow)
    if package == "ref":
        system = RefSystem(backend="inprocess", transport=transport, base_batch=BATCH,
                           step_mode=step_mode)
    else:
        system = StreamSystem(backend="torch", device="cpu", transport=transport,
                              base_batch=BATCH, step_mode=step_mode)
    for op, name in FIG1_OPS:
        _apply(system, dags, op, name)
        system.step()
    system.run(tail_steps)
    digests = _digests(system)
    system.close()
    return digests


@pytest.fixture(scope="module")
def inproc_sync():
    return _run("port", "inproc")


@pytest.mark.parametrize("step_mode", ["sync", "concurrent"])
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_fig1_digests_bitwise_across_transports(inproc_sync, transport, step_mode):
    assert _run("port", transport, step_mode) == inproc_sync


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_fig1_within_tolerance_of_the_reference_over_the_same_transport(inproc_sync, transport):
    _assert_close_to_reference(inproc_sync, _run("ref", transport))


@pytest.mark.parametrize("transport,cls", [("inproc", InProcTransport), ("shm", ShmTransport),
                                           ("tcp", TcpTransport)])
def test_transport_resolved_recorded_and_aliased(transport, cls):
    system = StreamSystem(backend="torch", device="cpu", transport=transport, base_batch=BATCH)
    be = system.backend
    assert isinstance(be.transport, cls) and be.broker is be.transport
    assert be.spawn_config() == {"transport": transport}
    system.submit(_fig1(flow)["A"].copy())
    system.step()
    payload = system.checkpoint_payload()
    assert payload["backend_config"] == {"transport": transport}
    restored = StreamSystem.from_payload(payload, device="cpu")
    assert isinstance(restored.backend.transport, cls)
    system.run(2)
    restored.run(2)
    assert _digests(restored) == _digests(system)
    restored.close()
    system.close()


@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_host_transports_hold_numpy_batches_and_no_state_aliases_them(transport):
    system = StreamSystem(backend="torch", device="cpu", transport=transport, base_batch=BATCH)
    dags = _fig1(flow)
    system.submit(dags["A"].copy())
    system.submit(dags["B"].copy())
    system.run(2)
    topics = system.backend.transport.topics()
    assert topics and all(isinstance(b, np.ndarray) for b in topics.values())
    payload = system.checkpoint_payload()
    assert sorted(payload["data"]["extra"]["broker"]) == sorted(topics)
    # a fetched input is the segment's own memory: writing it leaves the ring as it was
    seg = next(s for s in system.backend.segments.values() if s.boundary_topics)
    topic = seg.boundary_topics[0]
    fetched = system.backend._fetch_inputs(seg)[topic]
    before = system.backend.transport.fetch(topic, copy=True)
    fetched.fill_(12345.0)
    np.testing.assert_array_equal(system.backend.transport.fetch(topic, copy=True), before)
    system.close()


def test_host_staging_on_the_cpu_copies_inputs_and_passes_outputs_through():
    import torch

    t = ShmTransport()
    try:
        batch = np.arange(32, dtype=np.float32).reshape(4, 8)
        t.publish("x", batch)
        staging = HostStaging(torch.device("cpu"))
        got = staging.fetch(t, "x", None)
        assert got.is_contiguous()
        got.zero_()
        np.testing.assert_array_equal(t.fetch("x", copy=True), batch)
        assert staging.fetch(t, "x", 1).sum().item() == batch.sum()
        out = {"a": torch.ones(2, 3), "b": torch.zeros(1)}
        host = staging.to_host(out, ["a"])
        assert list(host) == ["a"] and np.shares_memory(host["a"], out["a"].numpy())
    finally:
        t.close()


def test_a_reference_inprocess_payload_over_shm_restores_on_torch_over_shm():
    dags = _fig1(ref_flow)
    ref = RefSystem(backend="inprocess", transport="shm", base_batch=BATCH)
    ref.submit(dags["A"].copy())
    ref.submit(dags["B"].copy())
    ref.run(3)
    payload = ref.checkpoint_payload()
    ref.run(2)
    want = _digests(ref)
    ref.close()
    assert payload["backend"] == "inprocess"
    assert payload["backend_config"] == {"transport": "shm"}
    assert payload["data"]["extra"]["broker"]
    got = StreamSystem.from_payload(payload, backend="torch", device="cpu")
    try:
        assert isinstance(got.backend.transport, ShmTransport)
        assert got.backend.template_fallbacks == 0
        assert sorted(got.backend.transport.topics()) == sorted(payload["data"]["extra"]["broker"])
        got.run(2)
        _assert_close_to_reference(_digests(got), want)
    finally:
        got.close()


def test_accessors_equal_the_references():
    dags = {"port": _fig1(flow), "ref": _fig1(ref_flow)}
    systems = {
        "port": StreamSystem(backend="torch", device="cpu", base_batch=BATCH),
        "ref": RefSystem(backend="inprocess", base_batch=BATCH),
    }
    seen = {}
    for key, system in systems.items():
        rows = []
        for op, name in FIG1_OPS:
            _apply(system, dags[key], op, name)
            system.step()
            placement = system.placement()
            rows.append((
                system.executor is system.backend,
                system.strategy,
                placement.assignments,
                placement.nodes_used,
                placement.workers_used,
                system.backend.live_task_count,
                system.executor.live_task_count == system.backend.account()[0],
            ))
        seen[key] = rows
        system.close()
    assert seen["port"] == seen["ref"]
    assert all(row[0] and row[-1] for row in seen["port"])


def test_available_backends_are_the_references():
    assert set(available_backends()) == (set(ref_available_backends()) - {"inprocess"}) | {
        "torch"}
    assert "sharded" in available_backends()
