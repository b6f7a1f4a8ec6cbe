"""The port's ``sharded`` backend (``repro_torch.runtime.sharded``) against
the port's ``torch`` backend and the reference's ``ShardedBackend``:

  * three slots of the CPU (``devices=["cpu"] * 3``): Fig. 1 churn (with
    ``defragment()``) gives sink digests bitwise those of ``torch``, in
    sync and concurrent mode and over shm; ``device_of`` after every event
    is the reference's over three slots of its one host device, and so is
    the snapshot's; the compile cache's counters are the reference's;
  * restores ``sharded`` → ``torch``, ``torch`` → ``sharded`` and from a
    payload of the reference's ``sharded`` backend (its placement and
    ``device_of`` carried), sticky placement re-pinning every segment;
  * an injected straggler moves to the other slot (``ewma_aware``) and the
    digests stay bitwise; a move to another device (``cpu`` and ``cpu:0``
    are two devices to torch) rebuilds the segment's step there, digests
    unchanged; across the two devices the one step cache counts what the
    reference's counts, a move included (nothing);
  * without ``devices=`` and without a card the backend raises.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.api import flow as ref_flow
from repro.runtime.sharded import ShardedBackend as RefSharded
from repro.runtime.system import StreamSystem as RefSystem
from repro_torch.api import flow
from repro_torch.runtime.backend import resolve_backend
from repro_torch.runtime.sharded import ShardedBackend
from repro_torch.runtime.system import StreamSystem

BATCH = 16
CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
CPU3 = ["cpu"] * 3
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


def _chain(builder, name, q):
    return builder(name).source("urban").then("kalman", q=q).sink("store").build()


def _apply(system, dags, op, name):
    if op == "add":
        system.submit(dags[name].copy())
    elif op == "remove":
        system.remove(name)
    else:
        system.defragment()


def _digests(system):
    return {n: system.sink_digests(n) for n in sorted(system.manager.submitted)}


def _run(backend, package="port", tail_steps=2):
    """Fig. 1 churn; returns (digests, device_of after each event, cache stats)."""
    dags = _fig1(ref_flow if package == "ref" else flow)
    system = (RefSystem if package == "ref" else StreamSystem)(backend=backend, base_batch=BATCH)
    placements = []
    for op, name in FIG1_OPS:
        _apply(system, dags, op, name)
        system.step()
        placements.append(dict(getattr(system.backend, "device_of", {})))
        assert system.backend.snapshot().device_of == placements[-1]
    system.run(tail_steps)
    out = _digests(system), placements, system.backend.compile_cache_stats()
    system.close()
    return out


@pytest.fixture(scope="module")
def torch_run():
    return _run(resolve_backend("torch", device="cpu"))


@pytest.fixture(scope="module")
def ref_run():
    cpu = jax.devices()[0]
    return _run(RefSharded(devices=[cpu] * 3), package="ref")


@pytest.mark.parametrize("step_mode,transport", [("sync", "inproc"), ("concurrent", "inproc"),
                                                 ("sync", "shm")])
def test_fig1_bitwise_torch_and_placed_as_the_reference(torch_run, ref_run, step_mode,
                                                         transport):
    digests, placements, stats = _run(
        ShardedBackend(devices=CPU3, step_mode=step_mode, transport=transport))
    assert digests == torch_run[0]
    assert placements == ref_run[1]
    assert stats == ref_run[2]
    for sub, sinks in ref_run[0].items():
        for sink, dg in sinks.items():
            assert digests[sub][sink]["count"] == dg["count"]
            np.testing.assert_allclose(digests[sub][sink]["checksum"], dg["checksum"],
                                       **CHECKSUM_TOL)


def test_constructor_defaults_and_validation():
    be = ShardedBackend(devices=CPU3)
    assert be.name == "sharded" and be.devices == [torch.device("cpu")] * 3
    assert be.spawn_config() == {"transport": "inproc", "placement": "round_robin"}
    with pytest.raises(ValueError, match="at least one device"):
        ShardedBackend(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            ShardedBackend()
        with pytest.raises(RuntimeError, match="none is available"):
            StreamSystem(backend="sharded")


def test_restores_across_sharded_and_torch():
    dags = _fig1(flow)
    system = StreamSystem(backend=ShardedBackend(devices=CPU3), base_batch=BATCH)
    for op, name in FIG1_OPS[:5]:
        _apply(system, dags, op, name)
        system.step()
    payload = system.checkpoint_payload()
    assert payload["backend_config"] == {"transport": "inproc", "placement": "round_robin"}
    extra = payload["data"]["extra"]
    assert extra["device_of"] == system.backend.device_of and extra["n_devices"] == 3
    system.run(2)
    want = _digests(system)
    on_torch = StreamSystem.from_payload(payload, backend="torch", device="cpu")
    on_torch.run(2)
    assert _digests(on_torch) == want
    back = StreamSystem.from_payload(on_torch.checkpoint_payload(),
                                     backend=ShardedBackend(devices=CPU3, placement="sticky"))
    back.run(1)
    on_torch.run(1)
    assert _digests(back) == _digests(on_torch)
    # sticky placement re-pins each segment where the checkpoint had it
    sticky = StreamSystem.from_payload(payload,
                                       backend=ShardedBackend(devices=CPU3, placement="sticky"))
    assert sticky.backend.device_of == extra["device_of"]
    for s in (system, on_torch, back, sticky):
        s.close()


def test_restores_a_payload_the_references_sharded_wrote():
    cpu = jax.devices()[0]
    dags = _fig1(ref_flow)
    ref = RefSystem(backend=RefSharded(devices=[cpu] * 3, placement="least_loaded"),
                    base_batch=BATCH)
    for name in "ABD":
        ref.submit(dags[name].copy())
    ref.run(2)
    payload = ref.checkpoint_payload()
    ref.run(2)
    want = _digests(ref)
    placed = dict(ref.backend.device_of)
    ref.close()
    assert payload["backend"] == "sharded"
    got = StreamSystem.from_payload(payload, backend_options={
        "devices": CPU3, "placement": "sticky"})
    try:
        assert isinstance(got.backend, ShardedBackend)
        assert got.backend.device_of == placed
        assert got.backend.template_fallbacks == 0
        got.run(2)
        digests = _digests(got)
        for sub, sinks in want.items():
            for sink, dg in sinks.items():
                assert digests[sub][sink]["count"] == dg["count"]
                np.testing.assert_allclose(digests[sub][sink]["checksum"], dg["checksum"],
                                           **CHECKSUM_TOL)
    finally:
        got.close()


def _run_straggler(backend, slow=True):
    system = StreamSystem(strategy="signature", backend=backend, base_batch=BATCH)
    for i in range(4):
        system.submit(_chain(flow, f"S{i}", float(i)))
    victim = sorted(backend.device_of)[0] if hasattr(backend, "device_of") else None
    if slow:
        orig = type(backend)._step_one

        def slowed(seg):
            orig(backend, seg)
            return 200.0 if seg.name == victim else 2.0

        backend._step_one = slowed
    system.run(8)
    out = _digests(system)
    system.close()
    return out, victim


@pytest.mark.parametrize("step_mode", ["sync", "concurrent"])
def test_injected_straggler_migrates_and_keeps_the_digests(step_mode):
    want, _ = _run_straggler(resolve_backend("torch", device="cpu"), slow=False)
    be = ShardedBackend(placement="ewma_aware", devices=["cpu", "cpu"], step_mode=step_mode)
    got, victim = _run_straggler(be)
    moves = [n for _, n in be.redispatches]
    assert victim in moves
    assert got == want


def _ref_chains(strategy, qs, steps=3, move=False):
    """The reference's ``sharded`` over two slots of its host device: the
    chains submitted, ``steps`` steps, optionally slot 0's first segment
    moved to slot 1 and 5 more steps; its cache counters after each part."""
    cpu = jax.devices()[0]
    be = RefSharded(devices=[cpu, cpu])
    system = RefSystem(strategy=strategy, backend=be, base_batch=BATCH)
    for i, q in enumerate(qs):
        system.submit(_chain(ref_flow, f"S{i}", q))
    system.run(steps)
    stats = [be.compile_cache_stats()]
    if move:
        name = next(n for n, slot in be.device_of.items() if slot == 0)
        be._move_segment(be.segments[name], 0, 1)
        be.device_of[name] = 1
        stats.append(be.compile_cache_stats())
        system.run(5)
        stats.append(be.compile_cache_stats())
    system.close()
    return stats


def test_a_move_to_another_device_rebuilds_the_segment_there():
    want, _ = _run_straggler(resolve_backend("torch", device="cpu"), slow=False)
    ref_stats = _ref_chains("signature", [float(i) for i in range(4)], move=True)
    be = ShardedBackend(devices=["cpu", "cpu:0"])
    system = StreamSystem(strategy="signature", backend=be, base_batch=BATCH)
    for i in range(4):
        system.submit(_chain(flow, f"S{i}", float(i)))
    system.run(3)
    stats = [be.compile_cache_stats()]
    name = next(n for n, slot in be.device_of.items() if slot == 0)
    seg = be.segments[name]
    step_before = seg.step_fn
    be._move_segment(seg, 0, 1)
    be.device_of[name] = 1
    assert seg.step_fn is not step_before
    stats.append(be.compile_cache_stats())
    system.run(5)
    stats.append(be.compile_cache_stats())
    # one cache for both devices, counted as the reference's: the move
    # counts nothing
    assert stats == ref_stats
    assert _digests(system) == want
    # between two slots of one device nothing is rebuilt
    same = ShardedBackend(devices=["cpu", "cpu"])
    s2 = StreamSystem(strategy="signature", backend=same, base_batch=BATCH)
    s2.submit(_chain(flow, "S0", 0.0))
    seg = next(iter(same.segments.values()))
    fn = seg.step_fn
    same._move_segment(seg, 0, 1)
    assert seg.step_fn is fn
    system.close()
    s2.close()


def test_a_structure_built_on_another_device_is_a_hit():
    """Two copies of one chain (strategy "none") land on ``cpu`` and
    ``cpu:0``: a miss, then a hit, as in the reference's one cache; each
    device steps its own canonical operators."""
    qs = [0.5, 0.5, 2.0]
    ref_stats = _ref_chains("none", qs)
    be = ShardedBackend(devices=["cpu", "cpu:0"])
    system = StreamSystem(strategy="none", backend=be, base_batch=BATCH)
    for i, q in enumerate(qs):
        system.submit(_chain(flow, f"S{i}", q))
    system.run(3)
    assert [be.compile_cache_stats()] == ref_stats
    assert sorted(set(be.device_of.values())) == [0, 1]
    twins = [be.segments[n] for n in sorted(be.segments)[:2]]  # S0's and S1's
    assert [be.device_of[seg.spec.name] for seg in twins] == [0, 1]
    assert twins[0].step_fn._fn is not twins[1].step_fn._fn
    want = StreamSystem(strategy="none", backend=resolve_backend("torch", device="cpu"),
                        base_batch=BATCH)
    for i, q in enumerate(qs):
        want.submit(_chain(flow, f"S{i}", q))
    want.run(3)
    assert _digests(system) == _digests(want)
    system.close()
    want.close()
