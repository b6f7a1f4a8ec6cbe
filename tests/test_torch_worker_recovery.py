"""The port's worker-process plane under a lost worker and a resized pool:
``MultiprocBackend.recover_worker`` (from the shadow snapshots that ride
each step reply, and from the workers' spill files) and ``resize_pool``,
called directly, as the supervisor and the autoscaler call them
(``tests/test_torch_cluster.py`` drives those), each with sink digests
bitwise those of the port's in-process ``torch`` backend; and what the coordinator reads of
its workers (kernel launches, device memory, compile-cache counters, the
intra-op thread count it hands them). Workers run on the CPU.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.api import flow
from repro_torch.runtime.system import StreamSystem
from repro_torch.runtime.worker import MultiprocBackend

BATCH = 16


def _fig1():
    """Paper Fig. 1: A, B, C share a source + prefix; D has another source."""

    def build_df(name, chain, source, sink):
        b = flow(name).source(source)
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


def _digests(system):
    return {n: system.sink_digests(n) for n in sorted(system.manager.submitted)}


def _multiproc(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("device", "cpu")
    return MultiprocBackend(**kw)


@pytest.mark.parametrize("mode", ["wire", "spill"])
def test_recover_worker_keeps_the_digests(mode):
    dags = _fig1()
    want = StreamSystem(device="cpu", base_batch=BATCH)
    be = _multiproc()
    if mode == "wire":
        be.shadow_states = True  # post-step states ride each step reply
    else:
        be.snapshot_mode = "spill"  # workers persist post-step states to files
    got = StreamSystem(backend=be, base_batch=BATCH)
    events = []
    be.on_worker_event = events.append
    for system in (want, got):
        for n in "ABCD":
            system.submit(dags[n].copy())
        system.run(3)
    proc = be._procs[1]
    proc.terminate()
    proc.join(10)
    record = be.recover_worker(1)
    assert record["segments"] == sorted(n for n, w in be.device_of.items() if w == 1)
    assert [e.kind for e in events] == ["worker-dead", "worker-respawned", "segment-redeployed"]
    for system in (want, got):
        system.run(2)
    assert _digests(got) == _digests(want)
    health = got.worker_health()
    assert health["respawns"] == 1 and health["generations"] == [0, 1]
    assert health["alive"] == [True, True]
    got.close()


def test_resize_pool_grows_and_shrinks_keeping_the_digests():
    dags = _fig1()
    want = StreamSystem(device="cpu", base_batch=BATCH)
    be = _multiproc()
    got = StreamSystem(backend=be, base_batch=BATCH)
    for system in (want, got):
        for n in "ABC":
            system.submit(dags[n].copy())
        system.run(2)
    be.resize_pool(3)
    assert be.n_workers == 3 and len(be._procs) == 3
    got.submit(dags["D"].copy())
    want.submit(dags["D"].copy())
    for system in (want, got):
        system.run(2)
    be.resize_pool(1)
    assert be.n_workers == 1 and set(be.device_of.values()) == {0}
    for system in (want, got):
        system.run(2)
    assert _digests(got) == _digests(want)
    kinds = [e.kind for e in be.worker_events]
    assert kinds == ["pool-grown", "pool-shrunk"]
    got.close()


def test_launch_counts_and_memory_are_read_from_the_workers():
    be = _multiproc()
    system = StreamSystem(backend=be, base_batch=BATCH)
    system.submit(flow("S0").source("urban").then("kalman", q=0.1).sink("store").build())
    system.run(2)
    counts = be.launch_counts()
    # on the CPU the plain versions run: no kernel launch anywhere
    assert set(counts) >= {"rmsnorm", "kalman_scan"} and not any(counts.values())
    assert be.worker_memory() == {}
    assert be.first_step_s is not None and be.first_step_s > 0
    assert be.compile_cache_stats()["misses"] >= 1
    snap = system.metrics_snapshot()
    assert snap["repro_worker_segment_steps_total"]["values"][0][1] == 2
    system.close()


def test_worker_threads_follow_the_coordinator():
    be = _multiproc(workers=1)
    assert be._worker_options == {"device": "cpu", "threads": torch.get_num_threads()}
    be.close()
