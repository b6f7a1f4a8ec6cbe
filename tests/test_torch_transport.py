"""The port's stream transports (``repro_torch.runtime.transport``) against
the reference's (``repro.runtime.transport``).

  * the conformance suite every registered transport (inproc / shm / tcp)
    passes, as ``tests/test_transport.py`` runs it on the reference's:
    round-trips bit-exact for every dtype the event batches take,
    per-topic sequencing, drop-wake, counters, the error taxonomy;
  * the shm layout is the reference's: a batch one package publishes the
    other fetches from its ``connect_info``, both ways, counters and drops
    included;
  * zero-copy views and their revalidation, and the seqlock under a fast
    writer in another process (the port writes and reads the sequence word
    in one store and one load, so a reader never sees it half written).
"""
from __future__ import annotations

import multiprocessing as mp
import threading
import time

import numpy as np
import pytest

from repro.runtime import transport as ref_transport
from repro_torch.runtime.transport import (
    ShmTransport,
    TcpTransport,
    TopicDropped,
    Transport,
    TransportError,
    TransportTimeout,
    available_transports,
    connect_transport,
    register_transport,
    resolve_transport,
)

TRANSPORTS = ["inproc", "shm", "tcp"]
SPANNING = ["shm", "tcp"]


def _batch(fill=1.0, n=4):
    return np.full((n, 8), fill, dtype=np.float32)


@pytest.fixture(params=TRANSPORTS)
def transport(request):
    t = resolve_transport(request.param)
    yield t
    t.close()


class TestRegistry:
    def test_builtins_are_the_references(self):
        assert set(available_transports()) >= set(ref_transport.available_transports()) >= {
            "inproc", "shm", "tcp"}

    def test_unknown_rejected(self):
        with pytest.raises(ValueError, match="unknown transport"):
            resolve_transport("no-such-transport")
        with pytest.raises(TypeError):
            resolve_transport(42)

    def test_instance_passthrough_and_duplicates(self):
        inst = resolve_transport("inproc")
        assert resolve_transport(inst) is inst
        with pytest.raises(ValueError, match="already registered"):

            @register_transport
            class Dup(Transport):
                name = "shm"

    def test_inproc_cannot_span_processes(self):
        with pytest.raises(TransportError, match="cannot span"):
            resolve_transport("inproc").connect_info()


class TestConformance:
    @pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "bool"])
    def test_bytes_round_trip_for_each_kind(self, transport, dtype):
        b = (np.arange(40).reshape(5, 8) * 0.37).astype(dtype)
        transport.publish("stream/t1", b)
        got = np.asarray(transport.fetch("stream/t1"))
        assert got.dtype == b.dtype and got.shape == b.shape
        assert got.tobytes() == b.tobytes()

    def test_sequence_and_synced_fetch(self, transport):
        assert transport.seq("stream/s") == 0
        transport.publish("stream/s", _batch(1.0))
        transport.publish("stream/s", _batch(2.0))
        assert transport.seq("stream/s") == 2 and transport.sequences() == {"stream/s": 2}
        assert np.asarray(transport.fetch_synced("stream/s", 2))[0, 0] == 2.0
        out = []
        th = threading.Thread(target=lambda: out.append(
            np.asarray(transport.fetch_synced("stream/s", 3, timeout=10))))
        th.start()
        time.sleep(0.05)
        assert not out  # still blocked on seq 3
        transport.publish("stream/s", _batch(7.0))
        th.join(5)
        assert out and out[0][0, 0] == 7.0

    def test_drop_wakes_a_blocked_fetch_and_resets_the_sequence(self, transport):
        transport.publish("stream/s", _batch(1.0))
        err = []

        def consumer():
            try:
                transport.fetch_synced("stream/s", 5, timeout=10)
            except TopicDropped:
                err.append("woken")

        th = threading.Thread(target=consumer)
        th.start()
        time.sleep(0.05)
        transport.drop("stream/s")
        th.join(5)
        assert err == ["woken"] and not transport.has("stream/s")
        transport.publish("stream/s", _batch(3.0))
        assert transport.seq("stream/s") == 1
        assert np.asarray(transport.fetch("stream/s"))[0, 0] == 3.0

    def test_counters_cumulative_resettable_restorable(self, transport):
        b = _batch()
        transport.publish("stream/a", b)
        transport.publish("stream/b", b)
        transport.drop("stream/a")
        assert transport.counters() == {"bytes_published": 2 * b.nbytes, "publishes": 2}
        assert transport.bytes_published == 2 * b.nbytes and transport.publishes == 2
        assert len(transport) == 1 and set(transport.topics()) == {"stream/b"}
        transport.reset_counters()
        assert transport.counters() == {"bytes_published": 0, "publishes": 0}
        transport.restore_counters(1234, 5)
        assert transport.counters() == {"bytes_published": 1234, "publishes": 5}

    def test_error_taxonomy(self, transport):
        assert issubclass(TopicDropped, TransportError) and issubclass(TopicDropped, KeyError)
        assert issubclass(TransportTimeout, TransportError)
        assert issubclass(TransportTimeout, TimeoutError)
        assert str(TopicDropped("topic 'stream/x' dropped")) == "topic 'stream/x' dropped"
        with pytest.raises(TopicDropped):
            transport.fetch("stream/nope")
        transport.publish("stream/s", _batch(1.0))
        with pytest.raises(TransportTimeout):
            transport.fetch_synced("stream/s", 99, timeout=0.05)

    def test_ring_overwrites_keep_latest(self, transport):
        for i in range(12):  # laps the shm ring (4 slots) three times
            transport.publish("stream/s", _batch(float(i)))
        assert np.asarray(transport.fetch("stream/s"))[0, 0] == 11.0
        assert transport.seq("stream/s") == 12


class TestLayoutIsTheReferences:
    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_a_batch_crosses_between_the_packages(self, writer):
        """The shm topic files one package writes the other reads from its
        connect_info: header, slots, sequence word, byte counter, drops."""
        own = ShmTransport() if writer == "port" else ref_transport.ShmTransport()
        other = (ref_transport.connect_transport if writer == "port"
                 else connect_transport)(own.connect_info())
        try:
            b = np.arange(48, dtype=np.float32).reshape(6, 8) * 1.5
            for i in range(6):  # laps the ring
                own.publish("stream/x", b + i)
            assert other.seq("stream/x") == 6 and other.has("stream/x")
            assert other.fetch("stream/x").tobytes() == (b + 5).tobytes()
            view, seq = other.fetch_view("stream/x")
            assert seq == 6 and view.tobytes() == (b + 5).tobytes()
            assert other.view_valid("stream/x", seq)
            other.publish("stream/y", b * 2)  # and back the other way
            assert own.fetch_synced("stream/y", 1).tobytes() == (b * 2).tobytes()
            assert own.counters() == other.counters() == {
                "bytes_published": 7 * b.nbytes, "publishes": 7}
            other.drop("stream/x")
            assert not own.has("stream/x") and own.sequences() == {"stream/y": 1}
            with pytest.raises(KeyError):
                own.fetch("stream/x")
        finally:
            other.close()
            own.close()

    def test_tcp_speaks_the_references_wire(self):
        server = ref_transport.TcpTransport()
        port = connect_transport(server.connect_info())
        try:
            port.publish("stream/t", _batch(4.0))
            assert server.fetch("stream/t")[0, 0] == 4.0
            server.publish("stream/t", _batch(5.0))
            assert port.fetch_synced("stream/t", 2)[0, 0] == 5.0
            assert port.counters() == server.counters()
        finally:
            port.close()
            server.close()


class TestZeroCopyViews:
    @pytest.mark.parametrize("name", SPANNING)
    def test_fetch_is_readonly_copy_is_private(self, name):
        t = resolve_transport(name)
        try:
            b = np.arange(32, dtype=np.float32).reshape(4, 8)
            t.publish("stream/v", b)
            view = t.fetch("stream/v")
            assert not view.flags.writeable
            copy = t.fetch("stream/v", copy=True)
            copy[0, 0] = 9.0
            assert np.asarray(t.fetch("stream/v"))[0, 0] == 0.0
        finally:
            t.close()

    def test_view_valid_until_the_writer_laps(self):
        t = ShmTransport()
        try:
            t.publish("stream/v", _batch(1.0))
            view, seq = t.fetch_view("stream/v")
            t.publish("stream/v", _batch(2.0))
            t.publish("stream/v", _batch(3.0))
            assert t.view_valid("stream/v", seq) and view[0, 0] == 1.0
            t.publish("stream/v", _batch(4.0))  # the writer reaches seq + nslots - 1
            assert not t.view_valid("stream/v", seq)
            assert not t.view_valid("stream/nope", 1)
            with pytest.raises(TransportTimeout):
                t.fetch_view("stream/v", min_seq=9, timeout=0.05)
        finally:
            t.close()

    def test_sequence_words_are_whole_past_a_byte(self):
        # 255 -> 256 carries into the second byte of the sequence word
        t = ShmTransport()
        try:
            for i in range(260):
                t.publish("stream/w", _batch(float(i), n=1))
                assert t.seq("stream/w") == i + 1
            assert t.fetch("stream/w")[0, 0] == 259.0
            assert t.counters()["bytes_published"] == 260 * 32
        finally:
            t.close()


def _stress_writer(spec, topic, rounds, batch):
    t = connect_transport(spec)
    for i in range(rounds):
        t.publish(topic, np.full((batch, 8), float(i + 1), dtype=np.float32))
    t.close()


class TestSeqlockStress:
    def test_reader_never_observes_torn_batch(self):
        """A writer in another process laps the 4-slot ring as fast as it
        can while this process fetches: every publish is a uniform fill, so
        a torn read shows as a mixed batch, a stale one as a smaller value,
        and a half-written sequence word as a spurious "no data"."""
        rounds, batch = 1500, 64
        t = ShmTransport()
        try:
            t.publish("stream/hot", np.full((batch, 8), 0.0, np.float32))
            proc = mp.get_context("spawn").Process(
                target=_stress_writer, args=(t.connect_info(), "stream/hot", rounds, batch))
            proc.start()
            last = 0.0
            try:
                while proc.is_alive() or last < float(rounds):
                    vals = np.unique(t.fetch("stream/hot", copy=True))
                    assert vals.size == 1, f"torn batch: {vals[:8]}"
                    assert vals[0] >= last  # monotone: never a stale slot
                    last = float(vals[0])
                    if last >= float(rounds):
                        break
            finally:
                proc.join(60)
            assert proc.exitcode == 0 and last == float(rounds)
        finally:
            t.close()


def _child_publish(spec, topic):
    t = connect_transport(spec)
    t.publish(topic, np.full((4, 8), 42.5, dtype=np.float32))
    t.close()


@pytest.mark.parametrize("name", SPANNING)
def test_a_spawned_process_publishes_what_this_one_fetches(name):
    t = resolve_transport(name)
    try:
        proc = mp.get_context("spawn").Process(
            target=_child_publish, args=(t.connect_info(), "stream/child"))
        proc.start()
        proc.join(60)
        assert proc.exitcode == 0
        assert t.fetch_synced("stream/child", 1, timeout=10).tobytes() == np.full(
            (4, 8), 42.5, np.float32).tobytes()
    finally:
        t.close()


def test_tcp_server_counts_numpy_batches():
    t = TcpTransport()
    try:
        t.publish("stream/a", _batch(1.0, n=3))
        assert t.counters() == {"bytes_published": 96, "publishes": 1}
        assert t.topics()["stream/a"].shape == (3, 8)
    finally:
        t.close()
