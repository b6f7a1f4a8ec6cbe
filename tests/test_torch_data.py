"""The port's data pipeline (``repro_torch.data``) against the reference's.

``TokenStream`` is a pure function of ``(seed, index, row)``: the two
packages' batches are held bitwise over seeds, indices and host shards.
``SensorStream`` seeds from ``hash(kind)``, which Python salts per process,
so the two agree within one process, where these tests run them.
"""
import numpy as np
import pytest

from repro.data import SENSOR_TYPES as REF_SENSOR_TYPES
from repro.data import SensorStream as RefSensorStream
from repro.data import TokenStream as RefTokenStream
from repro.data import make_lm_batch_iter as ref_batch_iter
from repro_torch.data import SENSOR_TYPES, SensorStream, TokenStream, make_lm_batch_iter


@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
@pytest.mark.parametrize("index", [0, 5, 123456])
def test_token_batches_are_the_references(seed, index):
    for vocab, seq, batch in ((1000, 32, 8), (151_936, 65, 3)):
        got = TokenStream(vocab, seq, batch, seed=seed).batch(index)
        want = RefTokenStream(vocab, seq, batch, seed=seed).batch(index)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("num_hosts", [1, 2, 4])
def test_token_host_shards_are_the_references(num_hosts):
    full = TokenStream(1000, 32, 8, seed=9).batch(5)["tokens"]
    rows = 8 // num_hosts
    for host in range(num_hosts):
        got = TokenStream(1000, 32, 8, seed=9, host_id=host, num_hosts=num_hosts).batch(5)
        want = RefTokenStream(1000, 32, 8, seed=9, host_id=host, num_hosts=num_hosts).batch(5)
        assert np.array_equal(got["tokens"], want["tokens"])
        assert np.array_equal(got["labels"], want["labels"])
        assert np.array_equal(got["tokens"], full[host * rows:(host + 1) * rows])


def test_batch_iterators_resume_where_the_references_do():
    got, want = (make_lm_batch_iter(TokenStream(500, 16, 2, seed=3), start_index=7),
                 ref_batch_iter(RefTokenStream(500, 16, 2, seed=3), start_index=7))
    for _ in range(3):
        a, b = next(got), next(want)
        assert np.array_equal(a["tokens"], b["tokens"]) and np.array_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("kind", SENSOR_TYPES)
def test_sensor_streams_are_the_references_in_one_process(kind):
    assert SENSOR_TYPES == REF_SENSOR_TYPES
    got, want = SensorStream(kind, seed=4), RefSensorStream(kind, seed=4)
    assert got.channels == want.channels
    for n in (1, 17, 64):
        a, b = got.next_batch(n), want.next_batch(n)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
