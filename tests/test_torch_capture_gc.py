"""The garbage collector is held off while a segment's step is captured.

A ``torch.cuda.CUDAGraph`` destroyed inside another graph's capture
invalidates that capture, and the cyclic collector may destroy one (left in
a reference cycle) at any allocation. ``runtime/graphs.py`` therefore
captures under :func:`collector_held`. These tests run on the CPU: the
hold itself, and a capture through stand-ins for the CUDA calls, which
checks that the collector is off from ``capture_begin`` to ``capture_end``
and on again afterwards, also when the capture fails. The card's own test
is ``tests/test_torch_gpu.py::test_a_cuda_graph_collected_inside_a_capture_does_not_fail_it``.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from types import SimpleNamespace

import pytest
import torch

from repro_torch.runtime import graphs


@pytest.fixture
def collector_on():
    was = gc.isenabled()
    gc.enable()
    yield
    (gc.enable if was else gc.disable)()


def test_collector_held_turns_the_collector_off_and_back_on(collector_on):
    with graphs.collector_held():
        assert not gc.isenabled()
    assert gc.isenabled()


def test_nested_holds_end_with_the_outer_one(collector_on):
    with graphs.collector_held():
        with graphs.collector_held():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()


def test_a_hold_leaves_a_collector_that_was_off_off(collector_on):
    gc.disable()
    with graphs.collector_held():
        assert not gc.isenabled()
    assert not gc.isenabled()


def test_a_hold_ends_on_an_exception(collector_on):
    with pytest.raises(ValueError):
        with graphs.collector_held():
            raise ValueError("inside")
    assert gc.isenabled()


def test_overlapping_holds_on_two_threads(collector_on):
    # thread A holds, thread B holds, A ends (B still holds: off), B ends (on)
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with graphs.collector_held():
            a_in.set()
            b_in.wait()
        seen["after a"] = gc.isenabled()
        a_out.set()

    def b():
        a_in.wait()
        with graphs.collector_held():
            b_in.set()
            a_out.wait()
            seen["b still holding"] = gc.isenabled()

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"after a": False, "b still holding": False}
    assert gc.isenabled()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: notes the collector's state."""

    seen: list = []

    def capture_begin(self, capture_error_mode):
        assert capture_error_mode == "thread_local"
        self.seen.append(("begin", gc.isenabled()))

    def capture_end(self):
        self.seen.append(("end", gc.isenabled()))


class _FakeStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch, collector_on):
    _FakeGraph.seen = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(graphs, "_fresh_blas_workspaces", lambda stream: None)
    return _FakeGraph.seen


def _segment(step_fn):
    state = torch.zeros(3)
    return SimpleNamespace(name="seg1", states={"t1": state}, active={"t1": True},
                           spec=SimpleNamespace(task_ids=["t1"]),
                           operators={"t1": SimpleNamespace(type="avg")}, step_fn=step_fn)


@pytest.mark.parametrize("fails", [False, True])
def test_a_capture_runs_with_the_collector_off(fake_cuda, fails):
    step = graphs.CapturedStep(_FakeStream(), graphs.CaptureStats())
    step.inputs = {}

    def step_fn(states, active, inputs):
        fake_cuda.append(("step", gc.isenabled()))
        if fails:
            err = RuntimeError("a launch inside the capture failed")
            err.task_index = 0
            raise err
        return {"t1": states["t1"] + 1}, {"t1": torch.ones(2)}

    seg = _segment(step_fn)
    if fails:
        with pytest.raises(graphs.CaptureError, match="seg1.*task 't1'"):
            step._capture(seg, (True,))
    else:
        captured = step._capture(seg, (True,))
        assert step.graphs[(True,)] is captured
        assert torch.equal(seg.states["t1"], torch.ones(3))
    assert fake_cuda == [("begin", False), ("step", False), ("end", False)]
    assert gc.isenabled()
