"""The port's placement and chain scheduling (``repro_torch.runtime.scheduler``)
against the reference's (``repro.runtime.scheduler``), on the same inputs:
``compute_chains``, each registered policy's ``assign`` and ``redispatch``
(sticky with and without its restore hints), ``place_round_robin`` and the
``StragglerPolicy``; and the placed-backend bookkeeping
(``PlacedBackendMixin``) on a stand-in backend, where a flagged straggler
moves only when its policy picks another slot, and only a move is logged.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.runtime import scheduler as ref
from repro_torch.runtime import scheduler as port
from repro_torch.runtime.backend import SegmentSpec


def _dag(rng, n):
    """A random segment DAG over n segments (edges only to earlier ones),
    a random assignment to 3 slots and a launch order."""
    names = [f"s{i}" for i in range(n)]
    deps = {m: {names[j] for j in range(i) if rng.random() < 0.3} for i, m in enumerate(names)}
    assign = {m: int(rng.integers(0, 3)) for m in names}
    order = {m: int(k) for k, m in enumerate(rng.permutation(names))}
    return deps, assign, order


@pytest.mark.parametrize("seed", range(8))
def test_compute_chains_are_the_references(seed):
    rng = np.random.default_rng(seed)
    deps, assign, order = _dag(rng, 3 + seed * 2)
    assert port.compute_chains(deps, assign, order=order) == ref.compute_chains(
        deps, assign, order=order)
    assert port.compute_waves(deps, order) == ref.compute_waves(deps, order)


def test_the_registries_are_the_references():
    assert port.available_placements() == ref.available_placements() == [
        "ewma_aware", "least_loaded", "round_robin", "sticky"]
    with pytest.raises(ValueError, match="unknown placement"):
        port.resolve_placement("nope")
    with pytest.raises(TypeError):
        port.resolve_placement(3)
    policy = port.resolve_placement("sticky")
    assert port.resolve_placement(policy) is policy
    with pytest.raises(ValueError, match="improvement"):
        port.EwmaAwarePlacement(improvement=0.0)


def _spec(name):
    return SegmentSpec(name=name, dag_name="d", task_ids=[name], parents={name: []},
                       publish=set(), batch_of={name: 32})


@pytest.mark.parametrize("name", ["round_robin", "least_loaded", "ewma_aware", "sticky"])
@pytest.mark.parametrize("seed", range(4))
def test_each_policy_assigns_and_redispatches_as_the_reference(name, seed):
    """One policy instance per package, fed the same sequence of specs,
    loads, EWMAs and hints: every assignment and every redispatch equal."""
    rng = np.random.default_rng(100 + seed)
    mine, theirs = port.resolve_placement(name), ref.resolve_placement(name)
    n = int(rng.integers(1, 5))
    for i in range(12):
        spec = _spec(f"seg{i}")
        load = {k: int(rng.integers(0, 9)) for k in range(n) if rng.random() < 0.8}
        ewma = {k: float(rng.random() * 5) for k in range(n) if rng.random() < 0.7}
        hints = {"checkpoint_device_of": {f"seg{j}": int(rng.integers(0, n + 1))
                                          for j in range(12) if rng.random() < 0.5},
                 "checkpoint_n_devices": int(rng.choice([n, n + 1]))}
        kw = {"hints": hints} if rng.random() < 0.5 else {}
        assert mine.assign(spec, n, load, ewma=ewma, **kw) == theirs.assign(
            spec, n, load, ewma=ewma, **kw)
        current = int(rng.integers(0, n))
        assert mine.redispatch(spec, current, n, load, ewma=ewma) == theirs.redispatch(
            spec, current, n, load, ewma=ewma)


def test_place_round_robin_and_the_straggler_policy_are_the_references():
    tasks = {"a": 3, "b": 17, "c": 8, "d": 1}
    mine, theirs = port.place_round_robin(tasks), ref.place_round_robin(tasks)
    assert (mine.assignments, mine.nodes_used, mine.workers_used) == (
        theirs.assignments, theirs.nodes_used, theirs.workers_used)
    rng = np.random.default_rng(7)
    p, r = port.StragglerPolicy(), ref.StragglerPolicy()
    for step in range(30):
        timings = {f"s{i}": float(rng.random() * (20 if i == 0 else 1)) for i in range(5)}
        assert p.observe(step, timings) == r.observe(step, timings)
    assert [vars(e) for e in p.events] == [vars(e) for e in r.events]


class _Seg:
    def __init__(self, name, tasks):
        self.spec = SegmentSpec(name=name, dag_name="d", task_ids=list(tasks),
                                parents={t: [] for t in tasks}, publish=set(),
                                batch_of={t: 32 for t in tasks})


class _Base:
    """What the mixin reads of an ExecutionBackend, and the base straggler
    hook (reset the EWMA)."""

    def __init__(self):
        self.segments = {}
        self.ewma_ms = {}
        self.redispatches = []
        self.step_count = 7
        self.killed = []

    def kill(self, name):
        self.killed.append(name)
        self.segments.pop(name)

    def _update_stragglers(self, seg_ms):
        return []

    def _straggler(self, name):
        del self.ewma_ms[name]


class _Placed(port.PlacedBackendMixin, _Base):
    def __init__(self, policy, slots):
        _Base.__init__(self)
        self._init_placement(policy)
        self.slots = slots
        self.moves = []

    def _n_slots(self):
        return self.slots

    def _move_segment(self, seg, old, new):
        self.moves.append((seg.spec.name, old, new))


def _placed(policy, slots=2):
    be = _Placed(policy, slots)
    for name, tasks in (("a", "xy"), ("b", "z"), ("c", "uvw")):
        seg = _Seg(name, tasks)  # placed before it joins the segments, as deploy does
        be._assign_slot(seg.spec)
        be.segments[name] = seg
    return be


def test_a_straggler_moves_only_where_its_policy_says_and_only_a_move_is_logged():
    be = _placed("ewma_aware")
    assert sum(be.device_load().values()) == 6
    hot = "a"
    src = be.device_of[hot]
    be.ewma_ms = {hot: 30.0, "b": 1.0, "c": 1.0}
    be._straggler(hot)
    assert be.moves == [(hot, src, 1 - src)] and be.device_of[hot] == 1 - src
    assert be.redispatches == [(7, hot)] and hot not in be.ewma_ms
    # the old slot keeps the migrated EWMA as a residual that decays a step
    assert be.device_ewma()[src] >= 30.0
    be._update_stragglers({})
    assert be._ewma_residual[src] == pytest.approx(30.0 * be.ewma_decay)

    # a static policy keeps the segment in place: nothing moves, nothing logged
    still = _placed("round_robin")
    still.ewma_ms = {"a": 30.0, "b": 1.0}
    still._straggler("a")
    assert still.moves == [] and still.redispatches == [] and "a" not in still.ewma_ms

    # one slot: nowhere to go
    single = _placed("ewma_aware", slots=1)
    single.ewma_ms = {"c": 9.0}
    single._straggler("c")
    assert single.moves == [] and single.redispatches == []


def test_pins_and_sticky_hints_place_before_the_policy():
    be = _placed("sticky", slots=3)
    be.device_of_at_checkpoint = {"d": 2}
    be._n_slots_at_checkpoint = 3
    assert be._assign_slot(_Seg("d", "q").spec) == 2
    be._pin_slot["e"] = 1
    assert be._assign_slot(_Seg("e", "r").spec) == 1 and "e" not in be._pin_slot
    be.segments["e"] = _Seg("e", "r")
    be.kill("e")
    assert "e" not in be.device_of and be.killed == ["e"]
