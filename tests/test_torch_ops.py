"""The port's operators against the reference's, on the same batches.

Each case builds the operator for one ⟨type, config⟩ in both packages,
feeds both the same numpy batches (seeded) for several steps from the same
initial state, and compares outputs and states:

* exact where the reference is exact: selections, flags, the hash-keyed
  int states of ``bloom_filter`` and ``distinct_count``, the π constant;
* allclose at the f32 precedent of tests/test_kernels.py (2e-5) where
  float32 arithmetic may round differently (reductions, rsqrt, the FMAs
  XLA forms in the ``kalman`` recurrence).

Within the port, the fused multi-op operators are bitwise the unfused op
sequence (mirroring tests/test_fusion_optimizer.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as ref_ops
import repro_torch.ops as port_ops
from repro.core.graph import Task as RefTask
from repro_torch.convert import states_from_jax, states_to_numpy
from repro_torch.core.graph import Dataflow, Task
from repro_torch.ops.riot import make_fused_operator, pi_estimate
from repro_torch.runtime.backend import SegmentSpec
from repro_torch.runtime.segment import _peephole_fused_kernels

F32_TOL = dict(rtol=2e-5, atol=2e-5)
B = 37

EXACT = [
    ("senml_parse", {"scale": 2.0, "offset": 0.5}),
    ("csv_parse", {"shift": 2}),
    ("csv_parse", {"cols": 6}),
    ("range_filter", {"lo": -5, "hi": 5}),
    ("bloom_filter", {"bits": 1024}),
    ("bloom_filter", {"m": 100, "k": 2}),
    ("interpolate", {"k": 2}),
    ("join", {}),
    ("annotate", {"tag": 3.0}),
    ("distinct_count", {"h": 4}),
    ("distinct_count", {"m": 100}),
    ("dtree", {"depth": 3}),
    ("error_estimate", {}),
    ("pi", {"iters": 100}),
    ("opmw_task_7", {"iters": 37}),  # unknown type → the π fallback
]
CLOSE = [
    ("kalman", {"q": 0.5}),
    ("kalman", {"q": 0.1, "r": 2.0}),
    ("win", {"w": 4}),
    ("avg", {"n": 8}),
    ("moment2", {}),
    ("rmsnorm", {"gain": 1.5}),
    ("linreg", {"d": 4}),
    ("linreg", {"seed": 3}),
    ("sliding_linreg", {"w": 8}),
]


def _batches(seed, n=4, b=B):
    """Seeded event batches: ids from 0 (the unsaturated hash) upward,
    about a third of the rows flagged invalid."""
    g = np.random.default_rng(seed)
    out = []
    for step in range(n):
        x = (g.standard_normal((b, 8)) * 10.0).astype(np.float32)
        x[:, 0] = step + np.arange(b, dtype=np.float32) / b
        x[:, 6] = (g.random(b) > 0.3).astype(np.float32)
        x[:, 7] = (step * b + np.arange(b)).astype(np.float32)
        out.append(x)
    return out


def _run_both(typ, cfg, batches, init=None):
    ro = ref_ops.operator_for_task(RefTask.make("t", typ, cfg), B)
    po = port_ops.operator_for_task(Task.make("t", typ, cfg), B)
    rs = ro.init_state(B) if init is None else jax.tree.map(jnp.asarray, init)
    ps = po.init_state(B) if init is None else states_from_jax(init)
    pairs = []
    for x in batches:
        rs, ry = ro.apply(rs, jnp.asarray(x))
        ps, py = po.apply(ps, torch.from_numpy(x))
        pairs.append((np.asarray(ry), py.numpy(), jax.tree.map(np.asarray, rs), states_to_numpy(ps)))
    return pairs


def _same_structure(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for u, v in zip(la, lb):
        assert u.dtype == v.dtype and u.shape == v.shape
    return la, lb


@pytest.mark.parametrize("typ,cfg", EXACT, ids=[f"{t}-{i}" for i, (t, _) in enumerate(EXACT)])
def test_op_exact(typ, cfg):
    for ry, py, rs, ps in _run_both(typ, cfg, _batches(1)):
        assert np.array_equal(py, ry)
        for u, v in zip(*_same_structure(rs, ps)):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("typ,cfg", CLOSE, ids=[f"{t}-{i}" for i, (t, _) in enumerate(CLOSE)])
def test_op_allclose(typ, cfg):
    for ry, py, rs, ps in _run_both(typ, cfg, _batches(2)):
        np.testing.assert_allclose(py, ry, **F32_TOL)
        for u, v in zip(*_same_structure(rs, ps)):
            np.testing.assert_allclose(v, u, **F32_TOL)


def test_every_registered_type_is_covered():
    # both registries hold the LM-serving ops once serve.model_ops is
    # imported; tests/test_torch_reuse_serving.py holds those to the reference
    import repro.serve.model_ops  # noqa: F401
    import repro_torch.serve.model_ops  # noqa: F401

    covered = {t for t, _ in EXACT + CLOSE} | {"lm_embed", "lm_stage", "lm_head"}
    assert set(port_ops.registered_types()) <= covered
    assert set(port_ops.registered_types()) == set(ref_ops.registered_types())


@pytest.mark.parametrize("ids", [[0.0, 1.0, 2.0], [5e8, 3e9, 1e12], [-1.0, -3e9, 0.5]])
def test_hash_cast_saturates_like_xla(ids):
    # id·2654435761 leaves int32 for every id ≥ 1: XLA saturates; the port
    # must too, or bloom/distinct state diverges from the reference
    x = np.zeros((len(ids), 8), np.float32)
    x[:, 7] = ids
    for typ, cfg in (("bloom_filter", {"m": 64, "k": 3}), ("distinct_count", {"m": 96})):
        (ry, py, rs, ps), = _run_both(typ, cfg, [x])
        assert np.array_equal(py, ry) and np.array_equal(ps, rs)


def test_pi_constant_exact():
    def body(i, acc):
        k = i.astype(jnp.float32)
        return acc + jnp.where(i % 2 == 0, 1.0, -1.0) * 4.0 / (2.0 * k + 1.0)

    for iters in (1, 37, 100, 1000):
        want = float(jax.lax.fori_loop(0, iters, body, jnp.zeros(())))
        assert pi_estimate(iters) == want


def test_sources_match_reference():
    from repro.ops.sources import make_source as ref_source
    from repro_torch.ops.sources import make_source

    for name in ("urban", "meter", "taxi", "grid", "other:3"):
        ro, po = ref_source(name, batch=48), make_source(name, batch=48)
        rs, ps = ro.init_state(48), po.init_state(48)
        for _ in range(3):
            rs, ry = ro.apply(rs)
            ps, py = po.apply(ps)
            np.testing.assert_allclose(py.numpy(), np.asarray(ry), **F32_TOL)
            assert np.array_equal(py.numpy()[:, [0, 6, 7]], np.asarray(ry)[:, [0, 6, 7]])
            assert int(ps) == int(rs)


def test_sink_counts_exact_checksum_close():
    from repro.ops.sinks import make_sink as ref_sink
    from repro_torch.ops.sinks import make_sink

    ro, po = ref_sink("store"), make_sink("store")
    rs, ps = ro.init_state(B), po.init_state(B)
    for x in _batches(3):
        rs, _ = ro.apply(rs, jnp.asarray(x))
        ps, _ = po.apply(ps, torch.from_numpy(x))
    assert int(ps["count"]) == int(rs["count"]) == 4
    np.testing.assert_allclose(float(ps["checksum"]), float(rs["checksum"]), **F32_TOL)
    assert np.array_equal(ps["last"].numpy(), np.asarray(rs["last"]))


@pytest.mark.parametrize("typ,cfg", [("kalman", {"q": 0.5}), ("win", {"w": 3}),
                                     ("moment2", {}), ("bloom_filter", {"m": 64})])
def test_mid_run_state_carries_over(typ, cfg):
    """Both packages continue from the reference's state after two steps."""
    ro = ref_ops.operator_for_task(RefTask.make("t", typ, cfg), B)
    rs = ro.init_state(B)
    warm, rest = _batches(4)[:2], _batches(5)
    for x in warm:
        rs, _ = ro.apply(rs, jnp.asarray(x))
    mid = jax.tree.map(np.asarray, rs)
    for ry, py, rsn, psn in _run_both(typ, cfg, rest, init=mid):
        np.testing.assert_allclose(py, ry, **F32_TOL)
        for u, v in zip(*_same_structure(rsn, psn)):
            np.testing.assert_allclose(v, u, **F32_TOL)


def test_states_from_jax_round_trip():
    state = {"buf": np.arange(6, dtype=np.float32).reshape(3, 2),
             "n": np.int32(4), "bits": np.zeros(5, np.int32), "none": ()}
    port = states_from_jax(state)
    assert port["n"].dtype == torch.int32 and port["n"].shape == ()
    assert port["buf"].dtype == torch.float32 and port["none"] == ()
    back = states_to_numpy(port)
    for k in ("buf", "n", "bits"):
        assert np.array_equal(back[k], state[k]) and back[k].dtype == np.asarray(state[k]).dtype


# -- fused multi-op operators (bitwise within the port) ---------------------------

CHAIN = [
    Task.make("p1", "senml_parse", {"scale": 2.0, "offset": 0.5}),
    Task.make("p2", "senml_parse", {"scale": 0.7, "offset": -0.1}),
]


@pytest.mark.parametrize("tail", [Task.make("n", "rmsnorm", {"gain": 1.5}),
                                  Task.make("s3", "senml_parse", {"scale": 1.3, "offset": 0.2})])
def test_make_fused_operator_matches_op_sequence(tail):
    chain = CHAIN + [tail]
    fused = make_fused_operator(chain, batch=9)
    assert fused is not None
    assert fused.cost_weight == port_ops.operator_for_task(chain[-1], batch=9).cost_weight
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((9, 8)).astype(np.float32))
    y = x
    for t in chain:
        op = port_ops.operator_for_task(t, batch=9)
        _, y = op.apply(op.init_state(9), y)
    _, got = fused.apply(fused.init_state(9), x)
    assert torch.equal(got, y)


def test_make_fused_operator_declines_unknown_runs():
    k = Task.make("k", "kalman", {"q": 0.1})
    n = Task.make("n", "rmsnorm", {})
    assert make_fused_operator([k, n], batch=4) is None
    assert make_fused_operator([n], batch=4) is None


def _df(tasks):
    df = Dataflow("d")
    for tid, typ, cfg in tasks:
        df.add_task(Task.make(tid, typ, cfg))
    return df


def _spec(tids, parents, fused):
    return SegmentSpec(
        name="s0", dag_name="d", task_ids=list(tids),
        parents={t: list(parents.get(t, [])) for t in tids},
        publish=set(), batch_of={t: 8 for t in tids}, fused=fused,
    )


@pytest.mark.parametrize("fused", [True, False])
def test_peephole_rewires_only_fused_specs(fused):
    tasks = [
        ("s", "urban", "SOURCE"),
        ("p1", "senml_parse", {"scale": 2.0}),
        ("p2", "senml_parse", {"scale": 0.5}),
        ("n", "rmsnorm", {}),
        ("k", "store", "SINK"),
    ]
    df = _df(tasks)
    spec = _spec([t for t, _, _ in tasks], {"p1": ["s"], "p2": ["p1"], "n": ["p2"], "k": ["n"]}, fused)
    operators = {t: port_ops.operator_for_task(df.tasks[t], batch=8) for t in spec.task_ids}
    parents = {t: list(spec.parents[t]) for t in spec.task_ids}
    _peephole_fused_kernels(spec, df, operators, parents, device="cpu")
    assert parents["n"] == (["s"] if fused else ["p2"])  # tail consumes the run head's input
    assert parents["p1"] == ["s"] and parents["p2"] == ["p1"]  # interiors keep
    assert spec.parents["n"] == ["p2"]  # spec untouched
