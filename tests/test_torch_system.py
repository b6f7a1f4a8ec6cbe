"""The stream path end to end: the port's StreamSystem against the reference's.

Both packages run the same script — submit, run, fuse, remove, run — on
the paper's Fig. 1 flows and on all 21 RIoT dataflows plus the flows that
drive the kernels, the port on the CPU (``device="cpu"``), the reference
on ``backend="inprocess"``. Sink counts are exact; checksums are allclose
at rtol 2e-5 (the f32 precedent of tests/test_kernels.py: ``torch.sum``
and ``jnp.sum`` reduce in different orders). Within the port, fused and
unfused runs are bitwise equal.
"""
import ast
import glob
import os

import numpy as np
import pytest
import torch

from repro.api import flow as ref_flow
from repro.runtime.system import StreamSystem as RefSystem
from repro.workloads.riot import riot_workload as ref_riot
from repro_torch.api import flow
from repro_torch.kernels import ops as kernel_ops
from repro_torch.runtime.broker import Broker
from repro_torch.runtime.system import StreamSystem
from repro_torch.workloads import KERNEL_FLOWS, kernel_flows, riot_workload

CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)
BATCH = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fig1(builder):
    """Paper Fig. 1 (scripts/smoke_core.py): A, B, C share a source + prefix;
    D has another source. ``parse`` is no riot type: it runs the π fallback."""

    def build(name, chain, source, sink):
        b = builder(name).source(source)
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


def _ref_kernel_flows():
    out = []
    for name, (source, steps) in KERNEL_FLOWS.items():
        b = ref_flow(name).source(source)
        for typ, cfg in steps:
            b.then(typ, **cfg)
        out.append(b.sink("store").build())
    return out


def _script(system, flows, removed, fuse=True, steps=(3, 3, 2)):
    for df in flows:
        system.submit(df)
    system.run(steps[0])
    fused = system.fuse() if fuse else {}
    system.run(steps[1])
    for name in removed:
        system.remove(name)
    system.run(steps[2])
    digests = {df.name: system.sink_digests(df.name) for df in flows if df.name not in removed}
    return digests, fused


def _assert_match(port, ref):
    assert port.keys() == ref.keys()
    for sub in ref:
        assert port[sub].keys() == ref[sub].keys()
        for sink in ref[sub]:
            assert port[sub][sink]["count"] == ref[sub][sink]["count"], (sub, sink)
            np.testing.assert_allclose(
                port[sub][sink]["checksum"], ref[sub][sink]["checksum"], **CHECKSUM_TOL
            )


RIOT_REMOVED = ("urban_etl", "taxi_pred_lr", "FA")


@pytest.fixture(scope="module")
def riot_runs():
    """One reference run and the port's fused and unfused runs of the
    smoke's script at a small batch (the reference's jit compile dominates)."""
    ref, ref_fused = _script(
        RefSystem(backend="inprocess", base_batch=BATCH), ref_riot() + _ref_kernel_flows(), RIOT_REMOVED
    )
    kernel_ops.reset_launch_counts()
    port_sys = StreamSystem(base_batch=BATCH, device="cpu")
    port, port_fused = _script(port_sys, riot_workload() + kernel_flows(), RIOT_REMOVED)
    unfused, _ = _script(
        StreamSystem(base_batch=BATCH, device="cpu"), riot_workload() + kernel_flows(),
        RIOT_REMOVED, fuse=False,
    )
    return dict(ref=ref, ref_fused=ref_fused, port=port, port_fused=port_fused,
                unfused=unfused, system=port_sys)


def test_riot_counts_and_checksums_match_reference(riot_runs):
    _assert_match(riot_runs["port"], riot_runs["ref"])
    # every live sink saw every step
    assert all(
        dg["count"] == 8 for sinks in riot_runs["port"].values() for dg in sinks.values()
    )


def test_riot_fusion_plan_matches_reference(riot_runs):
    assert riot_runs["port_fused"] == riot_runs["ref_fused"]
    assert len(riot_runs["port_fused"]) == 8


def test_riot_fused_equals_unfused_bitwise(riot_runs):
    assert riot_runs["port"] == riot_runs["unfused"]


def _fused_runs(system):
    """{tail type: run task types} of every multi-op kernel the peephole placed."""
    defs = system.backend.task_defs
    return sorted(
        (defs[tail].type, tuple(defs[t].type for t in run))
        for seg in system.backend.segments.values()
        for tail, run in seg.fused_runs.items()
    )


def test_riot_fused_segments_use_multi_op_kernels(riot_runs):
    # RIoT alone has no senml run; the kernel flows contribute FA/FB's senml
    # pair (map_chain) and KB's senml → rmsnorm (affine_rmsnorm)
    assert _fused_runs(riot_runs["system"]) == [
        ("rmsnorm", ("senml_parse", "rmsnorm")),
        ("senml_parse", ("senml_parse", "senml_parse")),
    ]


def test_riot_accounting_matches_reference():
    ref = RefSystem(backend="inprocess", base_batch=BATCH)
    port = StreamSystem(base_batch=BATCH, device="cpu")
    for r_df, p_df in zip(ref_riot(), riot_workload()):
        ref.manager.submit(r_df)  # control plane only: no jit compile
        port.submit(p_df)
    assert port.running_task_count == ref.running_task_count
    live, paused, cost = port.backend.account()
    assert live == port.deployed_task_count == port.running_task_count
    assert paused == 0 and cost > 0


@pytest.mark.parametrize("strategy", ["signature", "faithful", "none"])
def test_fig1_matches_reference(strategy):
    ref, _ = _script(RefSystem(strategy=strategy, backend="inprocess", base_batch=BATCH),
                     _fig1(ref_flow), ("B",), steps=(2, 2, 2))
    port_sys = StreamSystem(strategy=strategy, base_batch=BATCH, device="cpu")
    port, _ = _script(port_sys, _fig1(flow), ("B",), steps=(2, 2, 2))
    _assert_match(port, ref)
    if strategy != "none":
        assert port_sys.running_task_count == 12 - 1  # only B's sink terminates
        assert port_sys.backend.account()[1] == 1  # ... and stays deployed, paused


def test_kernel_flows_drive_every_kernel_path():
    """On the CPU the kernels' plain versions stand in; the launch counts
    stay 0, and the fused run equals the unfused one bitwise."""
    kernel_ops.reset_launch_counts()
    flows = _with_urban_source_first
    fused, plan = _script(StreamSystem(base_batch=8, device="cpu"), flows(), ("KA",))
    unfused, _ = _script(StreamSystem(base_batch=8, device="cpu"), flows(), ("KA",), fuse=False)
    assert len(plan) == 2 and fused == unfused
    assert kernel_ops.launch_counts() == {k: 0 for k in kernel_ops.launch_counts()}


def _with_urban_source_first():
    # the urban source has to live in a segment of its own consumers (as
    # when the kernel flows come after the RIoT flows), or FA's and KA's
    # segments fan out and form no chain
    urban_kalman = next(df for df in riot_workload() if df.name == "urban_kalman")
    return [urban_kalman] + kernel_flows()


def test_kernel_flows_peephole_choices():
    system = StreamSystem(base_batch=8, device="cpu")
    for df in _with_urban_source_first():
        system.submit(df)
    system.run(1)
    assert all(not seg.fused_runs for seg in system.backend.segments.values())
    system.fuse()
    # FB's rmsnorm parent also feeds FA's sink, so it stays on the rmsnorm
    # kernel; KB's private senml → rmsnorm run becomes affine_rmsnorm
    assert _fused_runs(system) == [
        ("rmsnorm", ("senml_parse", "rmsnorm")),
        ("senml_parse", ("senml_parse", "senml_parse")),
    ]


def test_submit_many_equals_sequential():
    a = StreamSystem(base_batch=8, device="cpu")
    b = StreamSystem(base_batch=8, device="cpu")
    for df in _fig1(flow):
        a.submit(df)
    b.submit_many(_fig1(flow))
    a.run(2)
    b.run(2)
    assert {n: a.sink_digests(n) for n in "ABCD"} == {n: b.sink_digests(n) for n in "ABCD"}


def test_paused_task_emits_zeros_of_its_output_shape():
    system = StreamSystem(base_batch=8, device="cpu")
    for df in _fig1(flow):
        system.submit(df)
    system.run(1)
    receipt = system.remove("B")
    seg = next(s for s in system.backend.segments.values()
               if set(receipt.terminated_tasks) & set(s.spec.task_ids))
    paused = [t for t in seg.spec.task_ids if t in receipt.terminated_tasks]
    assert all(seg.active[t] is False for t in paused)
    inputs = {t: system.backend.broker.fetch(t) for t in seg.boundary_topics}
    _, outputs = seg.step_fn(seg.states, seg.active, inputs)
    for tid in paused:
        if tid in outputs:
            assert outputs[tid].shape == (8, 8) and not outputs[tid].any()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamSystem()
    assert StreamSystem(device="cpu").backend.device == torch.device("cpu")


def test_broker_copy_clones():
    broker = Broker()
    batch = torch.arange(16.0).reshape(2, 8)
    broker.publish("stream/x", batch)
    assert broker.fetch("stream/x") is batch
    copy = broker.fetch("stream/x", copy=True)
    assert torch.equal(copy, batch) and copy.data_ptr() != batch.data_ptr()
    assert broker.counters() == {"bytes_published": 64, "publishes": 1}
    broker.drop("stream/x")
    with pytest.raises(KeyError):
        broker.fetch("stream/x")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "examples", "multi_tenant_serving_torch.py")]
    paths += glob.glob(os.path.join(ROOT, "scripts", "torch_*.py"))
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    # the cluster plane, the trace CLI, the sharded backend, the front end
    # and LM reuse-serving
    for module in ("cluster/supervisor.py", "cluster/autoscaler.py", "launch/dryrun.py",
                   "launch/serve.py", "runtime/sharded.py", "runtime/staging.py",
                   "serve/frontend.py", "serve/protocol.py", "serve/client.py",
                   "workloads/tenants.py", "serve/model_ops.py", "serve/reuse_serving.py"):
        assert os.path.join(ROOT, "src", "repro_torch", module) in paths, module
    bad = []
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad
