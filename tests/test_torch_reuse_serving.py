"""The port's LM reuse-serving (``repro_torch.serve.{model_ops,reuse_serving}``
and the ``--reuse`` mode of ``repro_torch.launch.serve``) against the
reference's ``repro.serve``, at ``d=32`` and ``layers_per_stage=2`` as
``tests/test_serving.py`` runs the reference's:

  * ``_seed`` is the reference's sha256 exactly; ``_proj``'s draws (through
    ``repro_torch.random``, which emulates ``jax.random.normal``) agree within
    1e-6; each ``lm_*`` operator's ``apply`` on the same numpy input agrees
    within 2e-5;
  * ``TenantPipeline.to_dataflow`` gives the reference's task ids, types,
    configs and streams;
  * ``ReuseServing`` on ``torch`` (``device="cpu"``) against the reference's
    on ``inprocess``: receipts, ``running_task_count`` and ``stats()`` equal
    (``deployed_cost`` exactly), sink counts exact and checksums within 2e-5
    over 4 steps, across a ``remove_tenant`` too (the removed tenant's tasks
    pause in their segments, and paused LM stages emit zeros of their width);
  * fine-tuned stages are not merged; ``none`` ≡ ``signature`` outputs;
  * the CLI's ``--reuse --device cpu`` prints the reference CLI's
    ``tenants=... running_tasks=... deployed_cost=...`` line (the reference's
    module runs in a subprocess).
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.ops.base import make_operator as ref_make_operator
from repro.serve import ReuseServing as RefServing
from repro.serve import TenantPipeline as RefPipeline
from repro.serve import model_ops as ref_model_ops
from repro_torch.ops.base import make_operator
from repro_torch.serve import ReuseServing, TenantPipeline, backbone_pipeline
from repro_torch.serve import model_ops

ROOT = os.path.join(os.path.dirname(__file__), "..")
D, LPS = 32, 2
TOL = dict(rtol=2e-5, atol=2e-5)
CHECKSUM_TOL = dict(rtol=2e-5, atol=1e-4)


def _pipes(cls, n=5, **kw):
    kw = {"shared_stages": 2, "n_stages": 3, "d": D, "layers_per_stage": LPS, **kw}
    streams = ("urban", "meter", "taxi")
    return [cls(tenant=f"t{i}", stream=streams[i % 3], **kw) for i in range(n)]


def _digests(rs):
    return {t: rs.tenant_output(t) for t in sorted(rs.tenants)}


def _close_digests(got, want):
    assert set(got) == set(want)
    for tenant, sinks in want.items():
        assert set(got[tenant]) == set(sinks)
        for sink, dg in sinks.items():
            assert got[tenant][sink]["count"] == dg["count"], (tenant, sink)
            np.testing.assert_allclose(got[tenant][sink]["checksum"], dg["checksum"],
                                       **CHECKSUM_TOL)


@pytest.mark.parametrize("parts", [("embed", "base-7b@v1", 64), ("stage", "m", 3, 32),
                                   ("head", "m", "", 2560), ()])
def test_seed_is_the_references(parts):
    assert model_ops._seed(*parts) == ref_model_ops._seed(*parts)


@pytest.mark.parametrize("shape", [(8, 32), (32, 64), (64, 32), (32, 8)])
def test_proj_draws_the_references_weights(shape):
    seed = model_ops._seed("stage", "base-7b@v1", 1, shape[0])
    got = model_ops._proj(seed, shape).numpy()
    want = np.asarray(ref_model_ops._proj(seed, shape))
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("type_name,cfg,width", [
    ("lm_embed", {"model": "base-7b@v1", "d": D}, 8),
    ("lm_stage", {"model": "base-7b@v1", "layers": "0-1", "d": D}, D),
    ("lm_stage", {"model": "base-7b@v1+ft:t1", "layers": "4-6", "d": D}, D),
    ("lm_stage", {"model": "base-7b@v1", "layers": "2-2", "d": D}, D),
    ("lm_head", {"model": "base-7b@v1", "adapter": "t0", "d": D}, D),
])
def test_operators_apply_as_the_references(type_name, cfg, width):
    x = np.random.default_rng(7).standard_normal((16, width)).astype(np.float32)
    port = make_operator(type_name, cfg, "cpu")
    ref = ref_make_operator(type_name, cfg)
    assert port.type == ref.type == type_name  # not the OPMW fallback
    assert port.cost_weight == ref.cost_weight
    _, got = port.apply(port.init_state(16), torch.from_numpy(x))
    _, want = ref.apply(ref.init_state(16), x)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [{}, {"shared_stages": 1, "adapter": "ad"},
                                {"shared_stages": None, "n_stages": 2, "model": "x@v2"}])
def test_to_dataflow_is_the_references(kw):
    got = _pipes(TenantPipeline, n=1, **kw)[0].to_dataflow()
    want = _pipes(RefPipeline, n=1, **kw)[0].to_dataflow()
    assert got.name == want.name
    assert [(t.id, t.type, t.config) for t in got.tasks.values()] == \
        [(t.id, t.type, t.config) for t in want.tasks.values()]
    assert sorted(got.streams) == sorted(want.streams)
    assert backbone_pipeline("t0", d=D) == TenantPipeline(tenant="t0", d=D)


def _receipt(r):
    return (r.name, r.running_dag, r.sink_map, r.num_reused, r.num_created)


def _serve(cls, pipes, **kw):
    rs = cls(strategy="signature", base_batch=4, **kw)
    receipts = [_receipt(rs.add_tenant(p)) for p in pipes]
    return rs, receipts


@pytest.fixture(scope="module")
def both():
    """Both packages through the same script: 5 tenants, 2 steps, tenant t1
    removed, 2 more steps; what each observed after each part."""
    out = {}
    for name, cls, pipe_cls, kw in (("port", ReuseServing, TenantPipeline, {"device": "cpu"}),
                                    ("ref", RefServing, RefPipeline, {})):
        rs, receipts = _serve(cls, _pipes(pipe_cls), **kw)
        seen = {"receipts": receipts, "running": [rs.running_task_count],
                "stats": [rs.stats()]}
        rs.run(2)
        seen["digests"] = [_digests(rs)]
        removal = rs.remove_tenant("t1")
        seen["removal"] = (sorted(removal.terminated_tasks), sorted(removal.surviving_dags))
        seen["running"].append(rs.running_task_count)
        seen["stats"].append(rs.stats())
        rs.run(2)
        seen["digests"].append(_digests(rs))
        out[name] = seen
    return out


def test_receipts_counts_and_stats_are_the_references(both):
    port, ref = both["port"], both["ref"]
    assert port["receipts"] == ref["receipts"]
    assert port["running"] == ref["running"]
    assert port["removal"] == ref["removal"]
    assert port["stats"] == ref["stats"]  # deployed_cost exactly


def test_sink_digests_agree_across_a_removal(both):
    port, ref = both["port"], both["ref"]
    for got, want in zip(port["digests"], ref["digests"]):
        _close_digests(got, want)
    before, after = port["digests"]
    assert "t1" not in after
    for t in ("t0", "t2", "t3", "t4"):
        assert after[t][f"{t}/sink"]["count"] == before[t][f"{t}/sink"]["count"] + 2


def test_finetuned_stages_not_falsely_merged():
    rs = ReuseServing(strategy="signature", base_batch=4, device="cpu")
    rs.add_tenant(TenantPipeline(tenant="a", shared_stages=3, n_stages=3, d=D,
                                 layers_per_stage=LPS))
    base = rs.running_task_count
    rs.add_tenant(TenantPipeline(tenant="b", shared_stages=2, n_stages=3, d=D,
                                 layers_per_stage=LPS))
    # b reuses src+embed+stage0+stage1, adds its own stage2+head+sink
    assert rs.running_task_count - base == 3
    rs.system.close()


def test_none_and_signature_serve_the_same_outputs():
    runs = {}
    for strategy in ("none", "signature"):
        rs = ReuseServing(strategy=strategy, base_batch=4, device="cpu")
        for p in _pipes(TenantPipeline):
            rs.add_tenant(p)
        rs.run(4)
        runs[strategy] = (rs.running_task_count, _digests(rs))
        rs.system.close()
    assert runs["signature"][0] < runs["none"][0]
    assert runs["signature"][1] == runs["none"][1]


def test_dryrun_plans_the_same_capacity():
    dry = ReuseServing(strategy="signature", base_batch=4, backend="dryrun")
    ref = RefServing(strategy="signature", base_batch=4, backend="dryrun")
    for a, b in zip(_pipes(TenantPipeline, n=6), _pipes(RefPipeline, n=6)):
        assert _receipt(dry.add_tenant(a)) == _receipt(ref.add_tenant(b))
    assert dry.stats() == ref.stats()


def _cli(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-m", module, "--reuse", *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_reuse_cli_prints_the_references_line():
    got = _cli("repro_torch.launch.serve", "--device", "cpu")
    want = _cli("repro.launch.serve")
    assert got[0] == want[0] and got[0].startswith("tenants=6 running_tasks=")
    assert len(got) == len(want) == 7
    for g, w in zip(got[1:], want[1:]):
        tenant, _, rest = g.partition(" ")
        assert tenant == w.partition(" ")[0]
        _close_digests({tenant: ast.literal_eval(rest)},
                       {tenant: ast.literal_eval(w.partition(" ")[2])})


def test_the_port_example_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        "multi_tenant_serving_torch.py"),
                           "--device", "cpu"], capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "effective capacity 3.50×" in out and "bob ADMITTED (0 slots" in out
    assert "LM reuse-serving: 6 tenants on 33 running tasks, deployed cost 65.7" in out
    assert out.count(" -> 5 responses") == 5
