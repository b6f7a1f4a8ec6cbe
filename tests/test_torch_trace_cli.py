"""The port's trace-replay CLI (``python -m repro_torch.launch.dryrun
--trace ...``) against the reference's (``repro.launch.dryrun``):

  * on ``backend="dryrun"`` the per-event series (live and paused tasks,
    cores) equal the reference's for ``opmw/rw1`` and ``riot/seq``;
  * crash-resume stitching, as ``tests/test_recovery.py::TestCliRecovery``
    holds the reference's: a run cut at ``--max-events`` and resumed with
    ``--restore`` gives the uninterrupted series, on ``dryrun`` and on the
    port's ``torch`` backend (``--device cpu``); ``--restore`` without
    ``--checkpoint-dir`` fails;
  * the chaos smoke: ``--backend multiproc --supervise --autoscale 1:3
    --kill-worker-at 6`` completes with a respawn in ``worker_health`` and
    the sink counts and series of the un-killed run.

``makespan_ms`` is measured host time in both packages, so the identities
cover the counter series.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch.dryrun import _parse_autoscale, run_dataflow_trace

SERIES = ("live_tasks", "paused_tasks", "cores")
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run_cli(args, module="repro_torch.launch.dryrun"):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )


@pytest.mark.parametrize("spec", ["opmw/rw1", "riot/seq"])
def test_dryrun_series_equal_the_references(spec, tmp_path):
    got = run_dataflow_trace(spec, backend="dryrun")
    # the reference's module sets XLA_FLAGS when imported: it runs apart
    out = str(tmp_path / "ref.json")
    proc = _run_cli(["--trace", spec, "--backend", "dryrun", "--json", out],
                    module="repro.launch.dryrun")
    assert proc.returncode == 0, proc.stderr
    want = json.load(open(out))
    assert {k: got["series"][k] for k in SERIES} == {k: want["series"][k] for k in SERIES}
    for key in ("events", "events_applied", "peak_live_tasks", "peak_paused_tasks",
                "peak_cores", "backend", "strategy", "step_mode", "resumed_at_event"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("backend", [["--backend", "dryrun"], ["--device", "cpu"]],
                         ids=["dryrun", "torch"])
def test_crash_resume_matches_uninterrupted(backend, ckpt_dir, tmp_path):
    full, part, rest = (str(tmp_path / f"{n}.json") for n in ("full", "part", "rest"))
    base = _run_cli(["--trace", "riot/seq", *backend, "--json", full])
    assert base.returncode == 0, base.stderr
    crash = _run_cli(["--trace", "riot/seq", *backend, "--checkpoint-dir", ckpt_dir,
                      "--max-events", "17", "--json", part])
    assert crash.returncode == 0, crash.stderr
    # --restore takes the checkpointed backend; --device places it
    placed = backend if backend[0] == "--device" else []
    resume = _run_cli(["--trace", "riot/seq", *placed, "--checkpoint-dir", ckpt_dir,
                       "--restore", "--json", rest])
    assert resume.returncode == 0, resume.stderr
    full_rec, part_rec, rest_rec = (json.load(open(p)) for p in (full, part, rest))
    assert rest_rec["resumed_at_event"] == 17
    assert rest_rec["backend"] == full_rec["backend"] == ("dryrun" if "dryrun" in backend
                                                          else "torch")
    stitched = {k: part_rec["series"][k] + rest_rec["series"][k] for k in SERIES}
    assert stitched == {k: full_rec["series"][k] for k in SERIES}


def test_restore_without_checkpoint_dir_fails():
    proc = _run_cli(["--trace", "riot/seq", "--restore"])
    assert proc.returncode != 0
    assert "--checkpoint-dir" in (proc.stderr + proc.stdout)


def test_bad_trace_and_autoscale_specs_fail():
    with pytest.raises(SystemExit, match="--trace must be"):
        run_dataflow_trace("nope/seq", backend="dryrun")
    with pytest.raises(SystemExit, match="MIN:MAX"):
        _parse_autoscale("x:y")
    assert _parse_autoscale("1:3") == {"min_workers": 1, "max_workers": 3}
    assert _parse_autoscale(None) is None


def test_killed_worker_under_supervision_keeps_the_counts():
    args = dict(backend="multiproc", device="cpu", workers=2, max_events=12)
    want = run_dataflow_trace("riot/seq", **args)
    got = run_dataflow_trace("riot/seq", supervise=True, autoscale=_parse_autoscale("1:3"),
                             kill_worker_at=6, **args)
    assert got["worker_health"]["respawns"] >= 1
    kinds = [e["kind"] for e in got["worker_health"]["events"]]
    assert "worker-respawned" in kinds and "segment-redeployed" in kinds
    assert got["worker_health"]["autoscale"]["max_workers"] == 3
    assert got["sink_counts"] == want["sink_counts"] and got["sink_counts"]
    assert {k: got["series"][k] for k in SERIES} == {k: want["series"][k] for k in SERIES}
