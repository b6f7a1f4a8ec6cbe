"""RIoTBench-style IoT application collection (paper §5.1).

21 dataflows with *real* task logic (repro_torch.ops.riot) over the 3 IoT
sources: 7 application variants per source — ETL, two STATS variants,
distinct-count, two predictive-analytics variants, and a short ETL —
sharing the senml-parse → range-filter → bloom-filter prefix and parts of
the mid-chain (the window op is shared by both STATS variants, the
interpolate by ETL and both PRED variants — real cross-app reuse, not
just prefix nesting).

Calibrated to: 21 DAGs, 138 total tasks, 19 distinct task types, sizes
4–8, ≈75 equivalence classes (the paper's Reuse peak).
"""
from __future__ import annotations

from typing import List

from repro_torch.api.builder import flow
from repro_torch.core.graph import Dataflow

SOURCES = ("urban", "meter", "taxi")


def _chain(name: str, src_type: str, steps, sink_type: str = "store") -> Dataflow:
    b = flow(name).source(src_type)
    for typ, cfg in steps:
        b.then(typ, **cfg)
    return b.sink(sink_type).build()


def riot_workload(seed: int = 0) -> List[Dataflow]:
    dags: List[Dataflow] = []
    for s, src in enumerate(SOURCES):
        pre = [
            ("senml_parse", {"schema": src}),
            ("range_filter", {"lo": -100 + s, "hi": 100 + s}),
            ("bloom_filter", {"bits": 1024}),
        ]
        pred_pre = [
            ("csv_parse", {"cols": 5 + s}),
            ("range_filter", {"lo": -50, "hi": 50}),
        ]
        interp = ("interpolate", {"k": 2})
        win = ("win", {"w": 16})
        # 1. ETL (8): parse prefix + interpolate + annotate + kalman
        dags.append(
            _chain(
                f"{src}_etl", src,
                pre + [interp, ("annotate", {"meta": src}), ("kalman", {"q": 0.5})],
            )
        )
        # 2. STATS-average (7): shares the window op with #3
        dags.append(_chain(f"{src}_stats_avg", src, pre + [win, ("avg", {"n": 8})]))
        # 3. STATS-moment (8): shares the window op with #2
        dags.append(
            _chain(f"{src}_stats_mom", src, pre + [win, ("moment2", {}), ("sliding_linreg", {"w": 8})])
        )
        # 4. distinct count (6)
        dags.append(_chain(f"{src}_distinct", src, pre + [("distinct_count", {"h": 4})]))
        # 5. PRED linear regression (7): csv prefix, shares interp with #6
        dags.append(
            _chain(
                f"{src}_pred_lr", src,
                pred_pre + [interp, ("linreg", {"d": 4}), ("error_estimate", {})],
            )
        )
        # 6. PRED decision tree (6)
        dags.append(_chain(f"{src}_pred_dt", src, pred_pre + [interp, ("dtree", {"depth": 3})]))
        # 7. short Kalman smoothing (4): shares only the senml parse
        dags.append(
            _chain(
                f"{src}_kalman", src,
                [("senml_parse", {"schema": src}), ("kalman", {"q": 0.1})],
            )
        )
    total = sum(len(d) for d in dags)
    assert total == 138, total
    return dags
