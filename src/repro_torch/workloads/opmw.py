"""OPMW-like synthetic workflow collection (paper §5.1).

The port's copy of ``repro.workloads.opmw``: the same seed gives the same
DAGs, task for task.

Structure: G source groups, each with a shared prefix *chain* of abstract
tasks (the paper's Fig. 1 pattern — members of a group reuse nested
prefixes); each DAG appends a unique suffix whose task types are drawn
from a global pool with replacement (same type, different ancestry ⇒
type-similar but NOT equivalent — this is why the paper's 219 unique
abstract tasks still need ≈274 running tasks).

Calibrated (seed=7) to: 35 DAGs, 471 task instances, ~219 unique abstract
tasks, ~270 equivalence classes, sizes within 2–38.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.api.builder import flow
from repro_torch.core.graph import Dataflow

N_DAGS = 35
TOTAL_TASKS = 471
N_GROUPS = 6
SUFFIX_POOL = 520
SINK_TYPES = 5


def opmw_workload(seed: int = 7) -> List[Dataflow]:
    rng = np.random.default_rng(seed)
    # group membership: 6 groups over 35 DAGs, ≥3 members each
    sizes = [8, 7, 6, 6, 4, 4]
    assert sum(sizes) == N_DAGS
    # shared prefix chain lengths per group
    chain_len = [9, 9, 8, 8, 7, 7]

    dags: List[Dataflow] = []
    # prefix depth for each DAG: mostly deep (encourages nesting reuse)
    depths: List[int] = []
    groups: List[int] = []
    for g, n in enumerate(sizes):
        for _ in range(n):
            depths.append(int(rng.integers(chain_len[g] // 2, chain_len[g] + 1)))
            groups.append(g)
    depths[0] = 0  # the paper's 2-task DAG (source → sink)
    # suffix lengths: meet the exact total
    #   total = Σ (1 src + depth + suffix + 1 sink)
    base = N_DAGS * 2 + sum(depths)
    suffix_total = TOTAL_TASKS - base
    assert suffix_total > 0
    raw = rng.dirichlet(np.ones(N_DAGS) * 1.2) * suffix_total
    suffix = np.maximum(np.round(raw).astype(int), 0)
    # exact adjustment + per-DAG max size 38
    while suffix.sum() != suffix_total:
        i = int(rng.integers(N_DAGS))
        if suffix.sum() < suffix_total:
            suffix[i] += 1
        elif suffix[i] > 0:
            suffix[i] -= 1
    suffix[0] = 0  # keep the 2-task DAG minimal
    # one 38-task DAG (the paper's max)
    big = 1
    grow = 38 - 2 - depths[big] - suffix[big]
    suffix[big] += grow
    donors = [i for i in range(N_DAGS) if i not in (0, big)]
    while grow > 0:
        j = donors[int(rng.integers(len(donors)))]
        if suffix[j] > 0:
            suffix[j] -= 1
            grow -= 1
    for i in range(N_DAGS):
        cap = 38 - 2 - depths[i]
        while suffix[i] > cap:
            j = int(rng.integers(N_DAGS))
            if j not in (0, big) and suffix[j] < 38 - 2 - depths[j]:
                suffix[i] -= 1
                suffix[j] += 1

    for i in range(N_DAGS):
        g = groups[i]
        d = depths[i]
        name = f"opmw{i:02d}"
        b = flow(name).source(f"opmw-src-{g}")
        for k in range(d):
            # shared prefix task: type+config identical across the group
            b.then(f"g{g}.step{k}", stage=k)
        for k in range(int(suffix[i])):
            b.then(f"op{int(rng.integers(SUFFIX_POOL))}")
        b.sink(f"store{int(rng.integers(SINK_TYPES))}")
        dags.append(b.build())
    assert sum(len(d) for d in dags) == TOTAL_TASKS
    return dags


def workload_stats(dags: List[Dataflow]) -> dict:
    from repro_torch.core.signatures import compute_signatures

    total = sum(len(d) for d in dags)
    abstract = {(t.type, t.config) for d in dags for t in d.tasks.values()}
    classes = set()
    for d in dags:
        sigs = compute_signatures(d)
        classes |= set(sigs.values())
    sizes = [len(d) for d in dags]
    return {
        "dags": len(dags),
        "total_tasks": total,
        "unique_abstract": len(abstract),
        "equiv_classes": len(classes),
        "min_size": min(sizes),
        "max_size": max(sizes),
    }
