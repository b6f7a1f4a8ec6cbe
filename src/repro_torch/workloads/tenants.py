"""Multi-tenant submission traces for the serving front end.

Extends the §5.1 single-client traces to the serving setting: several
tenants independently churning submissions drawn from one shared dataflow
pool. Because tenants draw from the *same* pool, their running sets
overlap heavily — exactly the regime where slot-based admission with
reuse (new segments only) admits far more work than a reuse-blind pool.

Names are tenant-namespaced (``alice/opmw-03``) so the same pool DAG can
run for several tenants at once; :func:`tenant_copy` builds the renamed
:class:`~repro_torch.core.graph.Dataflow` (task ids are per-submission, so they
need no renaming).

The trace is a **lazy generator** — a million-event trace costs O(1)
memory — and is a pure function of its arguments (seeded generator,
sorted draws), so benchmark and conformance runs replay identically.
The port's copy of ``repro.workloads.tenants``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.graph import Dataflow


@dataclass(frozen=True)
class TenantEvent:
    tenant: str
    op: str  # "add" | "remove"
    name: str  # tenant-namespaced submission name ("alice/opmw-03")
    pool_name: str  # the pool dataflow it instantiates


def tenant_copy(df: Dataflow, tenant: str) -> Dataflow:
    """The tenant's instance of a pool dataflow: same graph, namespaced name."""
    return df.copy(f"{tenant}/{df.name}")


def tenant_trace(
    dags: Sequence[Dataflow],
    tenants: Sequence[str] = ("alice", "bob"),
    *,
    events: int = 1000,
    weights: Optional[Dict[str, float]] = None,
    p_remove: float = 0.4,
    seed: int = 11,
) -> Iterator[TenantEvent]:
    """Yield ``events`` add/remove events across ``tenants``.

    Each event first draws a tenant (probability proportional to
    ``weights``, default uniform), then flips a ``p_remove`` coin: remove
    a uniformly-drawn present submission of that tenant, or add a
    uniformly-drawn pool dataflow the tenant isn't currently running. A
    tenant with nothing present always adds; one running the whole pool
    always removes.
    """
    if not dags:
        raise ValueError("tenant_trace needs a non-empty dataflow pool")
    if not tenants:
        raise ValueError("tenant_trace needs at least one tenant")
    if not 0.0 <= p_remove < 1.0:
        raise ValueError(f"p_remove must be in [0, 1), got {p_remove}")
    rng = np.random.default_rng(seed)
    names = [d.name for d in dags]
    w = np.array([float((weights or {}).get(t, 1.0)) for t in tenants])
    if (w <= 0).any():
        raise ValueError("tenant weights must be positive")
    w = w / w.sum()
    # Per-tenant state as sorted lists so draws are a pure function of the
    # seed (set iteration order varies with PYTHONHASHSEED).
    present: Dict[str, List[str]] = {t: [] for t in tenants}
    absent: Dict[str, List[str]] = {t: list(names) for t in tenants}
    for _ in range(events):
        tenant = tenants[int(rng.choice(len(tenants), p=w))]
        do_remove = bool(rng.random() < p_remove)
        if (do_remove and present[tenant]) or not absent[tenant]:
            pool_name = present[tenant].pop(int(rng.integers(len(present[tenant]))))
            absent[tenant].append(pool_name)
            op = "remove"
        else:
            pool_name = absent[tenant].pop(int(rng.integers(len(absent[tenant]))))
            present[tenant].append(pool_name)
            op = "add"
        yield TenantEvent(
            tenant=tenant, op=op, name=f"{tenant}/{pool_name}", pool_name=pool_name
        )
