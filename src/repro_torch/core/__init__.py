"""The paper's primary contribution — collaborative reuse of streaming
dataflows: graph model (§3.1), equivalence (§3.2), system invariants (§3.3),
merge (§4.1) and unmerge (§4.2) algorithms, and the Reusable Dataflow
Manager (§4.3 control plane). The Storm-analogue data plane lives in
:mod:`repro_torch.runtime`; the beyond-paper Merkle-signature fast path in
:mod:`repro_torch.core.signatures`.
"""
from .equivalence import (
    AncestorGraph,
    EquivalenceChecker,
    ancestor_graph,
    ancestor_graph_set,
    ancestor_intersection,
    dataflows_disjoint,
    dedup,
    find_equivalent_tasks,
    is_dedup,
    maximal,
    maximal_ancestor_intersection,
)
from .graph import (
    SINK_CONFIG,
    SOURCE_CONFIG,
    AbstractTask,
    Dataflow,
    DataflowError,
    Stream,
    Task,
    canonical_config,
    down,
    up,
)
from .invariants import InvariantViolation, check_all, check_minimization, check_sink_coverage
from .manager import RemovalReceipt, ReuseManager, SubmissionReceipt
from .merge import MergePlan, apply_merge, build_plan, find_overlapping, plan_merge
from .signatures import SignatureIndex, compute_signatures, dedup_fast, is_dedup_fast, signature_of
from .strategies import (
    MergeStrategy,
    available_strategies,
    register_strategy,
    resolve_strategy,
)
from .unmerge import UnmergePlan, apply_unmerge, plan_unmerge

__all__ = [
    "AbstractTask",
    "AncestorGraph",
    "Dataflow",
    "DataflowError",
    "EquivalenceChecker",
    "InvariantViolation",
    "MergePlan",
    "MergeStrategy",
    "RemovalReceipt",
    "ReuseManager",
    "SINK_CONFIG",
    "SOURCE_CONFIG",
    "SignatureIndex",
    "Stream",
    "SubmissionReceipt",
    "Task",
    "UnmergePlan",
    "ancestor_graph",
    "ancestor_graph_set",
    "ancestor_intersection",
    "apply_merge",
    "apply_unmerge",
    "available_strategies",
    "build_plan",
    "canonical_config",
    "check_all",
    "check_minimization",
    "check_sink_coverage",
    "compute_signatures",
    "dataflows_disjoint",
    "dedup",
    "dedup_fast",
    "down",
    "find_equivalent_tasks",
    "find_overlapping",
    "is_dedup",
    "is_dedup_fast",
    "maximal",
    "maximal_ancestor_intersection",
    "plan_merge",
    "plan_unmerge",
    "register_strategy",
    "resolve_strategy",
    "signature_of",
    "up",
]
