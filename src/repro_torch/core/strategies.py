"""Pluggable equivalence-strategy registry for the Reusable Dataflow Manager.

The paper fixes one equivalence engine (the §3.2 bijection check); this
reproduction grew a second (the Merkle-signature fast path) and a baseline
("none", the Default of §5). Rather than a stringly-typed switch inside
:class:`repro_torch.core.manager.ReuseManager`, each engine is a
:class:`MergeStrategy` registered by name — new engines (e.g. approximate
or cost-aware matching) plug in without editing the manager:

    @register_strategy
    class MyStrategy(MergeStrategy):
        name = "mine"
        def plan(self, mgr, df, merged_name, sigs=None): ...

``ReuseManager(strategy=...)`` accepts either a registered name or a
strategy instance.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Type, Union

from .graph import Dataflow
from .merge import MergePlan, _match_faithful, _match_signature, build_plan, find_overlapping
from .signatures import compute_signatures

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (manager imports us)
    from .manager import ReuseManager


class MergeStrategy:
    """Equivalence engine interface used by the manager's submit/remove.

    Class attributes describe capabilities:
      * ``reuses`` — False for the no-reuse Default baseline; the manager
        then plans every submission afresh.
      * ``supports_batch`` — True when :meth:`repro_torch.core.manager.ReuseManager.submit_many`
        may use the batch-aware planner (one signature pass + one merged-DAG
        rebuild per connected group) instead of N sequential submits.
      * ``wants_signatures`` — True when :meth:`plan` benefits from the
        precomputed Merkle signatures of the submitted DAG.
    """

    name: str = ""
    reuses: bool = True
    supports_batch: bool = False
    wants_signatures: bool = False

    def plan(
        self,
        mgr: "ReuseManager",
        df: Dataflow,
        merged_name: str,
        sigs: Optional[Dict[str, str]] = None,
    ) -> MergePlan:
        raise NotImplementedError

    def batch_match(
        self,
        mgr: "ReuseManager",
        df: Dataflow,
        sigs: Dict[str, str],
        overlap_tasks,
        created_by_sig: Dict[str, str],
    ) -> Dict[str, str]:
        """Match one batch member against the running overlap *plus* tasks
        already planned by earlier batch members (``created_by_sig``).

        Required when ``supports_batch`` is True — the manager's
        :meth:`~repro_torch.core.manager.ReuseManager.submit_many` delegates all
        batch matching here so custom engines keep their own semantics.
        """
        raise NotImplementedError(
            f"strategy {self.name!r} sets supports_batch but does not implement batch_match"
        )

    # -- lifecycle hooks (index maintenance etc.) ---------------------------
    def on_merged(
        self,
        mgr: "ReuseManager",
        df: Dataflow,
        plan: MergePlan,
        sigs: Optional[Dict[str, str]] = None,
    ) -> None:
        pass

    def on_unmerged(self, mgr: "ReuseManager", terminated_tasks) -> None:
        pass

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} {self.name!r}>"


_STRATEGIES: Dict[str, Type[MergeStrategy]] = {}


def register_strategy(cls: Type[MergeStrategy]) -> Type[MergeStrategy]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"strategy class {cls.__name__} has no name")
    if cls.name in _STRATEGIES:
        raise ValueError(f"equivalence strategy {cls.name!r} already registered")
    _STRATEGIES[cls.name] = cls
    return cls


def available_strategies() -> List[str]:
    return sorted(_STRATEGIES)


def resolve_strategy(strategy: Union[str, MergeStrategy, Type[MergeStrategy]]) -> MergeStrategy:
    """Name / instance / class → strategy instance (names hit the registry)."""
    if isinstance(strategy, MergeStrategy):
        return strategy
    if isinstance(strategy, type) and issubclass(strategy, MergeStrategy):
        return strategy()
    if isinstance(strategy, str):
        cls = _STRATEGIES.get(strategy)
        if cls is None:
            raise ValueError(
                f"unknown strategy {strategy!r} (registered: {', '.join(available_strategies())})"
            )
        return cls()
    raise TypeError(f"strategy must be a name or MergeStrategy, got {type(strategy).__name__}")


# -- built-in engines ---------------------------------------------------------


@register_strategy
class SignatureStrategy(MergeStrategy):
    """Merkle-signature index matching — beyond-paper O(V+E) fast path."""

    name = "signature"
    supports_batch = True
    wants_signatures = True

    def plan(self, mgr, df, merged_name, sigs=None):
        overlapping = find_overlapping(mgr.running, df)
        matches = _match_signature(mgr.index, mgr.running, overlapping, df, sigs=sigs)
        return build_plan(df, matches, overlapping, mgr._mint_task_id, merged_name)

    def batch_match(self, mgr, df, sigs, overlap_tasks, created_by_sig):
        matches: Dict[str, str] = {}
        for tid, sig in sigs.items():
            hit = mgr.index.lookup(sig)
            if hit is not None and hit in overlap_tasks:
                matches[tid] = hit
            elif sig in created_by_sig:
                # Cross-submission dedup: an earlier batch member already
                # planned an equivalent task — reuse it, pay nothing.
                matches[tid] = created_by_sig[sig]
        return matches

    def on_merged(self, mgr, df, plan, sigs=None):
        # A created running task is equivalent to its submitted counterpart,
        # so it inherits that signature.
        if sigs is None:
            sigs = compute_signatures(df)
        for sub_id, run_id in plan.created.items():
            mgr.index.add(run_id, sigs[sub_id])

    def on_unmerged(self, mgr, terminated_tasks):
        mgr.index.remove_tasks(terminated_tasks)


@register_strategy
class FaithfulStrategy(MergeStrategy):
    """The paper's §3.2 ancestor-graph bijection check."""

    name = "faithful"

    def plan(self, mgr, df, merged_name, sigs=None):
        overlapping = find_overlapping(mgr.running, df)
        merged_view = Dataflow("__Y__")
        for name in overlapping:
            for t in mgr.running[name].tasks.values():
                merged_view.add_task(t)
            for s in mgr.running[name].streams:
                merged_view.add_stream(*s)
        matches = _match_faithful(merged_view, df)
        return build_plan(df, matches, overlapping, mgr._mint_task_id, merged_name)


@register_strategy
class NoReuseStrategy(MergeStrategy):
    """The Default baseline — every submission runs independently (§5)."""

    name = "none"
    reuses = False

    def plan(self, mgr, df, merged_name, sigs=None):
        plan = MergePlan(submitted_name=df.name, merged_name=merged_name, overlapping=[])
        for tid in df.topological_order():
            plan.created[tid] = mgr._mint_task_id(df.tasks[tid].type)
        for s_up, s_down in df.streams:
            plan.new_streams_internal.append((plan.created[s_up], plan.created[s_down]))
        return plan
