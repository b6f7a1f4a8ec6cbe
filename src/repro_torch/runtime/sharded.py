"""ShardedBackend — the torch data plane spread across devices.

Each segment is pinned to one device slot by a pluggable
:class:`~repro_torch.runtime.scheduler.PlacementPolicy` (round-robin by
default — the Storm scheme generalized from worker slots to devices). A
segment's task states and step live on its slot's device; boundary
batches fetched from the transport are moved to the consuming segment's
device before its step, so cross-device streams pay exactly one transfer
per hop — the device-mesh analogue of the paper's broker indirection.

Placement bookkeeping (slot map, EWMA device aggregates with idle decay,
policy-driven straggler migration, restore-time sticky hints) is shared
with the multiproc backend via
:class:`~repro_torch.runtime.scheduler.PlacedBackendMixin`.

The port's copy of ``repro.runtime.sharded``. ``devices=None`` means
every CUDA device of the machine; the tests pass ``devices=["cpu"] * 3``,
as the reference's pass its one host device three times. Slots may name
one device more than once. Where two slots share a device, a move between
them keeps the segment as it is; a move to another device carries the
states over and rebuilds the segment's step there, from the backend's one
step cache (its canonical step on that device; the move counts nothing,
as the reference's ``device_put`` of the states counts nothing), and
drops its captured graphs, whose static buffers live at fixed addresses
of the old device — the next step runs eager and captures anew.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core.graph import Dataflow

from .backend import PyTree, SegmentSpec
from .executor import TorchBackend
from .graphs import map_leaves
from .scheduler import PlacedBackendMixin, PlacementPolicy
from .segment import Segment


def _cuda_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "ShardedBackend places segments across the CUDA devices and none is "
            "available; pass devices=['cpu', ...] to place them on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def _as_device(device: Any) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class ShardedBackend(PlacedBackendMixin, TorchBackend):
    name = "sharded"

    def __init__(
        self,
        placement: Union[str, PlacementPolicy] = "round_robin",
        devices: Optional[Sequence[Any]] = None,
        ewma_decay: float = 0.6,
        step_mode: str = "sync",
        max_workers: Optional[int] = None,
        transport: Any = "inproc",
        transport_options: Optional[Dict[str, Any]] = None,
    ):
        self.devices: List[torch.device] = (
            [_as_device(d) for d in devices] if devices is not None else _cuda_devices())
        if not self.devices:
            raise ValueError("ShardedBackend needs at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"ShardedBackend's devices must be of one type, got {self.devices}")
        super().__init__(
            device=self.devices[0],
            step_mode=step_mode,
            max_workers=max_workers,
            transport=transport,
            transport_options=transport_options,
        )
        self._init_placement(placement, ewma_decay=ewma_decay)

    # -- placement hooks (PlacedBackendMixin) -----------------------------------
    def _n_slots(self) -> int:
        return len(self.devices)

    def _device_of_segment(self, name: str) -> torch.device:
        return self.devices[self.device_of[name]]

    def _move_segment(self, seg: Segment, old: int, new: int) -> None:
        """Migrate a segment to slot ``new``. On the same device nothing
        moves. To another device its states go over and its step is
        rebuilt there; its graphs, staging and events are dropped."""
        device = self.devices[new]
        if device == self.devices[old]:
            return
        df = Dataflow(seg.spec.dag_name)
        for tid in seg.spec.task_ids:
            df.add_task(self.task_defs[tid])
        states = map_leaves(lambda t: t.to(device), seg.states)
        moved = self._build_on(seg.spec, df, states, device, count=False)
        if seg.graphs is not None:
            seg.graphs.release()
        seg.operators, seg.step_fn, seg.states = moved.operators, moved.step_fn, moved.states
        seg.boundary_topics, seg.fused_runs, seg.graphs = (
            moved.boundary_topics, moved.fused_runs, moved.graphs)
        self._seg_events.pop(seg.spec.name, None)
        if self._staging is not None:
            self._staging.pop(seg.spec.name, None)

    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
    ) -> Segment:
        device = self.devices[self._assign_slot(spec)]
        if init_states:
            init_states = map_leaves(lambda t: t.to(device), init_states)
        return self._build_on(spec, dataflow, init_states, device)

    def _fetch_inputs(self, seg: Segment) -> Dict[str, Any]:
        """Move boundary batches onto the consuming segment's device (one
        transfer per cross-segment hop); per-topic synchronization comes
        from the base fetch (concurrent steps sync on producers only)."""
        device = self._device_of_segment(seg.spec.name)
        return {t: batch.to(device) for t, batch in super()._fetch_inputs(seg).items()}

    # -- durability hooks ---------------------------------------------------------
    def _dump_extra(self) -> Dict[str, Any]:
        extra = super()._dump_extra()
        extra["device_of"] = {name: int(i) for name, i in self.device_of.items()}
        extra["n_devices"] = len(self.devices)
        return extra

    def _restore_extra(self, extra: Dict[str, Any]) -> None:
        super()._restore_extra(extra)
        self.device_of_at_checkpoint = {
            name: int(i) for name, i in extra.get("device_of", {}).items()
        }
        if extra.get("n_devices") is not None:
            self._n_slots_at_checkpoint = int(extra["n_devices"])

    def spawn_config(self) -> Dict[str, Any]:
        cfg = super().spawn_config()
        if getattr(self.policy, "name", ""):
            cfg["placement"] = self.policy.name
        return cfg
