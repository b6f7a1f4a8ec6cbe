"""TorchBackend — the port's data plane behind the ExecutionBackend API.

Steps deployed segments in launch order: merges only ever add segments
downstream of existing ones (boundary streams flow old → new), so launch
order is a valid topological order of the segment graph. Task states and
streams are torch tensors on the backend's device; the operators launch
the port's CUDA kernels when that device is the card.

The port of ``repro.runtime.executor.InProcessJitBackend``: PyTorch runs
eagerly, so a segment has no compile step, and the step ends by waiting
for the card's stream, where the reference calls ``jax.block_until_ready``,
so that ``segment_ms`` measures compute rather than enqueueing.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.graph import Dataflow

from .backend import ExecutionBackend, PyTree, SegmentSpec
from .broker import Broker, topic_for
from .segment import Segment, build_segment


def resolve_device(device: Optional[Any]) -> torch.device:
    """The caller's device, or the card. Without a card and without an
    explicit device this raises: the port never slips onto the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


class TorchBackend(ExecutionBackend):
    """Segments of torch operators, broker topics between them, task states
    on ``device`` (the card unless the caller passes ``device="cpu"``)."""

    name = "torch"

    def __init__(self, device: Optional[Any] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.broker = Broker()

    def _build(
        self,
        spec: SegmentSpec,
        dataflow: Dataflow,
        init_states: Optional[Dict[str, PyTree]],
    ) -> Segment:
        return build_segment(spec, dataflow, init_states=init_states, device=self.device)

    def _drop_streams(self, seg: Segment) -> None:
        for tid in seg.spec.task_ids:
            self.broker.drop(topic_for(tid))

    def _step_one(self, seg: Segment) -> None:
        inputs = {t: self.broker.fetch(t) for t in seg.boundary_topics}
        new_states, outputs = seg.step_fn(seg.states, seg.active, inputs)
        seg.states = new_states
        for tid in self.forwarding[seg.name]:
            if tid in outputs:
                self.broker.publish(topic_for(tid), outputs[tid])
        # The Storm worker finishes its batch before acking: wait for the
        # card so segment_ms measures compute, not enqueueing.
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
