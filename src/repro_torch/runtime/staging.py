"""Boundary batches across the host, for segments stepping on a torch device.

The shm and tcp transports carry numpy arrays. A segment that steps on a
torch device fetches each boundary input from such a transport as a
tensor on its device and hands its forwarded outputs back as numpy
arrays. :class:`HostStaging` holds one segment's buffers for that route;
the worker processes' segment runner and the in-process torch backend
over ``transport="shm"``/``"tcp"`` both use it.

On the CPU an input is a validated private copy of the batch, so no state
(a sink's retained batch) aliases a shm ring or a tcp frame, and an
output is the tensor's own memory, which the transport copies as it
publishes. On the card an input goes through a pinned staging buffer to
the device and an output back through a pinned buffer, with one
synchronize before the caller publishes: no tensor of the card reaches
the transport.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


class HostStaging:
    """One segment's staging buffers between a numpy transport and
    ``device`` (pinned host memory on the card, none on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stage: Dict[str, torch.Tensor] = {}  # topic -> pinned input buffer
        self._host: Dict[str, torch.Tensor] = {}  # task id -> pinned output buffer

    def fetch(self, transport: Any, topic: str, target: Optional[int]) -> torch.Tensor:
        """One boundary input as a tensor on the device (``target``: the
        producer's publish this read must observe, in a concurrent step).

        On the card, a view-capable transport (shm) hands back a read-only
        view of the ring and its sequence token: the view is copied into
        the pinned staging buffer, the token is validated after that copy,
        and a lapped view is fetched again as a private copy, so each
        batch is read exactly once either way. The staged batch then goes
        to the card on the current stream."""
        if self.device.type != "cuda":
            arr = (transport.fetch_synced(topic, target, copy=True) if target is not None
                   else transport.fetch(topic, copy=True))
            return torch.from_numpy(arr)
        views = getattr(transport, "fetch_view", None)
        if views is not None:
            arr, token = views(topic, min_seq=target)
        elif target is not None:
            arr, token = transport.fetch_synced(topic, target), None
        else:
            arr, token = transport.fetch(topic), None
        stage = self._stage.get(topic)
        if stage is None or tuple(stage.shape) != arr.shape or stage.numpy().dtype != arr.dtype:
            stage = self._stage[topic] = torch.from_numpy(np.empty_like(arr)).pin_memory()
        np.copyto(stage.numpy(), arr)
        if token is not None and not transport.view_valid(topic, token):
            np.copyto(stage.numpy(), transport.fetch(topic, copy=True))
        return stage.to(self.device, non_blocking=True)

    def to_host(self, outputs: Dict[str, torch.Tensor], tids: List[str]) -> Dict[str, np.ndarray]:
        """The outputs of ``tids`` as numpy arrays, ready to publish. On the
        card each is copied into its pinned buffer, and the current stream
        is synchronized once: the step's work and these copies are done
        before anything is published (the Storm worker finishes its batch
        before acking)."""
        if self.device.type != "cuda":
            return {tid: outputs[tid].numpy() for tid in tids}
        for tid in tids:
            src = outputs[tid]
            host = self._host.get(tid)
            if host is None or host.shape != src.shape or host.dtype != src.dtype:
                host = self._host[tid] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return {tid: self._host[tid].numpy() for tid in tids}
