"""Multi-tenant LM serving with collaborative dataflow reuse — the paper's
technique as a first-class framework feature (the port of
``repro/serve/reuse_serving.py``).

Tenant pipelines over shared request streams duplicate backbone prefix
work (same base checkpoint, same lower layer ranges). Expressed as
dataflows and routed through :class:`repro_torch.core.ReuseManager`, N
tenants sharing a backbone pay for **one** copy of the shared prefix; each
keeps its own adapter/head and any fine-tuned upper stages. Removing a
tenant unmerges per the paper §4.2 — surviving tenants are untouched. The
stages step on the card (``backend="torch"``) unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.core.graph import Dataflow, Task, SINK_CONFIG, SOURCE_CONFIG
from repro_torch.runtime.system import StreamSystem

from . import model_ops  # noqa: F401 — registers lm_* operator types


@dataclass(frozen=True)
class TenantPipeline:
    """Declarative tenant spec.

    ``shared_stages`` of the backbone come from the base checkpoint
    (reusable across tenants of the same model); stages above that are
    tenant-fine-tuned (configs embed the tenant's checkpoint id, so they
    are never falsely merged). ``d``/``layers_per_stage`` control cost.
    """

    tenant: str
    stream: str = "urban"          # request source stream
    model: str = "base-7b@v1"      # base checkpoint id
    d: int = 64
    n_stages: int = 4
    layers_per_stage: int = 4
    shared_stages: Optional[int] = None  # default: all stages shared
    adapter: str = ""              # tenant head/adapter checkpoint id

    def to_dataflow(self) -> Dataflow:
        df = Dataflow(self.tenant)
        src = Task.make(f"{self.tenant}/src", f"prompts:{self.stream}", SOURCE_CONFIG)
        df.add_task(src)
        prev = src.id
        emb = Task.make(
            f"{self.tenant}/embed", "lm_embed", {"model": self.model, "d": self.d}
        )
        df.add_task(emb)
        df.add_stream(prev, emb.id)
        prev = emb.id
        shared = self.n_stages if self.shared_stages is None else self.shared_stages
        for s in range(self.n_stages):
            lo = s * self.layers_per_stage
            hi = lo + self.layers_per_stage - 1
            ckpt = self.model if s < shared else f"{self.model}+ft:{self.tenant}"
            t = Task.make(
                f"{self.tenant}/stage{s}",
                "lm_stage",
                {"model": ckpt, "layers": f"{lo}-{hi}", "d": self.d},
            )
            df.add_task(t)
            df.add_stream(prev, t.id)
            prev = t.id
        head = Task.make(
            f"{self.tenant}/head",
            "lm_head",
            {"model": self.model, "adapter": self.adapter or self.tenant, "d": self.d},
        )
        df.add_task(head)
        df.add_stream(prev, head.id)
        sink = Task.make(f"{self.tenant}/sink", f"respond:{self.tenant}", SINK_CONFIG)
        df.add_task(sink)
        df.add_stream(head.id, sink.id)
        return df


def backbone_pipeline(tenant: str, **kw) -> TenantPipeline:
    return TenantPipeline(tenant=tenant, **kw)


class ReuseServing:
    """StreamSystem wrapper speaking tenants instead of raw dataflows.

    ``backend`` picks the data plane from the ExecutionBackend registry:
    ``"torch"`` (default) serves real batches on ``device`` (the card
    unless ``device="cpu"``); ``"dryrun"`` gives capacity-planning answers
    (tenant counts, deployed cost) on no device; ``"sharded"`` spreads
    tenant segments over the cards.
    """

    def __init__(
        self,
        strategy: str = "signature",
        base_batch: int = 8,
        backend: str = "torch",
        device: Optional[Any] = None,
    ):
        self.system = StreamSystem(
            strategy=strategy, base_batch=base_batch, backend=backend, device=device
        )
        self.tenants: Dict[str, TenantPipeline] = {}

    def add_tenant(self, pipe: TenantPipeline):
        receipt = self.system.submit(pipe.to_dataflow())
        self.tenants[pipe.tenant] = pipe
        return receipt

    def remove_tenant(self, tenant: str):
        del self.tenants[tenant]
        return self.system.remove(tenant)

    def step(self):
        return self.system.step()

    def run(self, steps: int):
        return self.system.run(steps)

    def tenant_output(self, tenant: str):
        return self.system.sink_digests(tenant)

    @property
    def running_task_count(self) -> int:
        return self.system.running_task_count

    def stats(self) -> Dict[str, float]:
        deployed_cost = 0.0
        for seg in self.system.backend.segments.values():
            for tid in seg.live_task_ids():
                deployed_cost += seg.cost_of[tid]
        return {
            "tenants": len(self.tenants),
            "running_tasks": self.system.running_task_count,
            "deployed_tasks": self.system.deployed_task_count,
            "deployed_cost": deployed_cost,
        }
