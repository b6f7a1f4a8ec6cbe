"""Multi-tenant serving with collaborative reuse on the PyTorch port — the
paper's merge algorithms as admission control, with the merged dataflows
stepping on the card.

Part 1 starts a ServeFrontend (slot-based admission over one ReuseSession
on the ``torch`` backend) on a local socket and drives it with ServeClient
as external tenants would: alice and bob submit overlapping RIoT
dataflows, and because a submission that merges into running work is
charged only its *new* segments, the same slot pool carries far more than
its nominal capacity. A removal frees slots without touching the other
tenant.

Part 2 is the library-level integration: ReuseServing merges LM adapter
pipelines in process, without a server. Six tenants over three request
streams share 3 of 4 backbone stages with the tenants of their stream;
removing one leaves the others streaming.

    PYTHONPATH=src python examples/multi_tenant_serving_torch.py               # on the card
    PYTHONPATH=src python examples/multi_tenant_serving_torch.py --device cpu
"""
import argparse

from repro_torch.serve import (
    ReuseServing,
    ServeClient,
    ServeFrontend,
    TenantPipeline,
    TenantQuota,
)
from repro_torch.workloads import riot_workload, tenant_copy


def frontend_part(device: str) -> None:
    pool = riot_workload()
    frontend = ServeFrontend(
        slots=48,
        strategy="signature",
        backend="torch",
        device=device,
        default_quota=TenantQuota(max_slots=48, max_pending=8),
    )
    host, port = frontend.start()
    print(f"frontend serving on {host}:{port} with {frontend.slots} slots ({device})\n")

    with frontend, ServeClient((host, port)) as alice, ServeClient((host, port)) as bob:
        # The two tenants submit the same first six RIoT dataflows — bob's
        # copies merge into alice's running work and cost (almost) nothing.
        for df in pool[:6]:
            ra = alice.submit("alice", tenant_copy(df, "alice"))
            rb = bob.submit("bob", tenant_copy(df, "bob"))
            print(
                f"{df.name:>10}:  alice {ra['status']} ({ra.get('slots_charged', '-')} slots)"
                f"   bob {rb['status']} ({rb.get('slots_charged', '-')} slots, "
                f"{rb.get('reused', 0)} reused)"
            )

        alice.step(5)  # stream some batches on the device; cost is billed per tenant
        stats = alice.stats()
        print(
            f"\npool: {stats['slots_used']}/{stats['slots']} slots used, "
            f"naive (no-reuse) demand {stats['naive_slots']} slots "
            f"→ effective capacity {stats['effective_capacity']:.2f}×"
        )
        for tenant, ledger in sorted(stats["ledgers"].items()):
            print(
                f"  {tenant}: holds {ledger['slots_held']} slots, "
                f"saved {ledger['slots_saved']} by reuse, "
                f"billed {ledger['cost_total']:.3f} core·steps"
            )

        out = bob.remove("bob", f"bob/{pool[0].name}")
        print(
            f"\nremoved bob/{pool[0].name}: freed {out['slots_freed']} slots; "
            f"alice/{pool[0].name} keeps streaming"
        )
        print(f"final: {alice.status()['dataflows']} dataflows on the pool")


def reuse_serving_part(device: str) -> None:
    rs = ReuseServing(strategy="signature", base_batch=16, device=device)
    for i in range(6):
        rs.add_tenant(TenantPipeline(tenant=f"tenant{i}",
                                     stream=("urban", "meter", "taxi")[i % 3],
                                     shared_stages=3, n_stages=4, d=64, layers_per_stage=4))
    rs.run(3)
    s = rs.stats()
    print(f"\nLM reuse-serving: {s['tenants']} tenants on {s['running_tasks']} running tasks, "
          f"deployed cost {s['deployed_cost']:.1f}")
    before = {t: rs.tenant_output(t)[f"{t}/sink"]["count"] for t in rs.tenants}
    rs.remove_tenant("tenant1")
    rs.run(2)
    for t in sorted(rs.tenants):
        print(f"  {t}: {before[t]} -> {rs.tenant_output(t)[f'{t}/sink']['count']} responses")
    rs.system.close()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    frontend_part(args.device)
    reuse_serving_part(args.device)


if __name__ == "__main__":
    main()
