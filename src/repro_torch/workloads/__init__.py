"""Workload generators of the port: the RIoT and OPMW collections and the
submission traces (paper §5.1), the flows that drive the stream path's
kernels, and the tenant variants of a workload that the
multi-tenant front end serves."""
from .kernel_flows import KERNEL_FLOWS, kernel_flows
from .opmw import opmw_workload
from .riot import riot_workload
from .tenants import TenantEvent, tenant_copy, tenant_trace
from .traces import TraceEvent, replay, rw_trace, seq_trace

__all__ = [
    "KERNEL_FLOWS",
    "TenantEvent",
    "TraceEvent",
    "kernel_flows",
    "opmw_workload",
    "replay",
    "riot_workload",
    "rw_trace",
    "seq_trace",
    "tenant_copy",
    "tenant_trace",
]
