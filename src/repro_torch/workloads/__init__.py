"""Workload generators of the port: the RIoT and OPMW collections and the
submission traces (paper §5.1), and the flows that drive the stream
path's kernels."""
from .kernel_flows import KERNEL_FLOWS, kernel_flows
from .opmw import opmw_workload
from .riot import riot_workload
from .traces import TraceEvent, replay, rw_trace, seq_trace

__all__ = [
    "KERNEL_FLOWS",
    "TraceEvent",
    "kernel_flows",
    "opmw_workload",
    "replay",
    "riot_workload",
    "rw_trace",
    "seq_trace",
]
