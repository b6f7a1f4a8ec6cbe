"""Workload generators of the port: the RIoT collection (paper §5.1) and
the flows that drive the stream path's kernels."""
from .kernel_flows import KERNEL_FLOWS, kernel_flows
from .riot import riot_workload

__all__ = ["KERNEL_FLOWS", "kernel_flows", "riot_workload"]
