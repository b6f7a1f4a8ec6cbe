"""Dataflows that drive the stream path's kernels.

The RIoT collection has no ``rmsnorm`` task and no two consecutive
``senml_parse`` tasks, so it reaches none of the kernels. These four flows
do, with task types the reference already has:

  * ``FA``/``FB`` (the reference's fused-kernel digest test): FB extends
    FA's ``senml_parse → senml_parse`` prefix with ``rmsnorm → kalman``.
    After ``fuse()`` the senml pair becomes one ``map_chain`` launch; FB's
    ``rmsnorm`` stays on the ``rmsnorm`` kernel, because its parent also
    feeds FA's sink.
  * ``KA``/``KB``: KB extends KA's ``senml_parse`` with a private
    ``senml_parse → rmsnorm`` run, which ``fuse()`` turns into one
    ``affine_rmsnorm`` launch.

Both pairs fuse only when the urban source lives in a segment of its own
consumers, as it does when the flows come after the RIoT collection;
otherwise FA's and KA's segments fan out and form no chain.
``KERNEL_FLOWS`` is plain data, so a test can build the same flows with the
reference package's builder.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.api.builder import flow
from repro_torch.core.graph import Dataflow

Steps = List[Tuple[str, Dict[str, float]]]

_FA: Steps = [
    ("senml_parse", {"scale": 2.0, "offset": 0.5}),
    ("senml_parse", {"scale": 0.7, "offset": -0.1}),
]
_KA: Steps = [("senml_parse", {"scale": 1.5, "offset": -0.25})]

# name -> (source type, steps); every flow ends in a "store" sink
KERNEL_FLOWS: Dict[str, Tuple[str, Steps]] = {
    "FA": ("urban", _FA),
    "FB": ("urban", _FA + [("rmsnorm", {"gain": 1.5}), ("kalman", {"q": 0.1})]),
    "KA": ("urban", _KA),
    "KB": ("urban", _KA + [("senml_parse", {"scale": 0.5, "offset": 2.0}), ("rmsnorm", {"gain": 0.8})]),
}


def kernel_flows() -> List[Dataflow]:
    dags = []
    for name, (source, steps) in KERNEL_FLOWS.items():
        b = flow(name).source(source)
        for typ, cfg in steps:
            b.then(typ, **cfg)
        dags.append(b.sink("store").build())
    return dags
