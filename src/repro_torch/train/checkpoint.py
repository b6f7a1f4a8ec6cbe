"""Checkpoint/restore of a train state (port of ``repro/train/checkpoint.py``),
in the reference's on-disk format, so each package reads the other's.

  * **Atomic**: write to ``step_N.tmp/``, fsync the manifest, rename to
    ``step_N/``; the three latest checkpoints are kept.
  * **Async**: ``AsyncCheckpointer.save_async`` copies the tensors to the
    host, then writes on a worker thread.
  * **The format**: one ``.npy`` a leaf, named by its sorted dict path
    (``params/blocks/attn/wq`` → ``params__blocks__attn__wq.npy``, as the
    reference's ``tree_flatten_with_path``), and ``manifest.json`` with the
    step, each leaf's file, shape and dtype; bfloat16 leaves are stored as
    ``uint16`` bits under ``stored_as``; a sharding spec, where one is
    given, as JSON.
  * **No mesh yet**: ``restore(..., mesh=...)`` raises until the port has
    ``models/sharding.py`` (ROADMAP queue 1, item 18). Without a mesh the
    spec is carried but not applied, as the reference does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

_MANIFEST = "manifest.json"
MESH_ITEM = "ROADMAP queue 1, item 18 (models/sharding.py)"


def _flatten_with_names(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) in the reference's order: dict keys sorted, list and
    tuple items by index, names joined with ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(_flatten_with_names(v, f"{prefix}/{k}" if prefix else k))
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as the array ``np.save`` writes, and the dtype name the
    manifest records when the bits are stored as another type."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":  # ml_dtypes (bfloat16, …) from the reference
        return arr.view(f"uint{arr.dtype.itemsize * 8}"), str(arr.dtype)
    return arr, None


def save(ckpt_dir: str, step: int, state: PyTree, *, specs: Optional[PyTree] = None) -> str:
    """Synchronous atomic checkpoint, a leaf at a time; returns the final
    directory."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    spec_leaves = dict(_flatten_with_names(specs)) if specs is not None else {}
    manifest: Dict[str, Any] = {"step": step, "arrays": {}}
    for name, leaf in _flatten_with_names(state):
        arr, stored = _to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        entry = {"file": fname, "shape": list(arr.shape), "dtype": stored or str(arr.dtype)}
        if stored:
            entry["stored_as"] = str(arr.dtype)
        np.save(os.path.join(tmp, fname), arr)
        if spec_leaves.get(name) is not None:
            entry["spec"] = _spec_to_json(spec_leaves[name])
        manifest["arrays"][name] = entry
        del arr
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep=3)
    return final


def _spec_to_json(spec) -> List[Any]:
    out = []
    for p in tuple(spec):
        if p is None:
            out.append(None)
        elif isinstance(p, (tuple, list)):
            out.append(list(p))
        else:
            out.append(p)
    return out


class AsyncCheckpointer:
    """Snapshot to host, then write on a daemon thread; one in flight."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save_async(self, step: int, state: PyTree, specs: Optional[PyTree] = None) -> None:
        self.wait()
        host_state = _host_copy(state)

        def work():
            self.last_path = save(self.ckpt_dir, step, host_state, specs=specs)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _host_copy(tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _load(path: str, entry: Dict[str, Any], device) -> torch.Tensor:
    arr = np.load(path)
    if entry["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def restore(
    ckpt_dir: str,
    step: Optional[int] = None,
    *,
    mesh=None,
    target: Optional[PyTree] = None,
    device: torch.device | str = "cpu",
) -> PyTree:
    """Restore a checkpoint of either package as tensors on ``device``, a
    leaf at a time.

    With ``target`` (a tree of like-structured tensors, on any device,
    ``meta`` included) the result has that structure; otherwise a flat
    {name: tensor} dict is returned. ``mesh`` raises: resharding waits for
    :data:`MESH_ITEM`.
    """
    if mesh is not None:
        raise NotImplementedError(f"restore onto a mesh: {MESH_ITEM}")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    entries = manifest["arrays"]
    if target is None:
        return {name: _load(os.path.join(d, e["file"]), e, device) for name, e in entries.items()}
    names = iter([n for n, _ in _flatten_with_names(target)])

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v) for v in tree)
        name = next(names)
        return _load(os.path.join(d, entries[name]["file"]), entries[name], device)

    return rebuild(target)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        int(d.split("_", 1)[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
