"""Build and bind the port's CUDA kernels (``kernels/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links them into one shared library with
a plain C interface, which :mod:`ctypes` loads. No source includes
PyTorch's headers, so a cold build takes seconds. The library lands in a
directory keyed by a hash of the sources and flags (default
``build/kernels`` at the repository root, which ``.gitignore`` lists); a
later process with the same sources loads it without compiling.

Nothing here runs at import: the first kernel launch calls
:func:`library`, so the CPU-only tests import the package without a
compiler.

This module also keeps the launch counts: each wrapper calls
:func:`count_launch` right where it launches its kernel, and nowhere else.
A CUDA graph runs its kernels without calling their wrappers, so a capture
records what its wrapper calls count instead of counting it
(:func:`recording_launches`) and each replay adds them
(:func:`add_launches`): the counts stay the launches the card ran.
Concurrent stepping launches from several threads at once, so the counts
change under a lock, and a recording belongs to the thread that opened it:
a capture on one thread never takes in, nor takes back, what another
thread launched meanwhile.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterator, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
DEFAULT_BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "kernels")
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
_I64P = ctypes.POINTER(ctypes.c_int64)  # a host array of strides
# C entry points of csrc/*.cu: name -> argument types (each returns a cudaError_t,
# the *_smem entries a byte count, rt_ssd_blocks_per_sm and
# rt_ssd_bwd_blocks_per_sm a count of blocks,
# rt_slstm_max_clusters a count of clusters or minus a cudaError_t)
_SIGNATURES = {
    "rt_rmsnorm": (_P, _I64, _P, _P, _I64, _I, _F, _I, _I, _I, _I, _I, _P),
    "rt_map_chain": (_P, _I64, _P, _I64, _I, _P, _P, _I, _I, _P),
    "rt_affine_rmsnorm": (_P, _I64, _P, _P, _I64, _I, _F, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rt_kalman_scan": (_P, _I64, _P, _P, _P, _P, _P, _I64, _I, _F, _F, _P),
    "rt_rmsnorm_residual": (_P, _I64, _P, _I64, _P, _P, _P, _I64, _I, _F, _I, _I, _I, _I, _I, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "rt_flash_attention_smem": (_I, _I, _I),
    "rt_flash_attention_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P,
    ),
    "rt_flash_attention_bwd_smem": (_I, _I, _I, _I),
    "rt_rmsnorm_bwd": (
        _P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _I, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_decode_attention": (
        _P, _P, _P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    "rt_ssd_scan": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
    ),
    "rt_flash_attention_pieces": (_P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "rt_attention_pieces_rows": (_I,),
    "rt_decode_attention_pieces": (_P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "rt_ssd_scan_tiles": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _I, _P, _I, _P,
    ),
    "rt_ssd_scan_smem": (_I, _I, _I, _I),
    "rt_ssd_blocks_per_sm": (_I, _I, _I),
    "rt_mlstm_scan": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_mlstm_scan_smem": (_I, _I, _I),
    "rt_mlstm_scan_general": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_slstm_scan": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_slstm_smem": (_I, _I, _I),
    "rt_slstm_max_clusters": (_I, _I, _I, _I, _I, _I),
    "rt_slstm_chain_floor": (_P, _I, _I, _I, _I, _I, _I, _P),
    "rt_ssd_scan_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_ssd_bwd_smem": (_I, _I, _I),
    "rt_ssd_scan_bwd_mma": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64P, _I64P,
        _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_ssd_bwd_mma_smem": (_I, _I, _I, _I),
    "rt_ssd_bwd_blocks_per_sm": (_I, _I, _I),
    "rt_slstm_scan_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_slstm_bwd_smem": (_I, _I, _I),
    "rt_slstm_bwd_max_clusters": (_I, _I, _I, _I, _I),
    "rt_mlstm_scan_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    "rt_mlstm_bwd_smem": (_I, _I),
}

KERNELS = (
    "rmsnorm", "map_chain", "affine_rmsnorm", "kalman_scan",
    "rmsnorm_residual", "flash_attention", "decode_attention", "ssd_scan",
    "mlstm_scan", "slstm_scan", "rmsnorm_bwd", "flash_attention_bwd",
    "ssd_scan_bwd", "mlstm_scan_bwd", "slstm_scan_bwd",
)
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()
# per thread: the stack of open recordings (innermost last)
_recording = threading.local()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: into this thread's innermost open
    recording if there is one, else into the counts."""
    stack = getattr(_recording, "stack", None)
    if stack:
        recorded = stack[-1]
        recorded[name] = recorded.get(name, 0) + 1
        return
    with _count_lock:
        _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Launches this thread counts inside the block, kept out of the counts
    and left in the yielded dict: a CUDA-graph capture records kernel
    launches without running them. Other threads count as before."""
    recorded: Dict[str, int] = {}
    stack = getattr(_recording, "stack", None)
    if stack is None:
        stack = _recording.stack = []
    stack.append(recorded)
    try:
        yield recorded
    finally:
        stack.pop()


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches the card ran without a wrapper call: a replay of the
    launches :func:`recording_launches` recorded."""
    with _count_lock:
        for name, n in counts.items():
            _launches[name] += n


def sources() -> List[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(build_dir: str = DEFAULT_BUILD_DIR) -> str:
    """Compile the kernels unless this source hash is built; returns the path."""
    out_dir = os.path.join(build_dir, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log: List[str] = []
        failed = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write("\n".join(log))
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib, *(obj for _s, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent builder sees all or nothing
    return lib_path


def build_log(build_dir: str = DEFAULT_BUILD_DIR) -> str:
    """nvcc's output of the current build (ptxas register and spill counts)."""
    path = os.path.join(build_dir, _digest(), "build.log")
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def strides_arg(values) -> ctypes.Array:
    """A host array of int64 strides for a ``const int64_t*`` argument."""
    return (ctypes.c_int64 * len(values))(*values)


def check(err: int, name: str) -> None:
    """Raise if a launch was refused (the C entry returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
