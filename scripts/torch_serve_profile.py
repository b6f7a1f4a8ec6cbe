#!/usr/bin/env python3
"""Where the PyTorch port's serving path spends its time, on the card.

For each architecture of ``ARCHS`` (``chip_smoke.py``'s dense and hybrid
serving architectures, qwen3-4b and zamba2-2.7b) in turn: builds it at
full width and depth (bf16, random weights from a seeded generator on the
card, with ``chip_smoke.py``'s longest prompt and cache length), warms up,
then profiles with ``torch.profiler`` (CPU and CUDA activities):
  * one prefill of a 2048-token prompt into a batch-1 cache of 4096;
  * ``DECODE`` decode steps at batch 1 after it.

Prints, and writes as JSON to ``--out`` (one entry per architecture):
  * wall ms (host clock around the call, which ends in a synchronize),
    without and with the profiler;
  * device busy ms (sum of kernel times; one stream, so kernels do not
    overlap) and the idle share ``1 - busy / wall``, per prefill and per
    decoded token;
  * kernel launches per prefill and per token, the port's kernel launch
    counts, the device ms of each of the port's kernels (by the name of
    its CUDA function) and the top kernels by device time in each phase.

Usage (on a machine with a CUDA device, from the repository root):
    python3 scripts/torch_serve_profile.py [--out chiprun_out/torch_serve_profile.json]
        [--arch qwen3-4b] [--src DIR]
``--arch`` profiles one architecture only; ``--src`` takes the port from
another checkout's ``src`` directory (to read two checkouts' kernels in
one call; the model, shapes and profiling stay this script's).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from chip_smoke import HYBRID_ARCH, SERVE_ARCH, SERVE_MAX_LEN, SERVE_PROMPT  # noqa: E402

ARCHS = (SERVE_ARCH, HYBRID_ARCH)
DECODE = 8  # decode steps profiled after the prefill
# the port's kernels by the name of their CUDA function(s) in the trace
PORT_KERNELS = {
    "flash_attention": "flash_fwd",
    "decode_attention": "decode_",
    "ssd_scan": "ssd_",
}
# the row template's kernels (common.cuh: rms_rows_*<T, kAffine, kResidual, ...>):
# K4 rmsnorm_residual where kResidual is true, else K1 rmsnorm (or K3)
ROW_KERNEL = re.compile(r"rms_rows_\w+<[^,<>]+, (?:true|false), (true|false)")


def port_kernel(key: str):
    """The port kernel a CUDA function of the trace belongs to, or None."""
    row = ROW_KERNEL.search(key)
    if row:
        return "rmsnorm_residual" if row.group(1) == "true" else "rmsnorm"
    return next((name for name, fn in PORT_KERNELS.items() if fn in key), None)


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _phase(prof, calls: int, wall_ms: float, top_n: int = 12) -> dict:
    kernels = [
        e for e in prof.key_averages()
        if e.device_type is not None and "CUDA" in str(e.device_type)
    ]
    busy = sum(_dev_us(e) for e in kernels) / 1e3 / calls
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "kernel_launches": sum(e.count for e in kernels) / calls,
        "port_kernel_device_ms": {
            name: sum(_dev_us(e) for e in kernels if port_kernel(e.key) == name) / 1e3 / calls
            for name in ("rmsnorm", "rmsnorm_residual", *PORT_KERNELS)
        },
        "top_kernels": [
            {"name": e.key[:120], "device_ms": _dev_us(e) / 1e3 / calls,
             "launches": e.count / calls}
            for e in sorted(kernels, key=_dev_us, reverse=True)[:top_n]
        ],
    }


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/torch_serve_profile.json")
    parser.add_argument("--arch", choices=ARCHS, action="append",
                        help="profile this architecture (repeatable; default: all)")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    print(f"card: {card}; port from {os.path.abspath(args.src)}")
    report = {}
    for arch in args.arch or ARCHS:
        rep = report[arch] = profile_arch(arch, dev, card)
        torch.cuda.empty_cache()
        print(f"{rep['arch']} ({rep['layers']} layers, {rep['dtype']}), prompt {SERVE_PROMPT}, "
              f"{DECODE} decode steps")
        print(f"prefill wall ms without the profiler {rep['prefill_wall_ms_unprofiled']} "
              f"(median {statistics.median(rep['prefill_wall_ms_unprofiled']):.3f})")
        print(f"decode wall ms/token without the profiler "
              f"{rep['decode_wall_ms_per_token_unprofiled']} "
              f"(median {statistics.median(rep['decode_wall_ms_per_token_unprofiled']):.3f})")
        for name in ("prefill", "decode_per_token"):
            ph = rep[name]
            print(f"{name}: wall {ph['wall_ms']:.3f} ms, device busy {ph['device_busy_ms']:.3f} ms, "
                  f"idle share {ph['device_idle_share']:.3f}, {ph['kernel_launches']:.0f} launches; "
                  f"port kernels {ph['repro_torch_kernel_launches']}; port kernel device ms "
                  f"{ {k: round(v, 3) for k, v in ph['port_kernel_device_ms'].items()} }")
            for k in ph["top_kernels"]:
                print(f"  {k['device_ms']:9.3f} ms  x{k['launches']:6.1f}  {k['name']}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


def profile_arch(arch: str, dev, card: str) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    cfg = configs.get_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=SERVE_PROMPT)).long()[None].to(dev)
    cache = init_cache(cfg, 1, SERVE_MAX_LEN, device=dev)
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)

    def run_prefill():
        cache["len"] = 0
        prefill(params, cfg, prompt, cache)

    def run_decode():
        for _ in range(DECODE):
            decode_step(params, cfg, tok, cache)

    for _ in range(2):  # warm: cuBLAS handles, allocator, kernel build
        run_prefill()
        run_decode()
    plain_prefill = [_timed(run_prefill) for _ in range(3)]
    plain_decode = [_timed(run_decode) / DECODE for _ in range(3)]

    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_p:
        wall_p = _timed(run_prefill)
    prefill_launches = launch_counts()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_d:
        wall_d = _timed(run_decode) / DECODE
    decode_launches = {k: v / DECODE for k, v in launch_counts().items()}

    return {
        "card": card,
        "arch": cfg.name,
        "layers": cfg.n_layers,
        "dtype": cfg.dtype,
        "prompt_tokens": SERVE_PROMPT,
        "decode_steps": DECODE,
        "prefill_wall_ms_unprofiled": plain_prefill,
        "decode_wall_ms_per_token_unprofiled": plain_decode,
        "prefill": {**_phase(prof_p, 1, wall_p), "repro_torch_kernel_launches": prefill_launches},
        "decode_per_token": {**_phase(prof_d, DECODE, wall_d),
                             "repro_torch_kernel_launches": decode_launches},
    }


if __name__ == "__main__":
    sys.exit(main())
