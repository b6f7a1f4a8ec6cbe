#!/usr/bin/env python3
"""How far ``mlstm_scan_bwd``'s float32 gradients sit from float64, beside its plain version's.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/torch_mlstm_f64_probe.py [--seeds 0 1 2 3 4]``. At
xlstm-1.3b's training shape (q/k/v (1, 2048, 4, 1024), chunk 64, float32
inputs drawn as ``chip_smoke.py`` draws them: the forget gates biased open by
3) it computes, per seed, the kernel's gradients, ``ref.mlstm_scan_bwd_ref``'s
(autograd of the chunked plain version) and
``ref.mlstm_recurrence_bwd_f64``'s (float64 autograd of the cell's
recurrence step by step), and prints the forward's y against the
recurrence's (the kernel's y, which the backward reads, and the plain
version's), then for dq, dk, dv, dĩ and df̃ each one's
largest error against float64 as a share of float64's largest |value|, the
kernel's over the plain version's, and the kernel against the plain version
in units of the smoke's limit (1e-4 of the plain version's largest |value|).
``--exact-y`` feeds the backward the recurrence's y in place of the forward
kernel's, which parts the backward's own error from what it inherits. Writes
the table as JSON to ``--out``; the card's name and power limit head the
output.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

NAMES = ("dq", "dk", "dv", "di", "df")
SHAPE = (1, 2048, 4, 1024)  # b, S, heads, P
CHUNK = 64
LIMIT = 1e-4  # the smoke's BWD_REL in float32


def draw(seed: int, dev, shape=SHAPE):
    """q, k, v, ĩ, f̃ (biased open by 3) and dy in float32 from ``seed``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    b, s, nh, p = shape
    q, k, v = (torch.randn((b, s, nh, p), generator=g).to(dev) for _ in range(3))
    ig = torch.randn((b, s, nh), generator=g).to(dev)
    fg = torch.randn((b, s, nh), generator=g).to(dev) + 3.0
    dy = torch.randn((b, s, nh, p), generator=g).to(dev)
    return (q, k, v, ig, fg), dy


def errors(seed: int, dev, shape=SHAPE, chunk: int = CHUNK, exact_y: bool = False) -> dict:
    """Per gradient: the kernel's and the plain version's largest error
    against float64 (a share of float64's largest |value|), and the kernel
    against the plain version (a share of the plain version's); and the
    forward's y against the recurrence's. ``exact_y``: the backward kernel
    reads the recurrence's y (rounded to f32) in place of the forward
    kernel's."""
    import torch

    from repro_torch.kernels import mlstm, ref

    inputs, dy = draw(seed, dev, shape)
    y, _ = mlstm.mlstm_scan(*inputs, chunk=chunk)
    b, s, nh, p = shape
    with torch.no_grad():
        state = (torch.zeros((b, nh, p, p), dtype=torch.float64, device=dev),
                 torch.zeros((b, nh, p), dtype=torch.float64, device=dev),
                 torch.full((b, nh), ref.NEG_INF, dtype=torch.float64, device=dev))
        ys = []
        for t0 in range(0, s, chunk):
            y64, *state = ref.mlstm_steps_ref(*(x[:, t0:t0 + chunk].double() for x in inputs), *state)
            ys.append(y64)
        y64 = torch.cat(ys, dim=1)
        del state
    got = mlstm.mlstm_scan_bwd(*inputs, y64.float() if exact_y else y, dy, chunk=chunk)[:5]
    plain = ref.mlstm_scan_bwd_ref(*inputs, dy, None, chunk)[:5]
    exact = ref.mlstm_recurrence_bwd_f64(*inputs, dy)
    top = float(y64.abs().max())
    out = {"y": {"kernel": float((y.double() - y64).abs().max()) / top,
                 "plain": float((ref.mlstm_scan_ref(*inputs, chunk=chunk)[0].double() - y64).abs().max()) / top}}
    for name, k_, p_, e_ in zip(NAMES, got, plain, exact):
        top = float(e_.abs().max())
        out[name] = {
            "kernel": float((k_.double() - e_).abs().max()) / top,
            "plain": float((p_.double() - e_).abs().max()) / top,
            "kernel_vs_plain": float((k_ - p_).abs().max()) / float(p_.abs().max()),
        }
    del inputs, dy, y, got, plain, exact
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--out", default="chiprun_out/torch_mlstm_f64_probe.json")
    parser.add_argument("--exact-y", action="store_true",
                        help="feed the backward the recurrence's y in place of the forward kernel's")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_mlstm_f64_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    print(f"mlstm_scan_bwd f32 at q/k/v {SHAPE} chunk {CHUNK}: each gradient's largest error against "
          f"float64 autograd of the recurrence, over float64's largest |value|")
    dev = torch.device("cuda", 0)
    report = {"card": card, "shape": SHAPE, "chunk": CHUNK, "exact_y": args.exact_y, "seeds": {}}
    for seed in args.seeds:
        row = errors(seed, dev, exact_y=args.exact_y)
        report["seeds"][seed] = row
        print(f"seed {seed} y (the forward's): kernel {row['y']['kernel']:.3e}, plain {row['y']['plain']:.3e}")
        for name in NAMES:
            r = row[name]
            print(f"seed {seed} {name}: kernel {r['kernel']:.3e}, plain {r['plain']:.3e}, kernel / plain "
                  f"{r['kernel'] / r['plain']:.3f}; kernel vs plain {r['kernel_vs_plain'] / LIMIT:.3f} x "
                  f"the smoke's limit")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
