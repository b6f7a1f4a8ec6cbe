#!/usr/bin/env python3
"""The loss over a few training steps of qwen3-4b at its published widths,
cut in depth, with bf16 parameters (as ``chip_smoke.py`` phase 6b trains)
and with f32 ones, on one repeated ``TokenStream`` batch.

AdamW's first updates move every weight by about the learning rate. A bf16
weight near 0.02 has an ulp of about 1.5e-4, and a unit norm gain one of
7.8e-3, so with bf16 parameters an update of 1e-4 becomes one ulp or
nothing. Printing the two runs' losses beside each other shows whether a
rise of the loss in the first steps comes from that rounding or from the
updates themselves.

Usage (on a machine with a CUDA device, from the repository root):
    python3 scripts/torch_train_probe.py [--layers 12] [--steps 6] [--lr 1e-4 3e-4]
"""
from __future__ import annotations

import argparse
import gc
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-4, 3e-4])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.train import AdamWConfig, make_train_step, train_state_init

    dev = torch.device("cuda", 0)
    base = configs.get_config("qwen3-4b").replace(n_layers=args.layers)
    raw = TokenStream(base.vocab_size, args.seq, 1, seed=0).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    print(f"{torch.cuda.get_device_name(0)}; qwen3-4b cut to {args.layers} layers, batch 1 x "
          f"{args.seq}, AdamW f32 moments, no warmup", flush=True)
    for lr in args.lr:
        for dtype in ("bfloat16", "float32"):
            cfg = base.replace(dtype=dtype, param_dtype=dtype)
            opt = AdamWConfig(peak_lr=lr, warmup_steps=0, total_steps=100,
                              mu_dtype="float32", nu_dtype="float32")
            state = train_state_init(cfg, opt, torch.Generator(device=dev).manual_seed(0))
            step = make_train_step(cfg, opt)
            losses = []
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            print(f"lr {lr:g}, {dtype} parameters: losses "
                  + ", ".join(f"{x:.4f}" for x in losses)
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
