#!/usr/bin/env python3
"""Readings of ``chip_smoke.py``'s bf16 card-vs-CPU check over several seeds.

For each serving architecture of ``chip_smoke.SERVE_PHASES`` (or those
named by ``--arch``), cut as the smoke cuts it for this check (qwen3-4b to
2 layers, zamba2-2.7b to 6, mixtral-8x22b to 1, deepseek-v2-236b to its
dense first layer, llama-3.2-vision-90b to one self and one cross block,
seamless-m4t-medium to 2 + 2, xlstm-1.3b to one mLSTM and one sLSTM
block), at full width in bf16 with random weights
drawn on the card from seeds 0..SEEDS-1 (vlm gates opened and memories
drawn as the smoke draws them): ``chip_smoke.bf16_witness`` (the logits of
``forward`` at every position of a 160-token prompt, then prefill and 3
decode steps, the card's kernels against their plain versions on the
CPU). Prints max|diff| over the largest logit, the least cosine and whether
the greedy tokens agreed, beside the limits ``chip_smoke.py`` holds them
to. Run on a copy of the tree with a fault planted in a kernel, it gives
the reading that the limits must reject.

Usage (on a machine with a CUDA device, from the repository root):
    python3 scripts/torch_bf16_witness.py [--seeds 4] [--arch seamless-m4t-medium ...]
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--arch", nargs="*", default=None, help="default: every serving phase")
    args = parser.parse_args()

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import init_params

    if not torch.cuda.is_available():
        print("torch_bf16_witness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.card_line()}", flush=True)
    for arch, cut_layers, _, _, _, cut_limits, extra in chip_smoke.SERVE_PHASES:
        if args.arch and arch not in args.arch:
            continue
        cfg = chip_smoke.with_cut(configs.get_config(arch).replace(
            n_layers=extra.get("witness_layers") or cut_layers), extra.get("cut", {}))
        rng = np.random.default_rng(0)  # chip_smoke.py's first prompt
        top = extra.get("max_prompt", chip_smoke.SERVE_PROMPT)
        n = rng.integers(128, top + 1, size=chip_smoke.SERVE_REQUESTS)[0]
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        memory = chip_smoke.draw_memory(cfg, np.random.default_rng(chip_smoke.MEMORY_SEED))
        for seed in range(args.seeds):
            params = chip_smoke.open_gates(
                init_params(cfg, torch.Generator(device=dev).manual_seed(seed)), cfg)
            rel, cos, same = chip_smoke.bf16_witness(dev, cfg, params,
                                                     prompt[: chip_smoke.WITNESS_PROMPT], memory)
            del params
            print(f"{arch} ({cfg.n_layers} layers, bf16, seed {seed}): max|diff|/max|logit| "
                  f"{rel:.4g}, cosine {cos:.6f}, greedy tokens {'equal' if same else 'differ'} "
                  f"{chip_smoke.limits_text(cut_limits)}: "
                  f"{'within' if chip_smoke.check_limits((rel, cos, same), cut_limits) else 'OUTSIDE'}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
