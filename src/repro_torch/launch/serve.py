"""Serving driver of the port: the reference's single-process model mode
(``repro/launch/serve.py`` without a subcommand), on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke --device cpu

Any architecture of the dense family (granite, nemotron, qwen1.5, qwen3)
or the hybrid family (zamba2) serves; the others raise.

Random weights from a seeded ``torch.Generator`` on the serving device,
prompts of 4–11 tokens from ``numpy.random.default_rng(0)``. Without
``--device cpu`` it needs a CUDA device and raises when there is none. The
daemon subcommands (start/submit/status/stop) come with the front end.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import configs
from ..models import init_params
from ..serve.engine import Request, ServeEngine


def serving_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on the CPU")
    return dev


def serve_model(args) -> int:
    dev = serving_device(args.device)
    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12)).astype(np.int32)
        eng.submit(Request(rid, prompt, max_new=args.max_new))
    results = eng.run()
    for r in sorted(results, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{r.prompt_len}] → {r.tokens}")
    print(f"served {len(results)} requests")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", help="the reduced config of --arch")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return serve_model(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
