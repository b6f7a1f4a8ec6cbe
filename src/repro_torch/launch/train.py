"""End-to-end training driver (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --device cpu

On the card (the default ``--device cuda``) the forward and backward run
through the port's kernels and their backward kernels: the dense family
(K1, K4, K5), the hybrid (``--arch zamba2-2.7b``: also K7) and the ssm
family (``--arch xlstm-1.3b``: the mLSTM and sLSTM scans), and every other
family: MLA's q/k head dim 192 against v's 128 and nemotron's 192 on their
own builds of ``flash_attention_bwd``; the vlm and audio families with a
drawn stub memory. A kernel call without a backward kernel at its shape
raises (K5 above head dim 192; the scans' limits, ROADMAP queue 1). Fault tolerance is
the reference's: an async checkpoint every ``--ckpt-every`` steps; on
restart the driver restores the latest checkpoint and resumes the data
stream at the exact batch index, so the loop is crash-idempotent. It
imports no mesh: restoring onto one waits for ``models/sharding.py``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import TokenStream
from repro_torch.train import AdamWConfig, abstract_train_state, make_train_step, train_state_init
from repro_torch.train import checkpoint as ckpt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    # family chunk constraints (ssd/mlstm need seq % chunk == 0)
    if cfg.ssm:
        assert args.seq % cfg.ssm.chunk == 0
    if cfg.xlstm:
        assert args.seq % cfg.xlstm.chunk == 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")

    opt = AdamWConfig(
        peak_lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
        mu_dtype="float32", nu_dtype="float32",
    )
    step_fn = make_train_step(cfg, opt, accum=args.accum)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=args.seed)

    start_step = 0
    state = None
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state = ckpt.restore(args.ckpt_dir, target=abstract_train_state(cfg, opt), device=device)
        start_step = int(state["step"])
        print(f"restored checkpoint at step {start_step}")
    if state is None:
        state = train_state_init(cfg, opt, torch.Generator(device=device).manual_seed(args.seed))

    total, active = cfg.param_count()
    print(f"{cfg.name}: {total/1e6:.1f}M params ({active/1e6:.1f}M active)")
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None

    def make_batch(i):
        b = stream.batch(i)
        out = {k: torch.from_numpy(b[k]).to(device) for k in ("tokens", "labels")}
        if cfg.family in ("vlm", "audio"):
            out["memory"] = stub_memory(cfg, args.batch, i, device)
        return out

    t0 = time.time()
    first_loss = last_loss = None
    for i in range(start_step, args.steps):
        state, metrics = step_fn(state, make_batch(i))
        if i == start_step:
            first_loss = float(metrics["loss"])
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            last_loss = float(metrics["loss"])
            dt = time.time() - t0
            print(
                f"step {i+1:5d}  loss {last_loss:.4f}  gnorm "
                f"{float(metrics['grad_norm']):.3f}  lr {float(metrics['lr']):.2e}  "
                f"({dt:.1f}s)"
            )
        if saver and (i + 1) % args.ckpt_every == 0:
            saver.save_async(i + 1, state)
    if saver:
        saver.wait()
    print(f"done: loss {first_loss:.4f} → {last_loss:.4f}")
    return 0


def stub_memory(cfg, batch, seed, device):
    """Stub memory (B, length, D) in the activation type for a vlm (its
    image tokens) or audio (its encoder frames) configuration: standard
    normals from ``seed`` (numpy's; the reference draws with ``jax.random``)."""
    length = cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
    x = np.random.default_rng(seed).standard_normal((batch, length, cfg.d_model), dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, cfg.dtype))


if __name__ == "__main__":
    raise SystemExit(main())
