"""End-to-end driver of the PyTorch port: train a ~100M-param qwen3-family
model for a few hundred steps on the deterministic token pipeline, with
async checkpointing and crash-resume (the port's ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]

On the card (the default) the forward and backward run through the port's
kernels and their backward kernels; the loop is ``repro_torch.launch.train``.
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="train_lm_torch_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # ~100M params: qwen3 family at width 512 / 8 layers, full vocab
    import repro_torch.configs.qwen3_4b as q3

    cfg = q3.CONFIG.replace(
        name="qwen3-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        dtype="float32",
        param_dtype="float32",
    )
    total, _ = cfg.param_count()
    print(f"training {cfg.name}: {total/1e6:.0f}M params")

    # reuse the production train loop with an inline config
    import repro_torch.launch.train as T

    class _Cfgs:
        @staticmethod
        def get_smoke_config(_):
            return cfg

        @staticmethod
        def get_config(_):
            return cfg

    T.configs = _Cfgs  # inject
    T.main([
        "--arch", "inline", "--smoke",
        "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--lr", "1e-3", "--warmup", "30",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
