#!/usr/bin/env python3
"""Check and time K5's wide builds (head dim 192) on the card, one checkout or several in turns.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/torch_wide_attention_probe.py [SRC ...]``, each SRC the
``src/`` directory of a checkout (default this one's). Each SRC's kernels are
built first, and ptxas's lines for the wide sources printed (registers,
spills, and the C75xx notes that say a wgmma was serialized). Then, each case
in a process of its own (a hang or a fault ends one case, after 120 s):

  * the forward ``flash_attention`` in bf16 at (192, 128) and (192, 192)
    against ``ref.flash_attention_ref`` within the smoke's ATTN_BF16_TOL, its
    lse against a float32 log-sum-exp of the scaled scores (1e-3; +inf
    where a row sees no key), at small ragged shapes (causal, a window, no
    mask, Sq != Sk) with the first SRC only;
  * ``flash_attention_bwd`` likewise, each gradient within the smoke's
    BWD_REL of the plain version's largest value, and bitwise on a repeat;
  * at deepseek-v2's MLA layer q/k (1, 2048, 128, 192), v of 128, and at
    nemotron-4-340b's q (1, 2048, 96, 192) over 8 KV heads, causal, the same
    checks and the device µs (``chip_smoke.device_ms``): the forward beside
    ``F.scaled_dot_product_attention``, the backward with each launch's µs
    from ``torch.profiler``. These run once per SRC in the order given, then
    again in the reverse order (parent, change, change, parent for two), so
    that two checkouts compare within one call. ``--qwen`` adds qwen3-4b's
    hd-128 forward and backward (q (1, 2048, 32, 128) over 8).

The card's name and power limit head the output.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# kind, Sq, Sk, q heads, KV heads, q/k head dim, v head dim, causal, window
SMALL = [
    ("fwd", 300, 300, 4, 2, 192, 128, True, 0), ("fwd", 300, 300, 4, 2, 192, 192, True, 0),
    ("fwd", 77, 203, 4, 1, 192, 128, False, 0), ("fwd", 333, 333, 6, 2, 192, 192, True, 100),
    ("fwd", 130, 70, 2, 2, 192, 128, True, 0), ("fwd", 700, 700, 24, 2, 192, 192, True, 0),
    ("fwd", 1000, 1000, 3, 3, 192, 128, True, 300), ("bwd", 700, 700, 24, 2, 192, 192, True, 0),
    ("bwd", 257, 257, 2, 2, 192, 128, True, 0), ("bwd", 200, 300, 4, 2, 192, 192, False, 0),
    ("bwd", 300, 300, 4, 2, 192, 128, True, 0), ("bwd", 300, 300, 4, 2, 192, 192, True, 0),
    ("bwd", 97, 161, 3, 3, 192, 128, False, 0), ("bwd", 333, 333, 6, 2, 192, 192, True, 100),
]
FULL = [
    ("fwd", 2048, 2048, 128, 128, 192, 128, True, 0), ("fwd", 2048, 2048, 96, 8, 192, 192, True, 0),
    ("bwd", 2048, 2048, 128, 128, 192, 128, True, 0), ("bwd", 2048, 2048, 96, 8, 192, 192, True, 0),
]
QWEN = [("fwd", 2048, 2048, 32, 8, 128, 128, True, 0), ("bwd", 2048, 2048, 32, 8, 128, 128, True, 0)]


def launches_us(fn, calls=5) -> dict:
    """Device µs per call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        key = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
        if us and "CUDA" in str(e.device_type):
            out[key.split("(")[0].split("<")[0]] = round(us / calls, 1)
    return out


def run_case(case) -> bool:
    """One case in this process, on the port that ``sys.path`` finds first."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import ATTN_BF16_TOL, BWD_REL, device_ms, max_err
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    kind, sq, sk, h, kv, hd, hd_v, causal, window = case
    bf = torch.bfloat16
    q = torch.randn((1, sq, h, hd), generator=gen).to(dev, bf)
    k = torch.randn((1, sk, kv, hd), generator=gen).to(dev, bf)
    v = torch.randn((1, sk, kv, hd_v), generator=gen).to(dev, bf)
    scale = hd ** -0.5
    timed = sq >= 2048
    if kind == "fwd":
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale, with_lse=True)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
        err = max_err(o, want)
        limit = ATTN_BF16_TOL["atol"] + ATTN_BF16_TOL["rtol"] * float(want.float().abs().max())
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(h // kv, dim=2)) * scale
        i, j = torch.arange(sq, device=dev)[:, None], torch.arange(sk, device=dev)[None, :]
        seen = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            seen &= j <= i
        if window:
            seen &= j > i - window
        lse_want = torch.logsumexp(s.masked_fill(~seen, float("-inf")), -1)
        fin = torch.isfinite(lse_want)
        lse_err = float((lse[fin] - lse_want[fin]).abs().max()) if fin.any() else 0.0
        ok = err <= limit and lse_err < 1e-3 and bool(torch.isinf(lse[~fin]).all())
        line = f"{list(case)}: max|err| {err:.4g} (limit {limit:.4g}), lse {lse_err:.3g}"
        if timed:
            ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal, scale=scale), per_graph=3, reps=7)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale,
                                                                   enable_gqa=kv < h), per_graph=3, reps=7)
            line += f"; {ms * 1e3:.2f} us, SDPA {lib * 1e3:.2f} us"
    else:
        do = torch.randn((1, sq, h, hd_v), generator=gen).to(dev, bf)
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, with_lse=True)

        def bwd():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)

        got = bwd()
        want = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window)
        rel = [max_err(a, w) / float(w.float().abs().max()) for a, w in zip(got, want)]
        bitwise = all(torch.equal(a, c) for a, c in zip(got, bwd()))
        ok = max(rel) <= BWD_REL["bfloat16"] and bitwise
        line = f"{list(case)}: dq, dk, dv within {[round(r, 5) for r in rel]} of their largest |value|, " \
               f"a repeat {'bitwise' if bitwise else 'DIFFERS'}"
        if timed:
            line += f"; {device_ms(bwd, per_graph=3, reps=5) * 1e3:.1f} us, by launch {launches_us(bwd)}"
    print(line + ("" if ok else " FAIL"), flush=True)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("srcs", nargs="*", help="src/ directories of checkouts (default: this one's)")
    parser.add_argument("--qwen", action="store_true", help="add qwen3-4b's hd-128 forward and backward")
    parser.add_argument("--case", help=argparse.SUPPRESS)  # one case, in a child process
    args = parser.parse_args()
    if args.case:
        sys.path.insert(0, ROOT)
        return 0 if run_case(tuple(json.loads(args.case))) else 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    srcs = [os.path.abspath(s) for s in args.srcs] or [os.path.join(os.path.abspath(ROOT), "src")]
    for src in srcs:
        t0 = time.perf_counter()
        build = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "from repro_torch.kernels import build; build.library(); print(build.build_log())", src],
            capture_output=True, text=True)
        print(f"{src}: built in {time.perf_counter() - t0:.1f} s, rc {build.returncode}", flush=True)
        source = None
        for line in (build.stdout + build.stderr).splitlines():
            source = line if line.startswith("==") else source
            if source and "wide" in source and any(w in line for w in ("registers", "spill", "C75", "rror")):
                print("  " + line.strip(), flush=True)

    def run(case, src):
        env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
        tag = os.path.relpath(src, ROOT)
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--case", json.dumps(case)],
                               timeout=120, capture_output=True, text=True, env=env, cwd=ROOT)
            print(f"[{tag}] " + (r.stdout.strip() or f"{list(case)}: rc {r.returncode}"), flush=True)
            if r.returncode:
                print(r.stderr[-1500:], flush=True)
        except subprocess.TimeoutExpired:
            print(f"[{tag}] {list(case)}: TIMEOUT", flush=True)

    for case in SMALL:
        run(case, srcs[0])
    for case in FULL + (QWEN if args.qwen else []):
        for src in srcs + srcs[::-1]:
            run(case, src)
    return 0


if __name__ == "__main__":
    sys.exit(main())
