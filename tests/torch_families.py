"""Shared helpers of the CPU parity tests of the port's MLA, vlm, audio and
ssm families (``tests/test_torch_{mla,vlm,audio,xlstm}.py``).

Parameters are the reference's ``init_params(cfg, PRNGKey(seed))`` as
numpy, handed to the port through ``params_from_jax``; a vlm model's
gates, 0 at init (so that every cross-attention output is dropped), are
set to the same nonzero numpy values in both trees first. Tokens and
memories are drawn with numpy. Everything runs the SMOKE configs in
float32, where the packages differ only in the order of their sums:
held at rtol = atol = 1e-5 (``TOL``; the ssm family's recurrent states
and scans at 2e-5 of the largest value, in its own file).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro_torch import configs
from repro_torch.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = (0.7, -0.45, 0.3, 0.9)  # tanh(gate) of each cross block, in both packages


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def mem_len(cfg) -> int:
    return {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(cfg.family, 0)


def both(arch: str, seed: int = 0, cfg_fn=None):
    """(reference config, reference params as numpy, port config, port
    params) at the SMOKE config of ``arch`` (changed by ``cfg_fn`` in both),
    with nonzero gates."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if cfg_fn is not None:
        jcfg, tcfg = cfg_fn(jcfg), cfg_fn(tcfg)
    jp = to_np(j_init_params(jcfg, jax.random.PRNGKey(seed)))
    gated = jp.get("cross_blocks", {}).get("attn", {})
    if "gate" in gated:
        n = gated["gate"].shape[0]
        gated["gate"] = np.asarray(GATES[:n], np.float32).astype(gated["gate"].dtype)
    return jcfg, jp, tcfg, params_from_jax(jp)


def tokens(cfg, shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def memory(cfg, batch: int, seed: int = 2) -> np.ndarray:
    """A standard normal memory (B, Sm, D) of the family's length."""
    return np.random.default_rng(seed).standard_normal(
        (batch, mem_len(cfg), cfg.d_model)).astype(np.float32)


def hidden(cfg, shape, seed: int = 3) -> np.ndarray:
    """A standard normal activation of ``shape`` + (d_model,)."""
    return np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)


def shapes(tree):
    """The tree's array shapes, same nesting."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def layer(tree, i: int = 0):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def assert_cache_close(got, want):
    """Every array of the port's cache against the reference's, same tree."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key == "len":
            assert got["len"] == int(w)
        elif isinstance(w, dict):
            assert_cache_close(got[key], w)
        else:
            g = got[key].numpy()
            assert g.shape == np.shape(w), key
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


def serve(engine_cls, request_cls, cfg, params, prompts, memories, *, slots, max_new=5):
    """Greedy tokens per request id through ``engine_cls``."""
    eng = engine_cls(cfg, params, slots=slots, max_len=64)
    for rid, (p, m) in enumerate(zip(prompts, memories)):
        eng.submit(request_cls(rid, p, max_new=max_new, memory=m))
    return {r.rid: r.tokens for r in eng.run()}


def engine_prompts(cfg, n_requests: int, seed: int = 4):
    """Prompts of 5–37 tokens and a memory each."""
    rng = np.random.default_rng(seed)
    lens = (23, 5, 37, 17, 12)[:n_requests]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    ml = mem_len(cfg)
    mems = [rng.standard_normal((ml, cfg.d_model)).astype(np.float32) if ml else None
            for _ in lens]
    return prompts, mems


def cli_requests(module: str, arch: str, *args: str):
    """The ``req N: prompt[L] → [...]`` lines of ``python -m module --arch
    arch --smoke --requests 4`` as (N, L, number of tokens), and its last
    line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", module, "--arch", arch, "--smoke", "--requests", "4", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    reqs = []
    for line in lines[:-1]:
        m = re.fullmatch(r"req (\d+): prompt\[(\d+)\] → \[([\d, ]*)\]", line)
        assert m, line
        reqs.append((int(m[1]), int(m[2]), len(m[3].split(","))))
    return reqs, lines[-1]
