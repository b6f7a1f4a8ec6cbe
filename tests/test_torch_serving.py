"""The port's ServeEngine and serving driver against the reference on the CPU.

With the reference's parameters (through ``params_from_jax``) the port's
engine must return the same greedy tokens per request; temperature draws
must equal ``jax.random.categorical``'s for the same logits and keys.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch import random as trandom
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import serving_device
from repro_torch.serve.engine import Request, ServeEngine, sample_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(arch, seed):
    jcfg = jconfigs.get_smoke_config(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, configs.get_smoke_config(arch), params_from_jax(jax.tree.map(np.asarray, jp))


def _serve(engine_cls, request_cls, cfg, params, prompts, *, slots, max_new=4, temperature=0.0):
    eng = engine_cls(cfg, params, slots=slots, max_len=64)
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid, p, max_new=max_new, temperature=temperature))
    return {r.rid: r.tokens for r in eng.run()}


def test_engine_greedy_matches_reference():
    jcfg, jp, tcfg, tp = _both("qwen3-4b", 0)
    prompts = [np.arange(5, dtype=np.int32) + i for i in range(5)]
    want = _serve(JServeEngine, JRequest, jcfg, jp, prompts, slots=2)
    got = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=2)
    assert got == want
    assert len(got) == 5 and all(len(t) == 4 for t in got.values())
    assert all(0 <= t < tcfg.padded_vocab for toks in got.values() for t in toks)


def test_hybrid_engine_greedy_matches_reference_over_refilled_slots():
    # zamba2: 5 requests through 2 slots, so slots are refilled in place and
    # prefill must overwrite the Mamba conv tails and states of the last
    # request (prompts of 3+ tokens: the reference cannot decode after fewer)
    jcfg, jp, tcfg, tp = _both("zamba2-2.7b", 0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in (9, 3, 17, 5, 12)]
    want = _serve(JServeEngine, JRequest, jcfg, jp, prompts, slots=2)
    got = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=2)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3, 4] and all(len(t) == 4 for t in got.values())


def test_engine_greedy_deterministic_with_ragged_prompts():
    _, _, tcfg, tp = _both("qwen3-4b", 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in (3, 17, 9, 30)]
    a = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=3, max_new=6)
    b = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=3, max_new=6)
    assert a == b and sorted(a) == [0, 1, 2, 3]


def test_engine_batching_independence():
    """Slot packing must not change a request's output (cache isolation)."""
    jcfg, jp, tcfg, tp = _both("granite_20b", 1)
    prompt = np.array([3, 1, 4, 1, 5], np.int32)

    def gen(slots, extra):
        prompts = [prompt] + [prompt[::-1].copy() for _ in range(extra)]
        return _serve(ServeEngine, Request, tcfg, tp, prompts, slots=slots)[0]

    assert gen(1, 0) == gen(4, 3)
    assert gen(1, 0) == _serve(JServeEngine, JRequest, jcfg, jp, [prompt], slots=1)[0]


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_temperature_draws_equal_reference(seed):
    logits = np.random.default_rng(seed).standard_normal(512).astype(np.float32) * 3.0
    g_t = trandom.gumbel(trandom.prng_key(seed), (512,))
    g_j = jax.random.gumbel(jax.random.PRNGKey(seed), (512,), jnp.float32)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-6)
    for temperature in (0.5, 1.0, 2.0):
        x = logits / np.float32(temperature)
        want = int(jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(x)))
        got = int(trandom.categorical(trandom.prng_key(seed), torch.from_numpy(x)))
        assert got == want


def test_sample_key_is_the_reference_key():
    # |logits| summing exactly: the key is int(sum * 1e3) mod 2**31, as engine.py makes it
    logits = torch.tensor([[0.5, -1.25, 2.0, 0.125]])
    want = jax.random.PRNGKey(int(jnp.sum(jnp.abs(jnp.asarray(logits.numpy()))) * 1e3) % (2**31))
    assert sample_key(logits).tolist() == np.asarray(jax.random.key_data(want)).tolist()


def test_engine_temperature_sampling_runs_in_range():
    _, _, tcfg, tp = _both("qwen3-4b", 0)
    prompts = [np.arange(6, dtype=np.int32) * (i + 1) for i in range(3)]
    a = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=2, temperature=0.8)
    b = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=2, temperature=0.8)
    assert a == b
    assert all(0 <= t < tcfg.padded_vocab for toks in a.values() for t in toks)


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b", "mixtral-8x22b"])
def test_serve_cli_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--requests", "5"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "served 5 requests" in out.stdout
    assert out.stdout.count("req ") == 5


def test_serving_device_needs_a_card_unless_cpu_is_asked():
    assert serving_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert serving_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            serving_device("cuda")
