"""repro_torch.random against jax.random: the draws the stream path makes.

Keys, raw bits and uniforms are exact (integer ops, and float construction
from the bits). Normals pass through erfinv, whose float32 polynomial the
port evaluates with an emulated FMA: allclose at the f32 precedent of
tests/test_kernels.py (2e-5), and nearly all of them bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as rng

F32_TOL = dict(rtol=2e-5, atol=2e-5)
SEEDS = [0, 1, 42, 2**31 - 1, 2**31, 3_000_000_000, 2**32 - 1, -1]
STEPS = [0, 1, 7, 123_456]


def _jax_key(seed, step=None):
    key = jax.random.PRNGKey(seed)
    return key if step is None else jax.random.fold_in(key, step)


def _torch_key(seed, step=None):
    key = rng.prng_key(seed)
    return key if step is None else rng.fold_in(key, step)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_exact(seed):
    want = np.asarray(jax.random.key_data(_jax_key(seed)), np.int64)
    assert np.array_equal(rng.prng_key(seed).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", STEPS)
def test_fold_in_exact(seed, step):
    want = np.asarray(jax.random.key_data(_jax_key(seed, step)), np.int64)
    assert np.array_equal(rng.fold_in(rng.prng_key(seed), step).numpy(), want)


def test_fold_in_takes_a_step_tensor():
    # the sources fold in their int32 step counter, a tensor on the device
    step = torch.tensor(9, dtype=torch.int32)
    want = rng.fold_in(rng.prng_key(5), 9)
    assert torch.equal(rng.fold_in(rng.prng_key(5), step), want)


@pytest.mark.parametrize("seed", [0, 42, 3_000_000_000])
@pytest.mark.parametrize("shape", [(5,), (33, 5), (4, 3, 2)])
def test_random_bits_exact(seed, shape):
    want = np.asarray(jax.random.bits(_jax_key(seed, 3), shape, jnp.uint32), np.int64)
    got = rng.random_bits(_torch_key(seed, 3), shape).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 7.5), (0.1, 0.3)])
def test_uniform_exact(lo, hi):
    for seed in (0, 11, 2**31 + 5):
        want = np.asarray(jax.random.uniform(_jax_key(seed, 2), (257, 5), minval=lo, maxval=hi))
        got = rng.uniform(_torch_key(seed, 2), (257, 5), lo, hi).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 42, 3_000_000_000])
def test_normal_allclose(seed):
    for step in (0, 5):
        want = np.asarray(jax.random.normal(_jax_key(seed, step), (2048, 5)))
        got = rng.normal(_torch_key(seed, step), (2048, 5)).numpy()
        np.testing.assert_allclose(got, want, **F32_TOL)
        assert np.mean(got == want) > 0.95  # the emulated FMA tracks XLA's


def test_linreg_weights_allclose():
    # ops/riot.py draws the linreg weights as normal(PRNGKey(seed), (5,)) * 0.3
    for seed in range(4):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (5,)) * 0.3)
        got = (rng.normal(rng.prng_key(seed), (5,)) * 0.3).numpy()
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = rng.erfinv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    np.testing.assert_allclose(got[2:], want[2:], **F32_TOL)
