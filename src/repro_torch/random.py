"""Threefry-2x32 counter-based RNG that draws the bits ``jax.random`` draws.

The reference package draws from ``jax.random`` in two places on the
stream path: every source batch (``fold_in(PRNGKey(seed), step)`` then
``normal``) and the ``linreg`` weights (``normal(PRNGKey(seed), (5,))``).
A sink checksum can only match the reference if the port draws the same
numbers, so this module reimplements the pieces those calls use:

* keys are ``(2,)`` tensors of uint32 words held in int64 (torch has no
  uint32 arithmetic); every add is masked back to 32 bits;
* ``PRNGKey`` follows jax's default 32-bit mode: the seed's low 32 bits
  in the second word, zero in the first;
* ``random_bits`` follows ``jax_threefry_partitionable=True`` (the jax
  default): element ``i`` of the flattened shape is
  ``y0 ^ y1`` with ``(y0, y1) = threefry2x32(key, (i >> 32, i & mask))``;
* ``uniform`` builds floats from the bits exactly as jax does;
* ``normal`` is ``sqrt(2)·erfinv(u)`` with XLA's float32 ``erfinv`` (M.
  Giles' polynomial). XLA evaluates the polynomial with fused
  multiply-adds, which are emulated here by one float64 multiply-add
  rounded to float32, so about 99% of normals are bit-equal to jax's and
  the rest differ by an ulp or two (``log1p`` differs too).

The bits come from integer ops only, so they are the same on the CPU and on
the card.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block cipher on uint32 words (as int64)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: encrypt ``(0, data)`` under ``key``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([y0, y1]).reshape(2)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64), partitionable mode."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform`` for float32: 23 random mantissa bits in [1, 2),
    shifted to [0, 1), then scaled to ``[minval, maxval)`` in float32."""
    bits = random_bits(key, shape)
    float_bits = (bits >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    # jax rounds the bounds to float32 and takes their difference in float32;
    # Python scalars keep these constants off the device (no copy, no sync).
    # XLA fuses the scale and shift into one FMA: one float64 multiply-add,
    # rounded once to float32, stands in for it (the product is exact).
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function"),
# highest degree first, for w < 5 and for w >= 5.
_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv`` as XLA computes it (±1 maps to ±inf)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, c_lt, c_ge)  # float32, as XLA's constants
        p = (c.double() + p.double() * w).float()  # one rounding, as an FMA
    y = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, y)


_SQRT2 = float(np.float32(math.sqrt(2)))
# float32 nextafter(-1, 0): jax draws normals from u on (-1, 1)
_OPEN_MINUS_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` for float32: ``sqrt(2)·erfinv(u)``, u on (-1, 1)."""
    return erfinv(uniform(key, shape, _OPEN_MINUS_ONE, 1.0)) * _SQRT2


_F32_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` for float32 in its default ("low") mode:
    ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max trick),
    for float32 logits: ``argmax(gumbel(key, logits.shape) + logits)``."""
    g = gumbel(key.to(logits.device), tuple(logits.shape))
    return torch.argmax(g + logits.float(), dim=-1)
