"""Threefry-2x32 counter-based PRNG: the bits of exactly the reference's
noise calls, so seed s draws the same G noise in both packages.

G's noise for task key k and sample s is
``uniform(fold_in(k, s), (1, noise_dim), float32, -0.1, 0.1)`` with
``k = PRNGKey(uint32(seed))`` (the reference's ``task_keys``).  This
module reproduces those three calls bit for bit:

- ``prng_key(seed)``: a uint32 seed becomes the key ``(0, seed)``;
- ``fold_in(key, s)``: ``threefry2x32(key, (0, s))``;
- ``split(key, n)``: in partitionable mode key i of the split is
  ``fold_in(key, i)`` (Algorithm 1's ``rng, nrng = split(rng)``);
- ``uniform(key, n, lo, hi)``: the *partitionable* bit recipe — element
  i of the flattened shape hashes the 64-bit counter ``(hi=0, lo=i)`` and
  takes ``bits1 ^ bits2`` — then the float recipe: the top 23 bits become
  the mantissa of a float in [1, 2), minus 1, scaled into [lo, hi).
  XLA on the CPU contracts that scale, ``f * (hi - lo) + lo``, into one
  fused multiply-add, so `fma_f32` rounds it once, as an FMA does.

Partitionable mode (``jax_threefry_partitionable``) is on by default in
current JAX and is what this module follows; the legacy mode drew the
same threefry hash over a different counter layout and gives other bits.

Keys are int64 tensors of shape (..., 2) holding uint32 values; all
arithmetic is integer torch ops on int64 masked to 32 bits (torch's
uint32 supports few operations).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2); all int64 tensors holding uint32 values, broadcast.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``PRNGKey`` of uint32 seeds: (...,) int64 in [0, 2**32) -> (..., 2)."""
    seed = seed.to(torch.int64) & MASK32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in(key, data)``: (..., 2) keys, integer data broadcast
    against the key batch -> (..., 2) keys."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (..., 2) keys -> (..., n, 2)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], i)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words for a flattened shape of n elements (< 2**32):
    (..., 2) keys -> (..., n) int64 in [0, 2**32)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float, maxval: float
            ) -> torch.Tensor:
    """``uniform(key, shape, float32, minval, maxval)`` for a shape of n
    elements (row-major flat): (..., 2) keys -> (..., n) float32."""
    bits = random_bits(key, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, fma_f32(floats, hi - lo, lo))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add).

    The float64 product of two float32 values is exact; the float64 sum
    rounds, and its exact error ``e`` comes from TwoSum.  Rounding that
    sum to float32 is then correct unless it lies exactly halfway between
    two float32 values, where ``e`` decides the side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    rd = r.double()
    diff = s - rd
    toward = torch.where(diff > 0, float("inf"), float("-inf")).float()
    n = torch.nextafter(r, toward)
    mid = (diff != 0) & (s == (rd + n.double()) * 0.5)
    past = mid & (e != 0) & ((e > 0) == (diff > 0))
    return torch.where(past, n, r)
