"""Threefry-2x32 keys and uniform draws: GANDSE's noise, worked out from a
seed without the program.

A key is an int64 tensor (..., 2) of uint32 words; ``key(seed)`` is
``(0, seed mod 2**32)``.  ``fold_in(key, d)`` hashes the counter (0, d);
``split(key, n)`` is ``fold_in(key, i)`` for i < n; ``uniform(key, n, lo,
hi)`` hashes counter (0, i) for element i, keeps ``w1 ^ w2``, makes a
float in [1, 2) of its top 23 bits, and maps [0, 1) onto [lo, hi) in
float64 before rounding to float32 once.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def hash2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, of counter (x1, x2) under key (k1, k2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & MASK32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seeds, device="cpu") -> torch.Tensor:
    s = torch.as_tensor(np.asarray(seeds, np.int64) & MASK32, device=device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    y1, y2 = hash2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    return fold_in(k[..., None, :], torch.arange(n, device=k.device))


def uniform(k: torch.Tensor, n: int, lo: float, hi: float) -> torch.Tensor:
    """(..., 2) keys -> (..., n) float32 in [lo, hi)."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    b1, b2 = hash2x32(k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i)
    mant = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    unit = mant.view(torch.float32).double() - 1.0
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    span = float(np.float32(hi32 - lo32))
    return torch.clamp((unit * span + lo32).float(), min=lo32)
