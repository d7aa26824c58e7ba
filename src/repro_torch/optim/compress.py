"""Gradient compression with error feedback (the reference's
``optim/compress.py``): int8 quantization where each step adds back the
residual of the previous quantization before quantizing, so the scheme is
unbiased over time (EF-SGD).  The reference means it for a cross-pod
all-reduce; on one card it is the same arithmetic with nothing to reduce.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the port's
int8 codes, dequantized gradients and residuals are the reference's bit
for bit.

Usage:
    comp = GradCompressor()
    state = comp.init(params)
    grads, state = comp(grads, state)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    bits: int = 8

    def init(self, params) -> Any:
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def __call__(self, grads, residual) -> Tuple[Any, Any]:
        qmax = float(2 ** (self.bits - 1) - 1)

        def comp(g, r):
            g32 = g.to(torch.float32) + r
            scale = torch.clamp(g32.abs().max(), min=1e-12) / qmax
            q = torch.clamp(torch.round(g32 / scale), -qmax, qmax).to(
                torch.int8)
            deq = q.to(torch.float32) * scale
            return deq.to(g.dtype), g32 - deq

        done = [comp(g, r) for g, r in zip(tree_leaves(grads),
                                           tree_leaves(residual))]
        return (tree_unflatten(grads, [d[0] for d in done]),
                tree_unflatten(residual, [d[1] for d in done]))
