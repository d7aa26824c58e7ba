"""Entry points of the LM substrate's kernels, with the caller's opt-out.

The counterpart of the reference's ``kernels/ops.py``.  There the Pallas
kernel runs on the TPU (or in interpret mode) and the jnp oracle
elsewhere; here the device rule is the kernel wrapper's
(``kernels/flash_attention.py``: a CPU tensor gets the plain version, a
CUDA tensor the kernel or an exception), and ``use_fused=False`` is the
caller's explicit opt-out to the plain version on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, use_fused: Optional[bool] = None,
                    return_lse: bool = False):
    """(B, H, Sq, D) x (B, Hkv, Sk, D)^2 -> (B, H, Sq, D), and with
    ``return_lse`` also the rows' (B, H, Sq) float32 log-sum-exp."""
    fn = _ref.flash_attention if use_fused is False else _fa.flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
              return_lse=return_lse)
