"""Entry points of the LM substrate's kernels, with the caller's opt-out.

The counterpart of the reference's ``kernels/ops.py``.  There the Pallas
kernel runs on the TPU (or in interpret mode) and the jnp oracle
elsewhere; here the device rule is the kernel wrapper's
(``kernels/flash_attention.py``, ``kernels/ssm_scan.py``,
``kernels/slstm_scan.py``: a CPU tensor
gets the plain version, a CUDA tensor the kernel or an exception), and
``use_fused=False`` is the caller's explicit opt-out to the plain
version on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import slstm_scan as _sl
from repro_torch.kernels import ssm_scan as _ss


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, use_fused: Optional[bool] = None,
                    return_lse: bool = False):
    """(B, H, Sq, D) x (B, Hkv, Sk, D)^2 -> (B, H, Sq, D), and with
    ``return_lse`` also the rows' (B, H, Sq) float32 log-sum-exp."""
    fn = _ref.flash_attention if use_fused is False else _fa.flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
              return_lse=return_lse)


def ssm_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor, *,
             chunk: int = 64, use_fused: Optional[bool] = None):
    """The selective scan's recurrence: dt, x (B, S, Di), bmat, cmat
    (B, S, N), a (Di, N), h0 (B, Di, N) -> (ys (B, S, Di), h (B, Di, N)).
    By default ``kernels/ssm_scan.ssm_scan``: inputs that need a gradient
    go through ``SSMScanFn`` (on the card the forward and backward
    kernels).  ``use_fused=False`` takes the plain loop under torch's
    autograd (``kernels/ref.ssm_scan``, its chunks of `chunk` steps
    checkpointed)."""
    if use_fused is False:
        return _ref.ssm_scan(dt, bmat, cmat, x, a, h0, chunk=chunk)
    return _ss.ssm_scan(dt, bmat, cmat, x, a, h0, chunk=chunk)


def slstm_scan(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
               state, *, use_fused: Optional[bool] = None):
    """The sLSTM's recurrence: wx (B, S, 4D), rh (H, dh, 4dh), bias (4D,),
    state (c, n, m, h) each (B, D) -> (hs (B, S, D), the final state).
    By default ``kernels/slstm_scan.slstm_scan``: the kernel on the card,
    and under autograd ``SLSTMScanFn`` (the forward kernel with its chunk
    states, then the backward kernel; on the CPU their plain versions).
    ``use_fused=False`` takes the plain loop (``kernels/ref.slstm_scan``)
    under torch's own autograd."""
    if use_fused is False:
        return _ref.slstm_scan(wx, rh, bias, state)
    return _sl.slstm_scan(wx, rh, bias, state)
