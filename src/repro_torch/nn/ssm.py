"""Selective state-space (Mamba-style) mixer of the hymba hybrid: the twin
of the reference's ``nn/ssm.py``.

x (B, S, D) -> y (B, S, D) with a per-channel selective state of size N.
The full-sequence mixer (`ssm_scan`) hands its recurrence to
``kernels/ops.ssm_scan``: on the card the hand-written selective-scan
kernels (``kernels/ssm_scan.py``; under autograd ``SSMScanFn``, the
forward kernel and the backward kernel), on the CPU their plain
versions, time loops in torch ops (``kernels/ref.ssm_scan``,
``ref.ssm_scan_bwd``).  Decoding keeps an explicit (B, Di, N) state and
a (B, K-1, Di) conv tail, so one token costs O(Di·N) in a few eager
torch ops and no loop.

Params keep the reference's layout and initial bits (``ssm_init`` draws
through ``core/prng`` from the same keys).

Across a 'model' axis (``train/parallel``) the mixer is channel
parallel: each rank runs the conv, the scan (the same kernels at Di/m
channels) and the gate on its block of the Di channels, the (dt, B, C)
projection's contraction over Di and ``out_proj``'s are summed over
'model'; the decode state is the same block (``_channel_params``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.ref import softplus
from repro_torch.train import parallel as PAR


def ssm_init(key: torch.Tensor, d_model: int, d_state: int = 16,
             d_conv: int = 4, expand: int = 2, *, device):
    """The reference's ``ssm_init``, bit for bit: six keys of
    ``split(key, 6)`` (the sixth unused, as there), the same scales;
    ``A_log = log(tile(arange(1, N + 1)))`` through XLA-on-CPU's float32
    ``log`` (``prng._log_f32``), which torch's ``log`` misses by an ulp."""
    d_inner = expand * d_model
    r = prng.split(key.to(device), 6)
    s = (2.0 / d_model) ** 0.5

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    n = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": prng.normal_scaled(r[0], (d_model, 2 * d_inner), s,
                                      device),
        "conv_w": prng.normal_scaled(r[1], (d_conv, d_inner), 0.2, device),
        "conv_b": const((d_inner,), 0.0),
        # x -> (dt, B, C) projections
        "x_proj": prng.normal_scaled(r[2], (d_inner, 1 + 2 * d_state),
                                     (1.0 / d_inner) ** 0.5, device),
        "dt_bias": const((d_inner,), -4.6),             # softplus^-1(0.01)
        "dt_w": prng.normal_scaled(r[3], (1, d_inner), 0.1, device),
        "A_log": prng._log_f32(n.repeat(d_inner, 1)),
        "D_skip": const((d_inner,), 1.0),
        "out_proj": prng.normal_scaled(r[4], (d_inner, d_model),
                                       (1.0 / d_inner) ** 0.5, device),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along the sequence: x (B, S, Di), w (K, Di),
    b (Di,); tail (B, K-1, Di), the previous inputs of a continued
    decode.  The K shifted products are summed in the reference's order,
    then the bias."""
    k, s = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], k - 1, x.shape[2])) if tail is None
           else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                       # (B, S+K-1, Di)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _selective_inputs(params, x: torch.Tensor, ax=None):
    """dt (B, S, Di), bmat and cmat (B, S, N) of the conv's output x, and
    a = -exp(A_log) (Di, N).  With `ax` (a 'model' axis whose rank holds
    a block of the Di channels) ``x @ x_proj`` contracts the rank's
    channels only: its partial sums are summed over 'model' and entered
    again, the rank's channels reading (dt, B, C) whole."""
    d_state = (params["x_proj"].shape[1] - 1) // 2
    proj = x @ params["x_proj"]                           # (B, S, 1+2N)
    if ax is not None:
        proj = PAR.enter_local(PAR.sum_over(proj, ax.group), ax.group)
    dt = softplus(proj[..., :1] @ params["dt_w"] + params["dt_bias"])
    bmat = proj[..., 1:1 + d_state]
    cmat = proj[..., 1 + d_state:]
    a = -torch.exp(params["A_log"].to(torch.float32))
    return dt, bmat, cmat, a


def ssm_scan(params, xz: torch.Tensor, h0: Optional[torch.Tensor] = None,
             chunk: int = 64, use_fused: Optional[bool] = None, ax=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan: xz (B, S, 2·Di) from in_proj -> (y (B, S, Di),
    h_final (B, Di, N)).  The conv, SiLU, the (dt, B, C) projections,
    then the recurrence ``h = exp(dt·a)·h + dt·b·x``, ``y_t = Σ_n h·c``
    (``kernels/ops.ssm_scan``: the kernels on the card, differentiated by
    ``SSMScanFn``, which keeps the state every 64 steps as the reference's
    ``jax.checkpoint``-ed chunks do; ``use_fused=False`` the plain loop,
    which runs its chunks of `chunk` steps under ``torch.utils.checkpoint``
    with autograd on), then ``+ x·D_skip`` and ``· silu(z)``.  With `ax`
    every leaf and xz hold this rank's block of the channels
    (``_selective_inputs``)."""
    d_inner = params["conv_w"].shape[1]
    d_state = (params["x_proj"].shape[1] - 1) // 2
    x, z = xz.split(d_inner, dim=-1)                      # (B, S, Di) each
    x = F.silu(_conv_causal(x, params["conv_w"], params["conv_b"]))
    dt, bmat, cmat, a = _selective_inputs(params, x, ax)
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], d_inner, d_state), dtype=torch.float32)
    ys, h = ops.ssm_scan(dt, bmat.contiguous(), cmat.contiguous(), x, a, h0,
                         chunk=chunk, use_fused=use_fused)
    y = ys + x * params["D_skip"]
    y = y * F.silu(z)
    return y.to(xz.dtype), h


def ssm_apply(params, x: torch.Tensor,
              use_fused: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence mixer: (B, S, D) -> (B, S, D).  Across a 'model'
    axis, channel parallel (``_channel_params``)."""
    ax = PAR.model_axis()
    if ax is None:
        y, _ = ssm_scan(params, x @ params["in_proj"], use_fused=use_fused)
        return y @ params["out_proj"]
    params, x, xz, ax = _channel_params(params, x, ax)
    y, _ = ssm_scan(params, xz, use_fused=use_fused, ax=ax)
    return _out(y @ params["out_proj"], ax)


def _channel_params(params, x: torch.Tensor, ax):
    """(params, x, xz, ax) of the mixer across the 'model' axis `ax`.
    Where 'model' splits the Di channels (every (.., Di) leaf and x_proj's
    and out_proj's Di rows; in_proj's 2·Di columns, x then z, so a rank's
    block of them is not its channels) the rank computes its channels
    (rank-local work from the entered x): xz its x and z columns of
    in_proj (``PAR.column_blocks``), conv_b (replicated) its block, and
    `ax` is returned for ``x @ x_proj``'s sum and ``_out``'s.  Else every
    rank computes every channel (replicated work: in_proj's columns
    gathered, `ax` None)."""
    di = params["conv_b"].shape[-1]
    dr = params["conv_w"].shape[-1]
    if dr == di:
        return params, x, PAR.project(x, params["in_proj"], 2 * di, ax,
                                      local=False), None
    x = PAR.enter_local(x, ax.group)
    conv_b = PAR.enter_local(params["conv_b"], ax.group)
    params = dict(params, conv_b=conv_b[ax.rank * dr:(ax.rank + 1) * dr])
    return params, x, PAR.column_blocks(x, params["in_proj"], di, 2, ax), ax


def _out(y: torch.Tensor, ax) -> torch.Tensor:
    """The row-parallel ``out_proj``'s partial sums summed over 'model'
    (`ax`), or y where every rank computed every channel."""
    return y if ax is None else PAR.sum_over(y, ax.group)


def ssm_decode_init(params, batch: int, device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """An empty decode state: (h (B, Di, N), conv tail (B, K-1, Di))."""
    d_inner = params["conv_w"].shape[1]
    d_state = (params["x_proj"].shape[1] - 1) // 2
    k = params["conv_w"].shape[0]
    return (torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, k - 1, d_inner), dtype=torch.float32,
                        device=device))


def ssm_decode_step(params, x1: torch.Tensor, state):
    """One-token decode: x1 (B, 1, D), state (h, tail) -> (y1 (B, 1, D),
    the new (h, tail)).  The recurrence's one step in plain torch ops.
    Across a 'model' axis that splits the channels, (h, tail) are this
    rank's block of them (``state_specs`` puts their Di on 'model', as
    ``param_specs`` puts the params'), and the step is
    ``_channel_params``'s."""
    h, tail = state
    ax = PAR.model_axis()
    if ax is None:
        xz = x1 @ params["in_proj"]
    else:
        params, x1, xz, ax = _channel_params(params, x1, ax)
    d_inner = params["conv_w"].shape[1]
    if h.shape[1] != d_inner:
        raise ValueError(f"the SSM state holds {h.shape[1]} channels, the "
                         f"params {d_inner}")
    x, z = xz.split(d_inner, dim=-1)                         # (B, 1, Di)
    xc = F.silu(_conv_causal(x, params["conv_w"], params["conv_b"],
                             tail=tail))
    new_tail = torch.cat([tail[:, 1:], x.to(tail.dtype)], dim=1)
    dt, bmat, cmat, a = _selective_inputs(params, xc, ax)
    da = torch.exp(dt[:, 0, :, None] * a)                    # (B, Di, N)
    dbx = dt[:, 0, :, None] * bmat[:, 0, None] * xc[:, 0, :, None]
    h = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].to(h.dtype))[:, None]
    y = y + xc * params["D_skip"]
    y = y * F.silu(z)
    y = _out(y @ params["out_proj"].to(y.dtype), ax)
    return y.to(x1.dtype), (h, new_tail)
