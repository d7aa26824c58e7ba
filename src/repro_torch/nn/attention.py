"""Attention of the LM substrate: GQA, sliding window, full sequence and
one-token decode.

  * ``flash_attention`` — full-sequence attention, the counterpart of the
    reference's ``flash_attention_xla``.  It goes through
    ``kernels/ops.flash_attention``: on the card every full-sequence
    attention runs the CUDA kernel, whatever its length (the reference's
    ``sq < q_block`` fallback and its XLA scan have no counterpart), and on
    the CPU the plain version.  Under autograd it runs ``FlashAttentionFn``,
    the counterpart of the reference's custom VJP ``_flash_custom``: the
    kernel's forward with each row's log-sum-exp kept, and a backward that
    recomputes the score tiles one q block at a time.
  * ``attention_reference`` — unblocked, for tests.
  * ``decode_attention`` — a one-token query against a (possibly
    ring-buffered) KV cache, with the per-lane stale-KV mask.

Shapes: q (B, S, H, D); k, v (B, S, Hkv, D); H = Hkv * G.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


def _split_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, Hkv, G, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Unblocked attention on (B, S, H, D); q_offset is the absolute
    position of q[0] (a continued prefill)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = _split_heads(q, hkv)                               # (B,Sq,Hkv,G,D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / d ** 0.5
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   q_block: int = 512):
    """The reference's ``_flash_custom_bwd`` in torch ops, on (B, H, S, D)
    tensors and the forward's (B, H, Sq) float32 ``lse``; returns (dq, dk,
    dv) in q's, k's and v's dtypes.

    delta = rowsum(dout·out); then per block of ``q_block`` query rows
    (the last one may be partial) over the keys its rows can see (the
    band [lo, hi): causal rows stop at their own position, a window starts
    ``window - 1`` before the block's first row): p = exp(s - lse) under
    the mask, dv += pᵀ·do, ds = p·(do·vᵀ - delta), dq = ds·k·scale, dk +=
    dsᵀ·q·scale.  The G query heads of a kv head are one row axis of the
    products, so dk and dv sum over them.  The reference's band rounds up
    to whole kv blocks and, with no window, takes every key; the keys past
    the band are masked there, so they add exact zeros.  These are plain
    large products, which the reference leaves to XLA outside any Pallas
    kernel; here they go to torch.matmul."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / d ** 0.5
    f32 = torch.float32
    k32, v32 = k.to(f32), v.to(f32)
    do = dout.to(f32)
    delta = (do * out.to(f32)).sum(-1)                       # (B, H, Sq)
    qg = q.to(f32).reshape(b, hkv, g, sq, d)
    dog = do.reshape(b, hkv, g, sq, d)
    lse_g, delta_g = (t.reshape(b, hkv, g, sq, 1) for t in (lse, delta))
    dq = torch.zeros((b, hkv, g, sq, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, hkv, sk, d), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, sq, q_block):
        r1 = min(r0 + q_block, sq)
        lo = max(0, q_offset + r0 - window + 1) if window else 0
        hi = min(sk, q_offset + r1) if causal else sk
        if hi <= lo:                       # no key in band: dq stays 0
            continue
        n = g * (r1 - r0)
        qb = qg[:, :, :, r0:r1].reshape(b, hkv, n, d)
        dob = dog[:, :, :, r0:r1].reshape(b, hkv, n, d)
        kb, vb = k32[:, :, lo:hi], v32[:, :, lo:hi]
        qpos = torch.arange(r0, r1, device=q.device) + q_offset
        kpos = torch.arange(lo, hi, device=q.device)
        keep = torch.ones((r1 - r0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            keep &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            keep &= (qpos[:, None] - kpos[None, :]) < window
        # s -> p and dp -> ds in place: two (B, Hkv, G·Qb, Kb) tensors live
        p = torch.matmul(qb, kb.transpose(-1, -2)).mul_(scale).view(
            b, hkv, g, r1 - r0, hi - lo)
        p = p.sub_(lse_g[:, :, :, r0:r1]).exp_().masked_fill_(~keep, 0.0)
        p = p.view(b, hkv, n, hi - lo)
        dv[:, :, lo:hi] += torch.matmul(p.transpose(-1, -2), dob)
        ds = torch.matmul(dob, vb.transpose(-1, -2)).view(
            b, hkv, g, r1 - r0, hi - lo)
        ds = ds.sub_(delta_g[:, :, :, r0:r1]).view(b, hkv, n, hi - lo).mul_(p)
        dq[:, :, :, r0:r1] = (torch.matmul(ds, kb) * scale).view(
            b, hkv, g, r1 - r0, d)
        dk[:, :, lo:hi] += torch.matmul(ds.transpose(-1, -2), qb) * scale
        del p, ds
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention on (B, H, S, D) tensors: the
    counterpart of the reference's ``_flash_custom`` (custom VJP).

    forward: ``kernels/ops.flash_attention(..., return_lse=True)`` — the
    kernel on the card, the plain version on the CPU — saving q, k, v, out
    and lse; backward: ``flash_backward``, which recomputes each score
    tile from lse, so no (Sq, Sk) probability matrix is kept between the
    passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_block):
        out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        q_block=q_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    use_fused: Optional[bool] = None,
                    q_block: int = 512) -> torch.Tensor:
    """Full-sequence attention on (B, S, H, D), returned as (B, S, H, D).

    The kernel takes (B, H, S, D) with any strides but a contiguous last
    dim, so the (B, S, H, D) tensors are passed as ``transpose(1, 2)``
    views with no copy, and the kernel writes its output in q's layout:
    the transpose back is a view of a (B, S, H, D) tensor again.  When
    grad is enabled and an input requires it, the call goes through
    ``FlashAttentionFn`` (its backward in blocks of ``q_block`` query
    rows); otherwise the forward alone runs.  ``use_fused=False`` takes
    the unblocked plain version on any device, under torch's own
    autograd."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if (use_fused is not False and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        o = FlashAttentionFn.apply(qt, kt, vt, causal, window, q_offset,
                                   q_block)
    else:
        o = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                q_offset=q_offset, use_fused=use_fused)
    return o.transpose(1, 2)


def _slot_valid(slot: torch.Tensor, sc: int, cache_len: int,
                window: Optional[int], ring: bool,
                start: Optional[torch.Tensor]) -> torch.Tensor:
    """Which cache slots (global indices `slot` of a cache of `sc` slots)
    a decode step reads: (S,), or (B, S) with `start` (see
    ``decode_attention``)."""
    if ring:
        if window is None or sc > window:
            raise ValueError(f"a ring cache needs Sc <= window, got Sc {sc} "
                             f"and window {window}")
        cur = cache_len - 1                                 # newest position
        # ceil((cur + 1 - slot) / sc) in integers
        wraps = -torch.div(slot - cur - 1, sc, rounding_mode="floor")
        pos = slot + wraps * sc - sc
        valid = (pos >= 0) & (pos >= cache_len - window) & (pos <= cur)
    else:
        pos = slot                      # non-ring: slot == absolute position
        valid = slot < cache_len
        if window is not None:
            valid &= slot >= cache_len - window
    if start is not None:
        # a slot whose (attributed) absolute position precedes the lane's
        # stream start belongs to a previous occupant
        valid = valid[None, :] & (pos[None, :] >= start.reshape(-1, 1))
    return valid


def _masked_scores(q1, k_cache, valid):
    """(B, Hkv, G, S) float32 scores of one query against a cache, NEG_INF
    where `valid` ((S,) or (B, S)) is False."""
    d = q1.shape[-1]
    qg = _split_heads(q1, k_cache.shape[2])[:, 0]          # (B,Hkv,G,D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / d ** 0.5
    mask = valid[:, None, None, :] if valid.dim() == 2 else valid
    return torch.where(mask, scores, NEG_INF), mask


def decode_attention(q1, k_cache, v_cache, cache_len: int, *,
                     window: Optional[int] = None, ring: bool = False,
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode: q1 (B, 1, H, D) vs cache (B, Sc, Hkv, D).

    cache_len: number of valid cached tokens (new token already written).
    ring=True: the cache is a ring buffer of Sc <= window slots; slot i
    holds the newest absolute position p <= cache_len - 1 with
    p % Sc == i.  (The reference asserts Sc == window; with Sc < window
    the ring holds the last Sc positions only, and the serving engine
    stops before it would wrap, see ``launch/serve.Engine``.)
    start: optional (B,) per-lane first valid absolute position — cache
    entries before it were written by a lane's previous occupant and are
    masked out (``launch/serve.Engine`` reuses lanes).
    """
    b, _, h, d = q1.shape
    sc = k_cache.shape[1]
    valid = _slot_valid(torch.arange(sc, device=q1.device), sc, cache_len,
                        window, ring, start)
    scores, _ = _masked_scores(q1, k_cache, valid)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q1.dtype)


def decode_attention_block(q1, k_blk, v_blk, cache_len: int, *, sc: int,
                           slot0: int, window: Optional[int] = None,
                           ring: bool = False,
                           start: Optional[torch.Tensor] = None):
    """``decode_attention`` over one block of a cache of `sc` slots (slots
    ``slot0 .. slot0 + Sb - 1``, k_blk and v_blk (B, Sb, Hkv, D)), left
    unnormalized for ``combine_blocks``: (m (B, Hkv, G), the block's row
    max of the scores, NEG_INF where it reads no slot; l, the sum of
    exp(s - m) over its slots; o (B, Hkv, G, D), their exp(s - m)-weighted
    sum of v), float32."""
    sb = k_blk.shape[1]
    slot = torch.arange(slot0, slot0 + sb, device=q1.device)
    valid = _slot_valid(slot, sc, cache_len, window, ring, start)
    scores, mask = _masked_scores(q1, k_blk, valid)
    m = scores.amax(-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_blk.to(torch.float32))
    return m, p.sum(-1), o


def combine_blocks(m, l, o, group, dtype) -> torch.Tensor:
    """The blocks' (m, l, o) of ``decode_attention_block`` over a cache
    split along S between the ranks of `group`, combined by the online
    softmax rule: M = max m, out = Σ o·exp(m - M) / Σ l·exp(m - M) (one
    all-reduce for the max, one for both sums).  -> (B, 1, H, D)."""
    from repro_torch.train import parallel as PAR

    big = PAR.max_over(m.clone(), group)
    scale = torch.exp(m - big)
    both = torch.cat([o * scale[..., None], (l * scale)[..., None]], -1)
    both = PAR.sum_over(both, group)
    out = both[..., :-1] / both[..., -1:]
    b, hkv, g, d = out.shape
    return out.reshape(b, 1, hkv * g, d).to(dtype)
