"""Attention of the LM substrate: GQA, sliding window, full sequence and
one-token decode.

  * ``flash_attention`` — full-sequence attention, the counterpart of the
    reference's ``flash_attention_xla``.  It goes through
    ``kernels/ops.flash_attention``: on the card every full-sequence
    attention runs the CUDA kernel, whatever its length (the reference's
    ``sq < q_block`` fallback and its XLA scan have no counterpart), and on
    the CPU the plain version.
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


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    use_fused: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence attention on (B, S, H, D), returned as (B, S, H, D).

    The kernel takes (B, H, S, D) with any strides but a contiguous last
    dim, so the (B, S, H, D) tensors are passed as ``transpose(1, 2)``
    views with no copy, and the kernel writes its output in q's layout:
    the transpose back is a view of a (B, S, H, D) tensor again.
    ``use_fused=False`` takes the plain version on any device."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            q_offset=q_offset, use_fused=use_fused)
    return o.transpose(1, 2)


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
    sc, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = _split_heads(q1, hkv)[:, 0]                        # (B,Hkv,G,D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / d ** 0.5
    slot = torch.arange(sc, device=q1.device)
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
        scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    else:
        scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q1.dtype)
