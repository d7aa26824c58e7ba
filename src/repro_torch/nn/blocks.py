"""The blocks of the LM substrate, as (init, apply, decode) functions on
dict params in the reference's layout: the decoder block (GQA /
sliding-window / qk-norm attention and a SwiGLU FFN, or with
``n_experts > 0`` the MoE FFN (``nn/moe``), and with ``ssm_state > 0``
hymba's parallel SSM branch (``nn/ssm``, mixed as ``mix_a·attn +
mix_s·ssm``)), and whisper's pre-LN encoder and decoder blocks
(LayerNorm, a GEGLU FFN with the tanh gelu, non-causal self-attention in
the encoder, causal self-attention then cross-attention over the
encoder's output in the decoder).  Init draws the reference's bits from
a threefry key (``core/prng``), split as the reference splits it.

Full-sequence attention runs through ``nn/attention.flash_attention`` and
the SSM's recurrence through ``kernels/ops.ssm_scan``, so on the card
through the flash-attention and selective-scan kernels; ``use_fused=False``
opts those two calls out to their plain versions and touches nothing
else.  Whisper's cross-attention goes through the flash kernel too (Sq
queries against the encoder's Sk keys, no mask; one query at decode),
where the reference calls its unblocked ``attention_reference``.  The
MoE FFN takes the (B, S, D) tokens as one (B·S, D) batch, as the
reference does, so a decode step routes its lanes together (with the
reference's capacity for that many tokens).  With ``mrope_sections``
(qwen2-vl) q and k take M-RoPE over (3, B, S) positions; (B, S) text
positions are broadcast to all three rows, in prefill and in decode.

Decode updates the KV cache in place (the reference returns a new cache):
the caches of a segment are one (repeats, B, span, Hkv, dh) tensor, and a
layer writes its slot through a view of it, so a step copies no cache.
The SSM's decode returns its new (h, tail), which ``models/base``
writes back into the layer's view of the stacked state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import ssm as S
from repro_torch.train import parallel as PAR
from repro_torch.train import shardings as SH

@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """Static per-architecture block hyperparameters."""

    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    qk_norm: bool = False
    window: Optional[int] = None        # sliding-window width (None = full)
    rope_theta: float = 10000.0
    n_experts: int = 0                  # 0 -> dense FFN
    top_k: int = 2
    ssm_state: int = 0                  # >0 -> hymba parallel SSM branch
    mrope_sections: Optional[Tuple[int, int, int]] = None

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# attention sub-layer
# ---------------------------------------------------------------------------
def attn_init(key: torch.Tensor, cfg: BlockCfg, device):
    """wq, wkv and wo from the first three keys of ``split(key, 4)``."""
    dh = cfg.dh
    r = prng.split(key.to(device), 4)
    s = (1.0 / cfg.d_model) ** 0.5
    p = {
        "wq": prng.normal_scaled(r[0], (cfg.d_model, cfg.n_heads * dh), s,
                                 device),
        "wkv": prng.normal_scaled(r[1], (cfg.d_model, 2 * cfg.n_kv * dh), s,
                                  device),
        "wo": prng.normal_scaled(r[2], (cfg.n_heads * dh, cfg.d_model),
                                 (1.0 / (cfg.n_heads * dh)) ** 0.5, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, device)
        p["k_norm"] = L.rmsnorm_init(dh, device)
    return p


def _qkv(params, x, cfg: BlockCfg, positions):
    b, s, _ = x.shape
    dh = cfg.dh
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, dh)
    kv = (x @ params["wkv"]).reshape(b, s, 2 * cfg.n_kv, dh)
    k, v = kv[:, :, : cfg.n_kv], kv[:, :, cfg.n_kv:]
    q, k = _norm_rope(params, q, k, cfg, positions)
    return q, k, v


def _norm_rope(params, q, k, cfg: BlockCfg, positions):
    """qk-norm (where the config has it), then RoPE or M-RoPE, on q and k
    (B, S, heads, dh)."""
    if cfg.qk_norm:
        q = L.rmsnorm_apply(params["q_norm"], q)
        k = L.rmsnorm_apply(params["k_norm"], k)
    if cfg.mrope_sections is not None:
        if positions.dim() == 2:       # text-only: t/h/w positions coincide
            positions = positions[None].expand((3,) + positions.shape)
        q = L.apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = L.apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def attn_apply(params, x, cfg: BlockCfg, positions, *, causal: bool = True,
               use_fused: Optional[bool] = None):
    """Full-sequence attention: x (B, S, D) -> (B, S, D)."""
    ax = PAR.model_axis()
    if ax is not None:
        return _attn_apply_sharded(params, x, cfg, positions, causal,
                                   use_fused, ax)
    q, k, v = _qkv(params, x, cfg, positions)
    o = A.flash_attention(q, k, v, causal=causal, window=cfg.window,
                          use_fused=use_fused)
    b, s, _, _ = q.shape
    return o.reshape(b, s, -1) @ params["wo"]


def attn_decode(params, x1, cfg: BlockCfg, pos, kv_cache, cache_len: int, *,
                ring: bool = False, start=None, kv_spec=None):
    """One-token decode.  kv_cache: (k (B, Sc, Hkv, dh), v), written in
    place at slot ``cache_len`` (mod Sc on a ring); returns (y1, cache).
    `pos` is the absolute position, (B, 1) (under M-RoPE broadcast to
    its three rows); `start` the optional (B,)
    per-lane stale-KV mask (see ``decode_attention``).  Across a 'model'
    axis the cache is this rank's block under `kv_spec`, its
    ``state_spec`` without the layer axis (``_attn_decode_sharded``)."""
    ax = PAR.model_axis()
    if ax is not None:
        return _attn_decode_sharded(params, x1, cfg, pos, kv_cache,
                                    cache_len, ring, start, kv_spec, ax)
    q, k, v = _qkv(params, x1, cfg, pos)
    kc, vc = kv_cache
    slot = cache_len % kc.shape[1] if ring else cache_len
    # a slot past a full cache raises IndexError here, where the
    # reference's dynamic_update_slice clamps it onto the last slot
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    o = A.decode_attention(q, kc, vc, cache_len + 1, window=cfg.window,
                           ring=ring, start=start)
    return o.reshape(x1.shape[0], 1, -1) @ params["wo"], (kc, vc)


# ---------------------------------------------------------------------------
# FFN sub-layer (SwiGLU) or MoE
# ---------------------------------------------------------------------------
def ffn_init(key: torch.Tensor, cfg: BlockCfg, device):
    """The MoE FFN from `key`, or w_gate, w_up and w_down from
    ``split(key, 3)``."""
    if cfg.n_experts:
        return M.moe_init(key, cfg.n_experts, cfg.d_model, cfg.d_ff, device)
    r = prng.split(key.to(device), 3)
    s_in = (2.0 / cfg.d_model) ** 0.5
    return {
        "w_gate": prng.normal_scaled(r[0], (cfg.d_model, cfg.d_ff), s_in,
                                     device),
        "w_up": prng.normal_scaled(r[1], (cfg.d_model, cfg.d_ff), s_in,
                                   device),
        "w_down": prng.normal_scaled(r[2], (cfg.d_ff, cfg.d_model),
                                     (1.0 / cfg.d_ff) ** 0.5, device),
    }


def ffn_apply(params, x, cfg: BlockCfg, glu=None):
    """The FFN: the MoE's, or the gated unit `glu` (``_swiglu`` by
    default; whisper's blocks pass ``_geglu``) of w_gate, w_up and
    w_down."""
    glu = glu or _swiglu
    ax = PAR.model_axis()
    if ax is not None:
        return _ffn_apply_sharded(params, x, cfg, ax, glu)
    if cfg.n_experts:
        b, s, d = x.shape
        y = M.moe_apply(params, x.reshape(b * s, d), top_k=cfg.top_k)
        return y.reshape(b, s, d)
    return glu(params, x)


def _swiglu(params, x):
    g = torch.nn.functional.silu(x @ params["w_gate"])
    return (g * (x @ params["w_up"])) @ params["w_down"]


# ---------------------------------------------------------------------------
# across a 'model' axis (``train/parallel``): each rank computes on its
# blocks of the leaves, the FSDP dims already gathered, and every rank
# returns the whole (B, S, D) output.  A sub-layer that 'model' splits is
# rank-local work between ``enter_local`` (its input, and any leaf it
# reads whole) and ``sum_over`` (its row-parallel exit), so the same code
# serves and trains
# ---------------------------------------------------------------------------
def _qkv_sharded(params, x, cfg: BlockCfg, positions, ax, local: bool,
                 kv_src=None):
    """(q, k, v, h0): with `local`, q holds this rank's H/m heads h0, h0 + 1,
    ... (wq's column block, where 'model' divides H; else every head, h0
    = 0), and k, v the KV heads those read.  ``wkv`` stores all K heads,
    then all V heads, so its column block is not the rank's heads: its
    columns are gathered first (where 'model' splits wo's rows, the
    attention is rank-local work, and each rank's gradient of them covers
    the KV heads its q heads read, summed over the ranks by the gather's
    backward).  Where the heads a rank reads form whole GQA groups of one
    size the KV heads are taken once (``n_kv < m`` included: every q head
    of the rank in one group), else one a q head.  K and V come from
    `kv_src` where given (cross-attention: the encoder's output, no RoPE,
    `positions` None), else from x."""
    b, s, _ = x.shape
    dh, h, kv = cfg.dh, cfg.n_heads, cfg.n_kv
    wq = params["wq"]
    work = params["wo"].shape[0] != h * dh      # rank-local work
    if local and wq.shape[-1] != h * dh and h % ax.size == 0:
        hl = h // ax.size
        h0 = ax.rank * hl
        q = (x @ wq).reshape(b, s, hl, dh)
    else:
        h0, hl = 0, h
        q = PAR.project(x, wq, h * dh, ax, work).reshape(b, s, h, dh)
    src = x if kv_src is None else kv_src
    kvf = PAR.project(src, params["wkv"], 2 * kv * dh, ax, work).reshape(
        b, src.shape[1], 2 * kv, dh)
    idx = [(h0 + i) // (h // kv) for i in range(hl)]
    lo, hi = idx[0], idx[-1] + 1
    per = hl // (hi - lo)
    if hl % (hi - lo) == 0 and idx == [lo + i // per for i in range(hl)]:
        k, v = kvf[:, :, lo:hi], kvf[:, :, kv + lo:kv + hi]
    else:
        k, v = kvf[:, :, idx], kvf[:, :, [kv + i for i in idx]]
    if positions is not None:
        q, k = _norm_rope(params, q, k, cfg, positions)
    return q, k, v, h0


def _out_sharded(wo, o, cfg: BlockCfg, ax):
    """``o @ wo`` for o (B, S, width) holding heads from h0 = 0 (all of
    them) or this rank's heads: wo's row block is row parallel, its
    partial products summed over 'model'; a whole wo is replicated work."""
    full = cfg.n_heads * cfg.dh
    if wo.shape[0] == full:
        if o.shape[-1] != full:
            o = PAR.gather_dim(o, -1, ax.group, grad_group=None)
        return o @ wo
    rows = wo.shape[0]
    if o.shape[-1] == full:
        o = o[..., ax.rank * rows:(ax.rank + 1) * rows]
    return PAR.sum_over(o @ wo, ax.group)


def _entered(params, ax, names):
    """`params` with the leaves under `names`, whole on every rank, passed
    through ``enter_local``: rank-local work reads them, so each rank's
    gradient of them is partial."""
    out = dict(params)
    for k in names:
        v = out.get(k)
        if isinstance(v, dict):
            out[k] = {n: PAR.enter_local(t, ax.group) for n, t in v.items()}
        elif v is not None:
            out[k] = PAR.enter_local(v, ax.group)
    return out


def _attn_apply_sharded(params, x, cfg: BlockCfg, positions, causal,
                        use_fused, ax, kv_src=None):
    """Full-sequence attention on this rank's q heads (flash on H/m
    heads), then the row-parallel ``wo``: rank-local work from the
    entered x (and `kv_src`, the qk-norm scales, and a ``wkv`` that
    'model' does not split) to the sum.  Where 'model' does not split
    wo's rows (nor then wq's columns) every rank computes the whole
    attention.  With `kv_src` (whisper's cross-attention: the encoder's
    output) K and V come from it (``_qkv_sharded``)."""
    b, s, _ = x.shape
    local = params["wo"].shape[0] != cfg.n_heads * cfg.dh
    if local:
        x = PAR.enter_local(x, ax.group)
        if kv_src is not None:
            kv_src = PAR.enter_local(kv_src, ax.group)
        whole = ["q_norm", "k_norm"]
        if params["wkv"].shape[-1] == 2 * cfg.n_kv * cfg.dh:
            whole.append("wkv")
        params = _entered(params, ax, whole)
    q, k, v, _ = _qkv_sharded(params, x, cfg, positions, ax, local=True,
                              kv_src=kv_src)
    o = A.flash_attention(q, k, v, causal=causal, window=cfg.window,
                          use_fused=use_fused)
    return _out_sharded(params["wo"], o.reshape(b, s, -1), cfg, ax)


def _attn_decode_sharded(params, x1, cfg: BlockCfg, pos, kv_cache,
                         cache_len: int, ring: bool, start, kv_spec, ax):
    """One token against this rank's block of the cache (B, S, Hkv, dh)
    under `kv_spec`.  Every rank forms all q heads and the new token's K
    and V; the rank whose S block holds the slot writes them (its block of
    the heads and dh).  Each rank attends its S block with every q head
    (a block's KV heads or dh split over ranks are gathered first) and the
    ranks' partial softmaxes combine over the S axes (``combine_blocks``);
    then the row-parallel ``wo``."""
    mesh = SH.current_mesh()
    if kv_spec is None:
        raise ValueError("decode across a 'model' axis needs the cache's "
                         "spec (train/step.make_decode_step's cache_len)")
    q, k, v, _ = _qkv_sharded(params, x1, cfg, pos, ax, local=False)
    kc, vc = kv_cache
    coord = SH.coordinate(mesh)
    si, sn = SH.block_of(kv_spec[1], mesh, coord)
    sb = kc.shape[1]
    sc = sb * sn
    slot = cache_len % sc if ring else cache_len
    if slot >= sc:
        raise IndexError(f"decode slot {slot} past a cache of {sc} slots")
    if slot // sb == si:
        row = SH.P(None, kv_spec[2], kv_spec[3])
        kc[:, slot - si * sb] = SH.local_block(k[:, 0], row, mesh,
                                               coord).to(kc.dtype)
        vc[:, slot - si * sb] = SH.local_block(v[:, 0], row, mesh,
                                               coord).to(vc.dtype)
    kb, vb = kc, vc
    for d in (2, 3):
        axes = SH.norm_axes(kv_spec[d], mesh)
        if axes is not None:
            g = PAR.axis(mesh, axes).group
            kb, vb = PAR.gather_dim(kb, d, g), PAR.gather_dim(vb, d, g)
    s_axes = SH.norm_axes(kv_spec[1], mesh)
    if s_axes is None:
        o = A.decode_attention(q, kb, vb, cache_len + 1, window=cfg.window,
                               ring=ring, start=start)
    else:
        m, l, o = A.decode_attention_block(
            q, kb, vb, cache_len + 1, sc=sc, slot0=si * sb,
            window=cfg.window, ring=ring, start=start)
        o = A.combine_blocks(m, l, o, PAR.axis(mesh, s_axes).group, q.dtype)
    y = _out_sharded(params["wo"], o.reshape(x1.shape[0], 1, -1), cfg, ax)
    return y, (kc, vc)


def _ffn_apply_sharded(params, x, cfg: BlockCfg, ax, glu):
    """The FFN on this rank's blocks.  A dense FFN stacked with its layer
    axis over 'model' (``param_specs`` reads a stacked (L, D, F) w_gate as
    an expert tensor) comes as ``PAR.Owned``: the layer's owner computes
    it whole, the others add ``x · 0`` (an op on x, so every rank's
    backward meets the same collectives).  Column-parallel w_gate / w_up
    and row-parallel w_down sum their partial outputs over 'model'; the
    MoE FFN is ``moe_apply_sharded``'s; an FFN that 'model' does not
    split is replicated work.  `glu` is the gated unit (``ffn_apply``'s)
    on every path."""
    if isinstance(params, PAR.Owned):
        x = PAR.enter_local(x, ax.group)
        if params.mine:
            y = glu(params.tree, x)
        elif x.requires_grad and torch.is_grad_enabled():
            y = x * x.new_zeros(())
        else:
            y = torch.zeros_like(x)
        return PAR.sum_over(y, ax.group)
    if cfg.n_experts:
        b, s, d = x.shape
        y = M.moe_apply_sharded(params, x.reshape(b * s, d), ax,
                                n_experts=cfg.n_experts, d_ff=cfg.d_ff,
                                top_k=cfg.top_k)
        return y.reshape(b, s, d)
    if params["w_down"].shape[0] != cfg.d_ff:
        return PAR.sum_over(glu(params, PAR.enter_local(x, ax.group)),
                            ax.group)
    return glu(params, x)


# ---------------------------------------------------------------------------
# the decoder block
# ---------------------------------------------------------------------------
def block_init(key: torch.Tensor, cfg: BlockCfg, device):
    """The reference's ``block_init``: attention, FFN and (hymba) SSM from
    ``split(key, 3)``; hymba's mixing weights ``mix_a``, ``mix_s`` are
    0-d ones."""
    r = prng.split(key.to(device), 3)
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": attn_init(r[0], cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "ffn": ffn_init(r[1], cfg, device),
    }
    if cfg.ssm_state:                   # hymba: parallel SSM branch
        p["ssm"] = S.ssm_init(r[2], cfg.d_model, cfg.ssm_state, device=device)
        p["mix_a"] = torch.ones((), dtype=torch.float32, device=device)
        p["mix_s"] = torch.ones((), dtype=torch.float32, device=device)
    return p


def block_apply(params, x, cfg: BlockCfg, positions,
                use_fused: Optional[bool] = None):
    h = L.rmsnorm_apply(params["ln1"], x)
    mix = attn_apply(params["attn"], h, cfg, positions, use_fused=use_fused)
    if cfg.ssm_state:
        sm = S.ssm_apply(params["ssm"], h, use_fused=use_fused)
        mix = params["mix_a"] * mix + params["mix_s"] * sm
    x = x + mix
    h = L.rmsnorm_apply(params["ln2"], x)
    return x + ffn_apply(params["ffn"], h, cfg)


def block_decode(params, x1, cfg: BlockCfg, pos, state, *, ring: bool = False,
                 start=None, kv_spec=None):
    """state: {'kv': (k, v), 'len': int[, 'ssm': (h, tail)]}; returns (y1,
    new state), whose 'ssm' is the new (h, tail) (the caller writes it
    back; the KV cache is written in place).  `kv_spec`: the cache's spec
    across a 'model' axis (``attn_decode``)."""
    h = L.rmsnorm_apply(params["ln1"], x1)
    mix, kv = attn_decode(params["attn"], h, cfg, pos, state["kv"],
                          state["len"], ring=ring, start=start,
                          kv_spec=kv_spec)
    new_state = dict(state, kv=kv, len=state["len"] + 1)
    if cfg.ssm_state:
        sm, new_state["ssm"] = S.ssm_decode_step(params["ssm"], h,
                                                 state["ssm"])
        mix = params["mix_a"] * mix + params["mix_s"] * sm
    x1 = x1 + mix
    h = L.rmsnorm_apply(params["ln2"], x1)
    return x1 + ffn_apply(params["ffn"], h, cfg), new_state


# ---------------------------------------------------------------------------
# whisper's encoder and decoder blocks: pre-LN, a GEGLU FFN; the absolute
# positions are the model's, the attention still applies RoPE as the
# reference's does; the encoder's attention is non-causal, the decoder
# adds cross-attention over the encoder's output
# ---------------------------------------------------------------------------
def _geglu(params, h):
    """``gelu(h·w_gate) ⊙ (h·w_up) · w_down`` with ``jax.nn.gelu``'s
    default, the tanh approximation (torch's default, the erf form, lands
    up to ~5e-4 away)."""
    g = torch.nn.functional.gelu(h @ params["w_gate"], approximate="tanh")
    return (g * (h @ params["w_up"])) @ params["w_down"]


def enc_block_init(key: torch.Tensor, cfg: BlockCfg, device):
    """Attention and FFN from ``split(key, 2)``."""
    r = prng.split(key.to(device), 2)
    return {
        "ln1": L.layernorm_init(cfg.d_model, device),
        "attn": attn_init(r[0], cfg, device),
        "ln2": L.layernorm_init(cfg.d_model, device),
        "ffn": ffn_init(r[1], cfg, device),
    }


def enc_block_apply(params, x, cfg: BlockCfg, positions,
                    use_fused: Optional[bool] = None):
    h = L.layernorm_apply(params["ln1"], x)
    x = x + attn_apply(params["attn"], h, cfg, positions, causal=False,
                       use_fused=use_fused)
    h = L.layernorm_apply(params["ln2"], x)
    return x + ffn_apply(params["ffn"], h, cfg, glu=_geglu)


def dec_block_init(key: torch.Tensor, cfg: BlockCfg, device):
    """Self-attention, cross-attention and FFN from ``split(key, 3)``."""
    r = prng.split(key.to(device), 3)
    return {
        "ln1": L.layernorm_init(cfg.d_model, device),
        "self_attn": attn_init(r[0], cfg, device),
        "ln_x": L.layernorm_init(cfg.d_model, device),
        "cross_attn": attn_init(r[1], cfg, device),
        "ln2": L.layernorm_init(cfg.d_model, device),
        "ffn": ffn_init(r[2], cfg, device),
    }


def _cross_attn(params, x, enc_out, cfg: BlockCfg,
                use_fused: Optional[bool] = None):
    """q from x (B, S, D), k and v from ``enc_out @ wkv`` (B, S_enc, D);
    no RoPE, no mask.  Across a 'model' axis on this rank's blocks
    (``_attn_apply_sharded`` with the encoder's output as `kv_src`).
    With no encoder output it raises, as the reference's (whose
    ``Engine`` passes none: ROADMAP Queue 3 item 7)."""
    if enc_out is None:
        raise ValueError("whisper's cross-attention needs the encoder's "
                         "output (enc_out)")
    ax = PAR.model_axis()
    if ax is not None:
        return _attn_apply_sharded(params, x, cfg, None, False, use_fused,
                                   ax, kv_src=enc_out)
    b, s, _ = x.shape
    dh = cfg.dh
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, dh)
    se = enc_out.shape[1]
    kv = (enc_out @ params["wkv"]).reshape(b, se, 2 * cfg.n_kv, dh)
    k, v = kv[:, :, : cfg.n_kv], kv[:, :, cfg.n_kv:]
    o = A.flash_attention(q, k, v, causal=False, use_fused=use_fused)
    return o.reshape(b, s, -1) @ params["wo"]


def dec_block_apply(params, x, enc_out, cfg: BlockCfg, positions,
                    use_fused: Optional[bool] = None):
    h = L.layernorm_apply(params["ln1"], x)
    x = x + attn_apply(params["self_attn"], h, cfg, positions, causal=True,
                       use_fused=use_fused)
    h = L.layernorm_apply(params["ln_x"], x)
    x = x + _cross_attn(params["cross_attn"], h, enc_out, cfg,
                        use_fused=use_fused)
    h = L.layernorm_apply(params["ln2"], x)
    return x + ffn_apply(params["ffn"], h, cfg, glu=_geglu)


def dec_block_decode(params, x1, enc_out, cfg: BlockCfg, pos, state,
                     start=None, kv_spec=None):
    """One token: self-attention against the KV cache (written in place),
    then cross-attention over all of ``enc_out``, whose K and V are
    recomputed every step as the reference's are.  `kv_spec`: the cache's
    spec across a 'model' axis (``attn_decode``)."""
    h = L.layernorm_apply(params["ln1"], x1)
    mix, kv = attn_decode(params["self_attn"], h, cfg, pos, state["kv"],
                          state["len"], start=start, kv_spec=kv_spec)
    x1 = x1 + mix
    h = L.layernorm_apply(params["ln_x"], x1)
    x1 = x1 + _cross_attn(params["cross_attn"], h, enc_out, cfg)
    h = L.layernorm_apply(params["ln2"], x1)
    return (x1 + ffn_apply(params["ffn"], h, cfg, glu=_geglu),
            dict(state, kv=kv, len=state["len"] + 1))
