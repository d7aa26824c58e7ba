"""Helpers that assemble ModelCfg objects: the dense and MoE decoders
(uniform), gemma3's local:global interleave, hymba's global-sandwich
layout, xLSTM's periodic mLSTM:sLSTM stack and whisper's
encoder-decoder."""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.models.base import LayerSpec, ModelCfg, Segment
from repro_torch.nn.blocks import BlockCfg


def _dense_spec(d, h, kv, dff, *, head_dim=0, qk_norm=False, window=None,
                theta=10000.0, n_experts=0, top_k=2, ssm_state=0, mrope=None):
    return LayerSpec(
        "dense",
        BlockCfg(d_model=d, n_heads=h, n_kv=kv, d_ff=dff, head_dim=head_dim,
                 qk_norm=qk_norm, window=window, rope_theta=theta,
                 n_experts=n_experts, top_k=top_k, ssm_state=ssm_state,
                 mrope_sections=mrope),
    )


def decoder_arch(
    name: str, family: str, n_layers: int, d_model: int, n_heads: int,
    n_kv: int, d_ff: int, vocab: int, *,
    head_dim: int = 0, qk_norm: bool = False, window: Optional[int] = None,
    n_experts: int = 0, top_k: int = 2, ssm_state: int = 0,
    mrope: Optional[Tuple[int, int, int]] = None, tied: bool = True,
    theta: float = 10000.0, sub_quadratic: bool = False, notes: str = "",
) -> ModelCfg:
    spec = _dense_spec(d_model, n_heads, n_kv, d_ff, head_dim=head_dim,
                       qk_norm=qk_norm, window=window, theta=theta,
                       n_experts=n_experts, top_k=top_k, ssm_state=ssm_state,
                       mrope=mrope)
    return ModelCfg(name=name, family=family, d_model=d_model, vocab=vocab,
                    segments=(Segment(n_layers, (spec,)),),
                    tied_embeddings=tied, sub_quadratic=sub_quadratic,
                    notes=notes)


def local_global_arch(
    name: str, family: str, n_layers: int, d_model: int, n_heads: int,
    n_kv: int, d_ff: int, vocab: int, *, head_dim: int = 0,
    local_window: int = 1024, locals_per_global: int = 5,
    tied: bool = True, theta: float = 10000.0, notes: str = "",
) -> ModelCfg:
    """Gemma-3 style L:1 local:global interleave; tail layers stay local."""
    loc = _dense_spec(d_model, n_heads, n_kv, d_ff, head_dim=head_dim,
                      window=local_window, theta=theta)
    glob = _dense_spec(d_model, n_heads, n_kv, d_ff, head_dim=head_dim,
                       window=None, theta=theta)
    period = locals_per_global + 1
    reps, tail = divmod(n_layers, period)
    segs = [Segment(reps, tuple([loc] * locals_per_global + [glob]))]
    if tail:
        segs.append(Segment(tail, (loc,)))
    return ModelCfg(name=name, family=family, d_model=d_model, vocab=vocab,
                    segments=tuple(segs), tied_embeddings=tied,
                    sub_quadratic=True, notes=notes)


def sandwich_arch(
    name: str, family: str, n_layers: int, d_model: int, n_heads: int,
    n_kv: int, d_ff: int, vocab: int, *, head_dim: int = 0,
    local_window: int = 1024, ssm_state: int = 16, n_globals: int = 3,
    tied: bool = True, notes: str = "",
) -> ModelCfg:
    """Hymba-style: global full-attn at first/middle/last layers, sliding-
    window everywhere else; every layer has the parallel SSM branch.  The
    reference's five segments, in its order."""
    loc = _dense_spec(d_model, n_heads, n_kv, d_ff, head_dim=head_dim,
                      window=local_window, ssm_state=ssm_state)
    glob = _dense_spec(d_model, n_heads, n_kv, d_ff, head_dim=head_dim,
                       window=None, ssm_state=ssm_state)
    mid = n_layers - n_globals
    first = mid // 2
    segs = (
        Segment(1, (glob,)),
        Segment(first, (loc,)),
        Segment(1, (glob,)),
        Segment(mid - first, (loc,)),
        Segment(1, (glob,)),
    )
    assert sum(s.n_layers for s in segs) == n_layers
    return ModelCfg(name=name, family=family, d_model=d_model, vocab=vocab,
                    segments=segs, tied_embeddings=tied, sub_quadratic=True,
                    notes=notes)


def xlstm_arch(
    name: str, n_layers: int, d_model: int, n_heads: int, vocab: int, *,
    slstm_every: int = 8, tied: bool = True, notes: str = "",
) -> ModelCfg:
    """mLSTM:sLSTM = (slstm_every-1):1 periodic stack (d_ff = 0: the blocks
    carry their own projections)."""
    cfg = BlockCfg(d_model=d_model, n_heads=n_heads, n_kv=n_heads, d_ff=0)
    m = LayerSpec("mlstm", cfg)
    s = LayerSpec("slstm", cfg)
    reps, tail = divmod(n_layers, slstm_every)
    segs = [Segment(reps, tuple([m] * (slstm_every - 1) + [s]))]
    if tail:
        segs.append(Segment(tail, (m,)))
    return ModelCfg(name=name, family="ssm", d_model=d_model, vocab=vocab,
                    segments=tuple(segs), tied_embeddings=tied,
                    sub_quadratic=True, notes=notes)


def encdec_arch(
    name: str, n_enc: int, n_dec: int, d_model: int, n_heads: int,
    n_kv: int, d_ff: int, vocab: int, *, max_enc_len: int = 1500,
    tied: bool = True, notes: str = "",
) -> ModelCfg:
    """Whisper-style encoder-decoder.  The conv audio front end is a STUB:
    the model takes precomputed frame embeddings (B, S_enc, D)."""
    enc = LayerSpec("enc", BlockCfg(d_model=d_model, n_heads=n_heads,
                                    n_kv=n_kv, d_ff=d_ff))
    dec = LayerSpec("dec", BlockCfg(d_model=d_model, n_heads=n_heads,
                                    n_kv=n_kv, d_ff=d_ff))
    return ModelCfg(name=name, family="audio", d_model=d_model, vocab=vocab,
                    segments=(Segment(n_dec, (dec,)),),
                    enc_segments=(Segment(n_enc, (enc,)),),
                    max_enc_len=max_enc_len, tied_embeddings=tied,
                    notes=notes)
