"""The unified LM builder: a model is a stack of *segments*, each segment
`repeats` copies of a short periodic *layer pattern* (a tuple of
LayerSpecs), with params stacked per spec along a leading (repeats, ...)
axis as in the reference.

  * uniform archs (qwen3, stablelm, deepseek; mixtral and phi3.5-moe, whose
    "dense" spec carries ``n_experts``): one segment, pattern length 1
  * gemma3 (5 local : 1 global): pattern [local x5, global], repeats 4,
    plus a tail segment of 2 local layers
  * hymba (``ssm_state``: every block has the parallel SSM branch): five
    segments of pattern length 1, global layers first, middle and last
  * xlstm (mLSTM:sLSTM 7:1): pattern [mlstm x7, slstm], repeats 6
  * whisper: one decoder segment of ``"dec"`` blocks and, in
    ``enc_segments``, one encoder segment of ``"enc"`` blocks

The reference scans over repeats (``lax.scan``); here a Python loop runs
the layers in the same order, taking a segment's layers from its stacks
with one ``unbind(0)`` per leaf, so under autograd each stack's gradient
is assembled once (indexing ``a[r]`` per layer would allocate a zero
stack per layer in the backward).  ``forward(..., remat=True)`` runs each
repeat of the pattern under ``torch.utils.checkpoint`` (non-reentrant),
as the reference's ``jax.checkpoint`` does its scan body.  The kinds
``"dense"`` (with its SwiGLU or MoE FFN and its optional SSM branch),
``"mlstm"`` and ``"slstm"`` (``nn/xlstm``), and whisper's ``"enc"`` and
``"dec"`` are ported.  ``encode`` runs the encoder over precomputed frame
embeddings; ``forward`` and ``decode_step`` take its output as
``enc_out``, which every ``"dec"`` layer attends to.

``init_params(key, m, device)`` draws the reference's initial weights
bit for bit from a threefry key (``core/prng``): the same splits and
fold-ins, the same draws.

Decode states mirror the param stacks: per segment and spec, for a
dense or whisper decoder block ``{"kv": (k, v), "len": int[, "ssm": (h,
tail)]}`` with k, v (repeats, B, span, Hkv, dh), h (repeats, B, Di, N),
tail (repeats, B, K-1, Di) and the shared count of cached tokens (a
whisper decoder keeps no cache of the encoder's K and V: each step
recomputes them, as the reference does); for an xLSTM block the
reference's tuple, stacked: the mLSTM's (C, n, m) and the sLSTM's (c, n,
m, h).  Decode writes the caches and the recurrent states in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core import prng
from repro_torch.nn import blocks as B
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as S
from repro_torch.nn import xlstm as X
from repro_torch.optim import tree_leaves, tree_map, tree_unflatten
from repro_torch.train import parallel as PAR
from repro_torch.train import shardings as SH


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """kind: dense | mlstm | slstm | enc | dec (cfg.n_experts / ssm_state
    select MoE / hymba inside the dense block)."""

    kind: str
    cfg: B.BlockCfg


@dataclasses.dataclass(frozen=True)
class Segment:
    repeats: int
    pattern: Tuple[LayerSpec, ...]

    @property
    def n_layers(self) -> int:
        return self.repeats * len(self.pattern)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                        # dense | moe | vlm | audio | ssm | hybrid
    d_model: int
    vocab: int
    segments: Tuple[Segment, ...]
    tied_embeddings: bool = True
    # enc-dec (whisper): encoder segments; None for decoder-only models
    enc_segments: Optional[Tuple[Segment, ...]] = None
    enc_positions: str = "learned"     # whisper uses learned/sinusoidal abs pos
    max_enc_len: int = 1500
    sub_quadratic: bool = False        # eligible for long_500k
    notes: str = ""

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)


# ---------------------------------------------------------------------------
# per-spec init/apply/decode dispatch
# ---------------------------------------------------------------------------
#: the layer kinds whose decode state is a recurrent tuple, not a dict
RECURRENT = ("mlstm", "slstm")


def spec_init(key: torch.Tensor, spec: LayerSpec, device):
    cfg = spec.cfg
    if spec.kind == "dense":
        return B.block_init(key, cfg, device)
    if spec.kind == "mlstm":
        return X.mlstm_init(key, cfg.d_model, cfg.n_heads, device)
    if spec.kind == "slstm":
        return X.slstm_init(key, cfg.d_model, cfg.n_heads, device)
    if spec.kind == "enc":
        return B.enc_block_init(key, cfg, device)
    if spec.kind == "dec":
        return B.dec_block_init(key, cfg, device)
    raise ValueError(spec.kind)


def spec_apply(params, x, spec: LayerSpec, positions,
               use_fused: Optional[bool] = None, enc_out=None):
    """One layer over the sequence (a ``"dec"`` layer also attends to
    `enc_out`); ``use_fused=False`` takes the plain attention, scan and
    sLSTM loop (the mLSTM has no kernel)."""
    if spec.kind == "dense":
        return B.block_apply(params, x, spec.cfg, positions,
                             use_fused=use_fused)
    if spec.kind == "mlstm":
        y, _ = X.mlstm_apply(params, x, spec.cfg.n_heads)
        return x + y
    if spec.kind == "slstm":
        y, _ = X.slstm_apply(params, x, spec.cfg.n_heads,
                             use_fused=use_fused)
        return x + y
    if spec.kind == "enc":
        return B.enc_block_apply(params, x, spec.cfg, positions,
                                 use_fused=use_fused)
    if spec.kind == "dec":
        return B.dec_block_apply(params, x, enc_out, spec.cfg, positions,
                                 use_fused=use_fused)
    raise ValueError(spec.kind)


def spec_state_init(spec: LayerSpec, batch: int, cache_len: int,
                    device) -> Any:
    """Decode state of one layer: for a dense block or a whisper decoder
    block its KV cache (a ring of the window's width for sliding-window
    layers), the count of cached
    tokens, and for hymba's blocks an ``ssm`` entry, None here:
    `init_decode_state` sizes it from the params; for an xLSTM block its
    recurrent tuple (the reference's initial values)."""
    cfg = spec.cfg
    if spec.kind in ("dense", "dec"):
        span = cache_len if cfg.window is None else min(cfg.window, cache_len)
        kv = tuple(torch.zeros((batch, span, cfg.n_kv, cfg.dh),
                               dtype=torch.float32, device=device)
                   for _ in range(2))
        st = {"kv": kv, "len": 0}
        if cfg.ssm_state:
            st["ssm"] = None
        return st
    if spec.kind == "mlstm":
        return X.mlstm_state_init(batch, cfg.n_heads,
                                  cfg.d_model // cfg.n_heads, device)
    if spec.kind == "slstm":
        return X.slstm_state_init(batch, cfg.d_model, device)
    raise ValueError(spec.kind)


def spec_decode(params, x1, spec: LayerSpec, pos, state, enc_out=None,
                start=None, kv_spec=None):
    """One token through one layer -> (x1, its new state): a dense or
    whisper decoder block's dict (the latter attends to `enc_out`), an
    xLSTM block's tuple (the mLSTM's stepwise cell; the sLSTM's kernel at
    S = 1 on the card).  `kv_spec`: a KV cache's spec across a 'model'
    axis (``nn/blocks.attn_decode``)."""
    cfg = spec.cfg
    if spec.kind == "dense":
        return B.block_decode(params, x1, cfg, pos, state,
                              ring=cfg.window is not None, start=start,
                              kv_spec=kv_spec)
    if spec.kind == "dec":
        return B.dec_block_decode(params, x1, enc_out, cfg, pos, state,
                                  start=start, kv_spec=kv_spec)
    if spec.kind == "mlstm":
        y, st = X.mlstm_apply(params, x1, cfg.n_heads, state=state)
        return x1 + y, st
    if spec.kind == "slstm":
        y, st = X.slstm_apply(params, x1, cfg.n_heads, state=state)
        return x1 + y, st
    raise ValueError(spec.kind)


# ---------------------------------------------------------------------------
# whole-model init / forward / decode
# ---------------------------------------------------------------------------
def _layer(tree, r: int):
    """Layer r of a (repeats, ...) stacked tree (views, no copy)."""
    return tree_map(lambda a: a[r], tree)


def _segment_init(key: torch.Tensor, seg: Segment, device):
    """Per-spec stacked params: list over pattern of (repeats, ...) stacks;
    spec si's repeat r is drawn from ``fold_in(key, si * 10007 + r)``."""
    out = []
    for si, spec in enumerate(seg.pattern):
        reps = [spec_init(prng.fold_in(key, si * 10007 + r), spec, device)
                for r in range(seg.repeats)]
        out.append(tree_map(lambda *xs: torch.stack(xs), *reps))
    return out


def init_params(key: torch.Tensor, m: ModelCfg, device) -> Dict[str, Any]:
    """The reference's ``init_params(key, m)`` bit for bit, as float32
    params on `device`: `key` a (2,) int64 threefry key
    (``prng.prng_key(torch.tensor(seed))``) split four ways (embed, body,
    head, encoder); segment i draws from ``fold_in(body, i)``, an untied
    ``lm_head`` from the head key; whisper's ``encoder`` its segment i
    from ``fold_in(encoder, i)`` and its ``pos_embed`` (max_enc_len, D)
    from ``fold_in(encoder, 999)``, x 0.02.  The draws run as eager torch
    on `device` (``core/prng``)."""
    r_embed, r_body, r_head, r_enc = prng.split(key.to(device), 4)
    p: Dict[str, Any] = {
        "embed": L.embed_init(r_embed, m.vocab, m.d_model, device),
        "segments": [_segment_init(prng.fold_in(r_body, i), seg, device)
                     for i, seg in enumerate(m.segments)],
        "ln_f": L.rmsnorm_init(m.d_model, device),
    }
    if not m.tied_embeddings:
        p["lm_head"] = prng.normal_scaled(r_head, (m.d_model, m.vocab),
                                          (1.0 / m.d_model) ** 0.5, device)
    if m.enc_segments is not None:
        p["encoder"] = {
            "segments": [_segment_init(prng.fold_in(r_enc, i), seg, device)
                         for i, seg in enumerate(m.enc_segments)],
            "pos_embed": prng.normal_scaled(prng.fold_in(r_enc, 999),
                                            (m.max_enc_len, m.d_model), 0.02,
                                            device),
            "ln_f": L.layernorm_init(m.d_model, device),
        }
    return p


def _unstacked(tree) -> list:
    """The layers of a (repeats, ...) stacked tree, each leaf split by one
    ``unbind(0)``."""
    parts = [a.unbind(0) for a in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[r] for p in parts])
            for r in range(len(parts[0]))]


def _run_segments(segments_params, segs: Tuple[Segment, ...], x, positions,
                  use_fused: Optional[bool] = None, remat: bool = False,
                  enc_out=None):
    for seg_p, seg in zip(segments_params, segs):
        def body(xc, layer_params, enc, _seg=seg):
            for spec, sp in zip(_seg.pattern, layer_params):
                xc = spec_apply(sp, xc, spec, positions, use_fused=use_fused,
                                enc_out=enc)
            return xc

        per_spec = [_unstacked(sp) for sp in seg_p]
        for r in range(seg.repeats):
            layer_params = [layers[r] for layers in per_spec]
            if remat:
                x = checkpoint(body, x, layer_params, enc_out,
                               use_reentrant=False)
            else:
                x = body(x, layer_params, enc_out)
    return x


def _head(params, m: ModelCfg, x):
    x = L.rmsnorm_apply(params["ln_f"], x)
    if m.tied_embeddings:
        return L.embed_logits(params["embed"], x)
    return x @ params["lm_head"]


def encode(params, m: ModelCfg, frames: torch.Tensor, remat: bool = False,
           use_fused: Optional[bool] = None) -> torch.Tensor:
    """Whisper's encoder over precomputed (stub) frame embeddings (B,
    S_enc, D): ``pos_embed`` added (tiled cyclically when S_enc exceeds
    ``max_enc_len``), the encoder segments at positions 0..S_enc-1 (their
    attention applies RoPE too, as the reference's does), then the
    encoder's LayerNorm ``ln_f``.  Across a 'model' axis on this rank's
    blocks (``_encode_sharded``)."""
    ax = PAR.model_axis()
    if ax is not None:
        return _encode_sharded(params, m, frames, remat, use_fused, ax)
    enc = params["encoder"]
    se = frames.shape[1]
    pos_tab = enc["pos_embed"]
    if se > pos_tab.shape[0]:          # extend cyclically for oversize stubs
        pos_tab = pos_tab.repeat(-(-se // pos_tab.shape[0]), 1)
    x = frames + pos_tab[None, :se]
    positions = torch.arange(se, device=frames.device)[None].expand(
        frames.shape[:2])
    x = _run_segments(enc["segments"], m.enc_segments, x, positions,
                      use_fused=use_fused, remat=remat)
    return L.layernorm_apply(enc["ln_f"], x)


def forward(params, m: ModelCfg, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            use_fused: Optional[bool] = None,
            remat: bool = False,
            enc_out: Optional[torch.Tensor] = None,
            last_only: bool = False,
            vocab_block: bool = False) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V).  positions defaults to arange.
    ``use_fused=False`` takes the plain attention instead of the kernel;
    ``remat=True`` recomputes each repeat of a segment's pattern in the
    backward instead of keeping its activations.  An encoder-decoder's
    decoder layers attend to `enc_out` (``encode``'s output).

    ``last_only`` takes the last position alone through the head: (B, 1,
    V).  Under a mesh with a 'model' axis larger than 1
    (``shardings.use_mesh``) `params` are this rank's blocks
    (``shardings.shard_params``) and the forward is
    ``_forward_sharded``'s; with `vocab_block` there the logits are this
    rank's block of the vocab where 'model' splits the head's (rank r's
    Vr columns from r·Vr, for ``train/step``'s vocab-parallel loss), not
    gathered."""
    ax = PAR.model_axis()
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[
            None].expand(tokens.shape)
    if ax is not None:
        return _forward_sharded(params, m, tokens, positions, use_fused, ax,
                                last_only, remat=remat,
                                vocab_block=vocab_block, enc_out=enc_out)
    x = L.embed_apply(params["embed"], tokens)
    x = _run_segments(params["segments"], m.segments, x, positions,
                      use_fused=use_fused, remat=remat, enc_out=enc_out)
    return _head(params, m, x[:, -1:] if last_only else x)


# ---------------------------------------------------------------------------
# across a 'model' axis (serving and training): this rank's blocks,
# explicit collectives under autograd (``train/parallel``)
# ---------------------------------------------------------------------------
def _sharded_layers(seg_p, seg_specs, seg: Segment, ax) -> list:
    """The layers of a segment from this rank's stacks, one list a repeat
    of one tree a pattern spec, each stack split by one ``unbind(0)``
    (the FSDP dims not yet gathered).  A dense FFN whose stacks put the
    layer axis on 'model' comes as ``PAR.Owned``: layer r lies on the
    rank r // (L/m)."""
    mesh = SH.current_mesh()
    per_spec = []
    for sp, spec in zip(seg_p, seg_specs):
        trees = {}
        for k, v in sp.items():
            on_model = (k == "ffn" and SH.norm_axes(
                spec["ffn"]["w_gate"][0], mesh) is not None)
            layers = _unstacked(v)
            if on_model:
                n = len(layers)
                layers = [PAR.Owned(layers[r % n], True) if r // n == ax.rank
                          else PAR.Owned(None, False)
                          for r in range(seg.repeats)]
            trees[k] = layers
        per_spec.append([{k: trees[k][r] for k in trees}
                         for r in range(seg.repeats)])
    return [[layers[r] for layers in per_spec] for r in range(seg.repeats)]


def _save_dim(x, ax):
    """The dim of the residual stream (B, S, D) that an ``act_shard``
    save point keeps this rank's block of: D under 'model', S under
    'seq', where 'model' divides it; None keeps it whole."""
    policy = SH.current_act_shard()
    if policy == "model" and x.shape[-1] % ax.size == 0:
        return x.dim() - 1
    if policy == "seq" and x.shape[1] % ax.size == 0:
        return 1
    return None


def _sharded_body(x, layers, seg: Segment, seg_specs, positions, use_fused,
                  ax, saved_dim, enc_out=None):
    """One repeat of a segment's pattern on this rank's blocks: the
    residual stream gathered back where its save point kept a block, each
    layer's FSDP dims gathered just before it (a ``"dec"`` layer also
    attends to `enc_out`)."""
    if saved_dim is not None:
        x = PAR.gather_dim(x, saved_dim, ax.group, grad_group=None)
    for spec, lp, ls in zip(seg.pattern, layers, seg_specs):
        lp = PAR.unshard_data(lp, PAR.drop_layer_axis(ls))
        x = spec_apply(lp, x, spec, positions, use_fused=use_fused,
                       enc_out=enc_out)
    return x


def _run_sharded(segments_params, segments_specs, segs, x, positions,
                 use_fused, ax, remat: bool, enc_out=None):
    """The segments on this rank's blocks.  ``remat`` runs each repeat of
    a segment's pattern under ``torch.utils.checkpoint``, the layers'
    FSDP gathers and collectives inside it (the recompute issues them
    again), its save point keeping the residual stream by ``use_mesh``'s
    ``act_shard`` (``_save_dim``)."""
    for seg_p, seg_s, seg in zip(segments_params, segments_specs, segs):
        for layers in _sharded_layers(seg_p, seg_s, seg, ax):
            if remat:
                dim = _save_dim(x, ax)
                if dim is not None:
                    x = PAR.keep_block(x, dim, ax.group)
                # the whole body again at the recompute, so every rank
                # issues its collectives
                with set_checkpoint_early_stop(False):
                    x = checkpoint(_sharded_body, x, layers, seg, seg_s,
                                   positions, use_fused, ax, dim, enc_out,
                                   use_reentrant=False)
            else:
                x = _sharded_body(x, layers, seg, seg_s, positions,
                                  use_fused, ax, None, enc_out)
    return x


def _embed_sharded(emb, m: ModelCfg, tokens, ax):
    if emb["table"].shape[0] != m.vocab:
        return L.embed_apply_vocab_parallel(emb, tokens, ax)
    return L.embed_apply(emb, tokens)


def _head_sharded(params, specs, emb, m: ModelCfg, x, ax,
                  vocab_block: bool = False):
    """The logits from this rank's vocab block (the tied table's rows or
    ``lm_head``'s columns): rank-local work from the entered x, gathered
    over 'model' to (.., V) on every rank, or with `vocab_block` left as
    the rank's block.  A head that 'model' does not split is replicated
    work."""
    x = L.rmsnorm_apply(params["ln_f"], x)
    w = emb["table"] if m.tied_embeddings else PAR.unshard_data(
        params["lm_head"], specs["lm_head"])
    split = w.shape[0 if m.tied_embeddings else -1] != m.vocab
    if split:
        x = PAR.enter_local(x, ax.group)
    logits = x @ (w.t() if m.tied_embeddings else w)
    if split and not vocab_block:
        logits = PAR.gather_dim(logits, -1, ax.group, grad_group=None)
    return logits


def _forward_sharded(params, m: ModelCfg, tokens, positions, use_fused, ax,
                     last_only: bool, remat: bool = False,
                     vocab_block: bool = False, enc_out=None):
    """``forward`` across a 'model' axis: the vocab-parallel embedding,
    each layer on this rank's blocks (``nn/blocks``' sharded attention,
    FFN, MoE and SSM, ``nn/xlstm``'s mLSTM and sLSTM; a ``"dec"`` layer
    attends to `enc_out`), the head's logits gathered over 'model' (or
    this rank's vocab block, `vocab_block`).  The residual stream is
    replicated over 'model' at every layer boundary.  ``remat`` as
    ``_run_sharded``'s: the save point keeps this rank's D/m slice under
    'model', its S/m slice under 'seq' (where 'model' divides them), the
    whole under 'none', gathered again at the recompute (the reference's
    ``activation_spec``)."""
    specs = PAR.current_layout(m)
    emb = PAR.unshard_data(params["embed"], specs["embed"])
    x = _embed_sharded(emb, m, tokens, ax)
    x = _run_sharded(params["segments"], specs["segments"], m.segments, x,
                     positions, use_fused, ax, remat, enc_out)
    if last_only:
        x = x[:, -1:]
    return _head_sharded(params, specs, emb, m, x, ax, vocab_block)


def _encode_sharded(params, m: ModelCfg, frames, remat: bool, use_fused,
                    ax):
    """``encode`` across a 'model' axis: ``pos_embed``'s row blocks
    gathered (replicated work: the gather's gradient only cut), the
    encoder segments on this rank's blocks under the same remat and
    save points as the decoder's (``_run_sharded``), then ``ln_f``."""
    specs = PAR.current_layout(m)["encoder"]
    enc = params["encoder"]
    pos_tab = PAR.unshard_data(enc["pos_embed"], specs["pos_embed"])
    if pos_tab.shape[0] != m.max_enc_len:
        pos_tab = PAR.gather_dim(pos_tab, 0, ax.group, grad_group=None)
    se = frames.shape[1]
    if se > pos_tab.shape[0]:          # extend cyclically for oversize stubs
        pos_tab = pos_tab.repeat(-(-se // pos_tab.shape[0]), 1)
    x = frames + pos_tab[None, :se]
    positions = torch.arange(se, device=frames.device)[None].expand(
        frames.shape[:2])
    x = _run_sharded(enc["segments"], specs["segments"], m.enc_segments, x,
                     positions, use_fused, ax, remat)
    return L.layernorm_apply(PAR.unshard_data(enc["ln_f"], specs["ln_f"]), x)


def _decode_sharded(params, m: ModelCfg, token, pos_b, states, start,
                    state_specs, ax, enc_out=None):
    """``decode_step`` across a 'model' axis on this rank's lanes and
    blocks: each layer's cache block under its ``state_spec`` (S over
    'model': the ranks combine their partial softmaxes), hymba's SSM
    state and the xLSTM states the blocks of their specs (``nn/ssm``,
    ``nn/xlstm``; ``_step_layout`` where a batch axis splits them), a
    whisper decoder layer attending to `enc_out`."""
    if state_specs is None:
        raise ValueError("decode across a 'model' axis needs the states' "
                         "specs (train/step.make_decode_step's cache_len)")
    mesh = SH.current_mesh()
    specs = PAR.current_layout(m)
    emb = PAR.unshard_data(params["embed"], specs["embed"])
    x = _embed_sharded(emb, m, token, ax)
    new_states = []
    for seg_p, seg_s, seg, seg_st, seg_ss in zip(
            params["segments"], specs["segments"], m.segments, states,
            state_specs):
        work, moved = _step_layout(seg_st, seg_ss, seg, mesh)
        for r, layers in enumerate(_sharded_layers(seg_p, seg_s, seg, ax)):
            for spec, lp, ls, st, ss in zip(seg.pattern, layers, seg_s,
                                            work, seg_ss):
                lp = PAR.unshard_data(lp, PAR.drop_layer_axis(ls))
                kv_spec = (None if spec.kind in RECURRENT
                           else SH.P(*ss["kv"][0][1:]))
                x = _decode_layer(lp, x, spec, pos_b, st, r, enc_out, start,
                                  kv_spec)
        for stored, have, t, want in moved:
            stored.copy_(PAR.relayout(t, want, have, mesh))
        new_states.append(_advanced(seg_st, seg))
    return _head_sharded(params, specs, emb, m, x, ax), new_states


def _step_layout(seg_st, seg_ss, seg: Segment, mesh) -> tuple:
    """A segment's states in the layout its layers step on, and the
    leaves moved there.  A recurrent state (an xLSTM tuple, hymba's SSM
    state) steps on 'model' blocks alone (``nn/ssm``, ``nn/xlstm``); where
    the batch does not divide over the batch axes, ``state_spec`` puts
    'data' on a non-batch dim of 1024 or more, so such a leaf is moved
    (``parallel.relayout``: that dim gathered over 'data') to the spec
    ``state_spec`` gives it with the batch axes left out, and each moved
    leaf is returned as (the stored block, its spec, the moved block, its
    spec) for this rank's block of the new state to be written back."""
    batch = set(SH.batch_axes(mesh))
    steps = {a: (1 if a in batch else n)
             for a, n in SH.mesh_sizes(mesh).items()}
    moved = []

    def move(t, have):
        if not any(batch & set(SH.norm_axes(e, mesh) or ())
                   for e in have[2:]):
            return t
        full = tuple(n * SH.axis_size(mesh, SH.norm_axes(e, mesh) or ())
                     for n, e in zip(t.shape, have))
        want = SH.state_spec(full, SH.Sizes(steps), full[1])
        out = PAR.relayout(t, have, want, mesh)
        moved.append((t, have, out, want))
        return out

    work = []
    for st, ss, spec in zip(seg_st, seg_ss, seg.pattern):
        if spec.kind in RECURRENT:
            st = tuple(move(t, h) for t, h in zip(st, ss))
        elif st.get("ssm") is not None:
            st = dict(st, ssm=tuple(move(t, h)
                                    for t, h in zip(st["ssm"], ss["ssm"])))
        work.append(st)
    return work, moved


def _decode_layer(lp, x, spec: LayerSpec, pos_b, st, r: int, enc_out, start,
                  kv_spec=None):
    """Layer r of a segment's spec decodes one token from its views of
    the stacked state `st`, written back in place (an xLSTM layer's new
    tuple, hymba's new (h, tail); the KV cache is written by the layer)."""
    if spec.kind in RECURRENT:
        views = _layer(st, r)
        x, out = spec_decode(lp, x, spec, pos_b, views)
        for view, new in zip(views, out):
            view.copy_(new)
        return x
    layer_st = dict(st, kv=_layer(st["kv"], r))
    ssm = st.get("ssm")
    if ssm is not None:
        layer_st["ssm"] = _layer(ssm, r)
    x, out = spec_decode(lp, x, spec, pos_b, layer_st, enc_out=enc_out,
                         start=start, kv_spec=kv_spec)
    if ssm is not None:
        for view, new in zip(layer_st["ssm"], out["ssm"]):
            view.copy_(new)
    return x


def _advanced(seg_st, seg: Segment) -> list:
    """A segment's states after a step: each cache's count of tokens one
    more (the tensors were written in place)."""
    return [st if spec.kind in RECURRENT else dict(st, len=st["len"] + 1)
            for st, spec in zip(seg_st, seg.pattern)]


def init_decode_state(params, m: ModelCfg, batch: int, cache_len: int):
    """Per-segment decode states mirroring the param stacks, on the
    params' device: each state tensor stacked (repeats, ...)."""
    device = params["ln_f"]["scale"].device
    stack = lambda t, n: torch.stack([t] * n)  # noqa: E731
    states = []
    for seg in m.segments:
        seg_states = []
        for spec in seg.pattern:
            st = spec_state_init(spec, batch, cache_len, device)
            if spec.kind in RECURRENT:
                seg_states.append(tuple(stack(t, seg.repeats) for t in st))
                continue
            st["kv"] = tuple(stack(t, seg.repeats) for t in st["kv"])
            if "ssm" in st:
                st["ssm"] = tuple(stack(t, seg.repeats) for t in
                                  S.ssm_decode_init(_ssm_params_proto(
                                      params, m), batch, device))
            seg_states.append(st)
        states.append(seg_states)
    return states


def _ssm_params_proto(params, m: ModelCfg):
    """One layer's ssm params, to size the decode state."""
    for seg_p, seg in zip(params["segments"], m.segments):
        for sp, s in zip(seg_p, seg.pattern):
            if s.kind == "dense" and s.cfg.ssm_state:
                return _layer(sp["ssm"], 0)
    raise ValueError("no ssm layer")


def decode_step(params, m: ModelCfg, token: torch.Tensor, pos: int, states,
                enc_out: Optional[torch.Tensor] = None,
                start: Optional[torch.Tensor] = None, state_specs=None):
    """One-token decode.  token (B, 1) int; pos the absolute position (an
    int).  enc_out: an encoder-decoder's ``encode`` output, which every
    decoder layer attends to (through the flash kernel on the card).
    start: optional (B,) per-lane first valid KV position — the
    stale-cache mask a continuous-batching engine passes when a batch lane
    has been reused for a new request (every attention layer shares one
    timeline, so one vector serves all layers).  Returns (logits (B, 1, V),
    new states); the caches and the SSM states are updated in place (a
    layer's new (h, tail) is copied into its view of the stacks: the
    decode of the block returns it, as the reference's does; an xLSTM
    layer's new tuple likewise).

    Under a mesh with a 'model' axis larger than 1, `params` and `states`
    are this rank's blocks and `state_specs` the states' specs
    (``shardings.state_specs`` of the full states), and the step is
    ``_decode_sharded``'s."""
    pos_b = torch.full((token.shape[0], 1), pos, device=token.device)
    ax = PAR.model_axis()
    if ax is not None:
        return _decode_sharded(params, m, token, pos_b, states, start,
                               state_specs, ax, enc_out)
    x = L.embed_apply(params["embed"], token)
    new_states = []
    for seg_p, seg, seg_st in zip(params["segments"], m.segments, states):
        for r in range(seg.repeats):
            for spec, sp, st in zip(seg.pattern, seg_p, seg_st):
                x = _decode_layer(_layer(sp, r), x, spec, pos_b, st, r,
                                  enc_out, start)
        new_states.append(_advanced(seg_st, seg))
    return _head(params, m, x), new_states


def param_count(params) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))
