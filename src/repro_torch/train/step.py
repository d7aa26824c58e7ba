"""Step factories of the LM substrate: ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``, the counterparts of the
reference's, and its loss ``next_token_loss``; then the shape structs and
``build_case``, which packages one (arch x shape) cell's step with its
inputs for the cost tools (``launch/dryrun``, ``launch/perf``).

The structs are tensors on the ``meta`` device: shapes, dtypes and strides
with no memory and no draws, as the reference's ``jax.eval_shape`` gives
``ShapeDtypeStruct``s, so the 33B-param archs are built on any host, and
calling a case's step on them runs every op and kernel wrapper's meta
route, which ``utils/op_cost`` counts.

Under a mesh (``launch/mesh``) with no 'model' axis larger than 1 the
train step is data parallel over the mesh's batch axes: every rank is
handed the global batch and takes its rows of every microbatch where the
shard count divides them (so every MoE token group is the reference's),
computes its loss and gradients, and the losses and gradients are
all-reduced to the global means before the replicated AdamW update.
Where they do not divide, every rank computes the whole batch (the
reference replicates it too, ``batch_specs``).  The prefill and decode
steps install the mesh, so the MoE layers route in the reference's
groups, and compute the whole batch on every rank.

Across a 'model' axis larger than 1 (every ported arch) every step
takes params, optimizer state and decode states already sharded
(``shardings.shard_params``, ``shard_states``; ``optim.init`` of the
blocks), splits the batch's rows over the batch axes where
``batch_specs``' rule splits them (an encoder-decoder's frames and
``enc_out`` too), and runs the layers on this rank's blocks
(``models/base._forward_sharded``, ``_encode_sharded``,
``_decode_sharded``) through ``train/parallel``'s collectives.  The
prefill and decode steps gather the logits, so every rank returns the
whole batch's.  The train step
keeps the head's vocab block: ``next_token_loss_sharded`` is the
vocab-parallel cross entropy, the FSDP gathers' backward sums the
gradients over the split rows, ``finish_grads`` sums the rest, the clip
reads ``parallel.global_norm`` of the blocks, and AdamW updates the
blocks in place.  ``fsdp`` (the reference's knob) picks the blocks'
specs: ``param_specs(fsdp=True)`` by default.  ``build_case`` takes the
reference's ``mesh``, ``fsdp`` and ``act_shard`` and packages one rank's
step on its blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.shapes import Shape
from repro_torch.configs.whisper_small import DECODER_TRAIN_LEN
from repro_torch.core import prng
from repro_torch.core import shard
from repro_torch.models import base as MB
from repro_torch.optim import adamw, tree_leaves, tree_map, tree_unflatten
from repro_torch.train import parallel as PAR
from repro_torch.train import shardings as SH


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def next_token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy in float32: logsumexp of the logits (B, S, V)
    minus the gold logit, averaged over (B, S)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def next_token_loss_sharded(logits: torch.Tensor, labels: torch.Tensor,
                            ax: PAR.ModelAxis) -> torch.Tensor:
    """``next_token_loss`` of logits whose vocab splits over the 'model'
    axis `ax`: `logits` (B, S, Vr) are rank r's block, vocab ids [r·Vr,
    (r+1)·Vr).  The logsumexp of the blocks is the log of the ranks'
    summed exponentials, shifted by their max (a detached stabiliser);
    the gold logit comes from the rank whose block holds the label, the
    others adding 0.  Its gradient on each rank is its softmax block minus
    its one-hot block, over B·S."""
    logits = logits.to(torch.float32)
    vr = logits.shape[-1]
    with torch.no_grad():
        top = PAR.max_over(logits.amax(-1), ax.group)
    total = PAR.sum_over(torch.exp(logits - top[..., None]).sum(-1),
                         ax.group)
    logz = torch.log(total) + top
    local = labels.long() - ax.rank * vr
    mine = (local >= 0) & (local < vr)
    gold = torch.gather(logits, -1, local.clamp(0, vr - 1)[..., None])[..., 0]
    gold = PAR.sum_over(torch.where(mine, gold, 0.0), ax.group)
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# train / serve step factories
# ---------------------------------------------------------------------------
def loss_and_grads(m: MB.ModelCfg, params, batch: Dict[str, torch.Tensor], *,
                   remat: bool = False, use_fused: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``next_token_loss`` over ``MB.forward``, the
    gradients a tree of params' structure; an encoder-decoder first
    encodes ``batch["frames"]`` (``MB.encode``, under the same `remat` and
    `use_fused`), as the reference's ``loss_fn`` does.  The params are
    differentiated through aliases (``detach``), so the caller's tensors
    gain no grad and may be updated in place afterwards."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        tree = tree_unflatten(params, live)
        enc_out = None
        if m.enc_segments is not None:
            enc_out = MB.encode(tree, m, batch["frames"], remat=remat,
                                use_fused=use_fused)
        logits = MB.forward(tree, m, batch["tokens"],
                            positions=batch.get("positions"),
                            use_fused=use_fused, remat=remat,
                            enc_out=enc_out)
        del enc_out
        loss = next_token_loss(logits, batch["labels"])
        del logits
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(params, list(grads))


def _split(x: torch.Tensor, microbatches: int) -> torch.Tensor:
    """The reference's microbatch split: a value of ``ndim >= 2`` whose
    axis 0 is 3 is taken for (3, B, S) M-RoPE positions and cut along
    axis 1, the microbatch axis then moved to the front; any other value
    is cut along axis 0.  At B = 3 the test also takes (3, S) tokens and
    labels and (3, S_enc, D) frames for positions and cuts them along
    their second axis, as the reference does (qwen2-vl's (3, 1, S)
    positions then meet (3, S/3) tokens, and M-RoPE fails to broadcast)."""
    if x.dim() >= 2 and x.shape[0] == 3:
        return x.reshape(3, microbatches, -1, *x.shape[2:]).movedim(1, 0)
    return x.reshape(microbatches, -1, *x.shape[1:])


def _rows(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of every value of a batch: axis 1 of (3, B, S)
    positions, axis 0 of the rest."""
    return {k: shard.put_sharded(v, mesh, axis=1 if k == "positions" else 0)
            for k, v in batch.items()}


def make_train_step(m: MB.ModelCfg, *, lr=3e-4, remat: bool = True,
                    mesh=None, microbatches: int = 1,
                    act_shard: str = "model", fsdp: bool = True,
                    grad_compress=None, use_fused: Optional[bool] = None
                    ) -> Tuple[Callable, Any]:
    """Returns (train_step, optimizer).  train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss": loss}).

    The optimizer is ``adamw(lr, weight_decay=0.1, clip_norm=1.0)``, as the
    reference's.  The step updates params, mu and nu in place
    (``update_in_place``: the same bits as the reference's update, one
    leaf at a time), where the reference donates them to XLA
    (``donate_argnums``); the returned params and state are the same
    tensors as those passed in.

    ``microbatches > 1`` splits every value of the batch by the
    reference's rule (``_split``) and accumulates the float32 gradients
    and losses of the pieces in order, then scales both by
    1/microbatches, as the reference's ``lax.scan`` does.
    ``grad_compress`` is a callable on the gradient tree (the reference's
    calling convention).  Every attention layer runs the flash kernel on
    the card, differentiated by ``nn/attention.FlashAttentionFn``;
    ``use_fused=False`` takes the plain attention under torch's autograd.

    ``mesh`` makes the step data parallel over its batch axes (module
    docstring); every rank passes the same global batch and params.
    Across a 'model' axis larger than 1 the params and state are this
    rank's blocks and the step is ``_train_step_sharded``'s; `act_shard`
    ('model', 'seq' or 'none', the reference's knob) is then the residual
    stream's layout at the remat save points, and `fsdp` (the reference's
    knob too) says whether the blocks are ``param_specs(fsdp=True)``'s,
    each leaf's other large dim split over 'data' and gathered before its
    layer, or ``fsdp=False``'s, replicated over 'data'.
    """
    if act_shard not in SH.ACT_SHARD:
        raise ValueError(f"act_shard {act_shard!r} is not one of "
                         f"{SH.ACT_SHARD}")
    if SH.model_axis(mesh) > 1:
        return _train_step_sharded(m, mesh, lr=lr, remat=remat,
                                   microbatches=microbatches,
                                   act_shard=act_shard, fsdp=fsdp,
                                   grad_compress=grad_compress,
                                   use_fused=use_fused)
    k = shard.n_task_shards(mesh)
    optim = adamw(lr, weight_decay=0.1, clip_norm=1.0)

    def grads_of(params, batch, split: int):
        mine = (lambda b: _rows(b, mesh)) if split > 1 else (lambda b: b)
        if microbatches <= 1:
            return loss_and_grads(m, params, mine(batch), remat=remat,
                                  use_fused=use_fused)
        micro = {k: _split(v, microbatches) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        g_sum = [torch.zeros_like(p, dtype=torch.float32)
                 for p in tree_leaves(params)]
        for i in range(microbatches):
            loss, g = loss_and_grads(
                m, params, mine({k: v[i] for k, v in micro.items()}),
                remat=remat, use_fused=use_fused)
            loss_sum = loss_sum + loss
            for acc, gi in zip(g_sum, tree_leaves(g)):
                acc.add_(gi)
            del g
        inv = 1.0 / microbatches
        return loss_sum * inv, tree_unflatten(params,
                                              [g.mul_(inv) for g in g_sum])

    def train_step(params, opt_state, batch):
        # split where every microbatch's rows divide over the ranks
        rows = batch["tokens"].shape[0] // max(microbatches, 1)
        split = k if k > 1 and rows % k == 0 else 1
        with SH.use_mesh(mesh, split=split):
            loss, grads = grads_of(params, batch, split)
        if split > 1:       # the global means: a sum over the ranks, 1/k
            loss, grads = tree_map(lambda t: t.mul_(1.0 / split),
                                   shard.all_reduce((loss, grads), mesh))
        if grad_compress is not None:
            grads = grad_compress(grads)
        opt_state = optim.update_in_place(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step, optim


def _train_step_sharded(m: MB.ModelCfg, mesh, *, lr, remat: bool,
                        microbatches: int, act_shard: str, fsdp: bool,
                        grad_compress, use_fused: Optional[bool]
                        ) -> Tuple[Callable, Any]:
    """``make_train_step`` across a 'model' axis larger than 1 on this
    rank's blocks (``shard_params(fsdp=fsdp)``; the optimizer's ``init``
    of them):
    each microbatch's rows split over the batch axes by ``batch_specs``'
    rule, the forward on the blocks with the head's vocab block, the
    vocab-parallel loss (scaled by 1/the rows' shard count, so the FSDP
    gathers' backward sums the global mean's gradient), the gradients
    accumulated over the microbatches as the one-rank step does, then
    summed over the split axes where a leaf's spec does not shard them
    (``parallel.finish_grads``), clipped by the global norm of the blocks
    and applied by AdamW in place.  The step's ``loss_and_grads(params,
    batch)`` is its (loss, gradient blocks) before any compression or
    clip, and ``grad_norm(grads)`` their global norm."""
    specs = SH.spec_leaves(PAR.param_layout(m, mesh, fsdp))
    optim = adamw(lr, weight_decay=0.1, clip_norm=1.0)

    def loss_of(tree, piece):
        enc_out = None
        if m.enc_segments is not None:
            enc_out = MB.encode(tree, m, piece["frames"], remat=remat,
                                use_fused=use_fused)
        logits = MB.forward(tree, m, piece["tokens"],
                            positions=piece.get("positions"),
                            use_fused=use_fused, remat=remat,
                            vocab_block=True, enc_out=enc_out)
        if logits.shape[-1] == m.vocab:
            return next_token_loss(logits, piece["labels"])
        return next_token_loss_sharded(logits, piece["labels"],
                                       PAR.model_axis())

    def loss_and_grads_sharded(params, batch):
        n = max(microbatches, 1)
        rax = _row_axis(mesh, batch["tokens"].shape[0] // n)
        pieces = [batch]
        if n > 1:
            micro = {k: _split(v, n) for k, v in batch.items()}
            pieces = [{k: v[i] for k, v in micro.items()} for i in range(n)]
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss_sum, g_sum = 0.0, None
        with SH.use_mesh(mesh, act_shard=act_shard, split=rax.size,
                         fsdp=fsdp):
            for piece in pieces:
                piece = {k: PAR.rows(v, rax, dim=1 if k == "positions"
                                     and v.dim() == 3 else 0)
                         for k, v in piece.items()}
                with torch.enable_grad():
                    loss = loss_of(tree_unflatten(params, live), piece)
                    g = torch.autograd.grad(loss * (1.0 / rax.size), live,
                                            materialize_grads=True)
                loss_sum = loss_sum + loss.detach()
                g_sum = list(g) if g_sum is None else [
                    acc.add_(gi) for acc, gi in zip(g_sum, g)]
                del g
            if n > 1:
                loss_sum = loss_sum * (1.0 / n)
                g_sum = [t.mul_(1.0 / n) for t in g_sum]
            grads = PAR.finish_grads(g_sum, specs, mesh)
        loss = PAR.sum_over(loss_sum, rax.group) * (1.0 / rax.size)
        return loss, tree_unflatten(params, grads)

    def grad_norm(grads):
        return PAR.global_norm(tree_leaves(grads), specs, mesh)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads_sharded(params, batch)
        if grad_compress is not None:
            grads = grad_compress(grads)
        opt_state = optim.update_in_place(grads, opt_state, params,
                                          norm=grad_norm(grads))
        return params, opt_state, {"loss": loss}

    train_step.loss_and_grads = loss_and_grads_sharded
    train_step.grad_norm = grad_norm
    return train_step, optim


def make_prefill_step(m: MB.ModelCfg, *, mesh=None, fsdp: bool = True,
                      use_fused: Optional[bool] = None) -> Callable:
    """prefill_step(params, batch) -> last-position logits (B, V).

    ``batch["tokens"]`` (B, S); ``batch["positions"]`` optional; an
    encoder-decoder's ``batch["frames"]`` (B, S_enc, D), encoded first.
    Every attention layer runs the flash-attention kernel on the card;
    ``use_fused=False`` takes the plain attention instead.  ``mesh`` is
    installed for the step (the MoE layers' groups follow it); every rank
    computes the whole batch.  Across a 'model' axis larger than 1 the
    params are this rank's blocks under ``param_specs(fsdp=fsdp)`` and
    the rows split (module docstring); the head runs on the last position
    alone."""

    def prefill_sharded(params, batch):
        tokens = batch["tokens"]
        ax = _row_axis(mesh, tokens.shape[0])
        pos = batch.get("positions")
        if pos is not None:
            pos = PAR.rows(pos, ax, dim=1 if pos.dim() == 3 else 0)
        with torch.no_grad(), SH.use_mesh(mesh, split=ax.size, fsdp=fsdp):
            enc_out = None
            if m.enc_segments is not None:
                enc_out = MB.encode(params, m, PAR.rows(batch["frames"], ax),
                                    use_fused=use_fused)
            logits = MB.forward(params, m, PAR.rows(tokens, ax),
                                positions=pos, use_fused=use_fused,
                                last_only=True, enc_out=enc_out)[:, -1]
        return PAR.gather_dim(logits, 0, ax.group)

    if SH.model_axis(mesh) > 1:
        PAR.param_layout(m, mesh, fsdp)     # the specs, once, at set-up
        return prefill_sharded

    def prefill_step(params, batch):
        with torch.no_grad(), SH.use_mesh(mesh):
            enc_out = None
            if m.enc_segments is not None:
                enc_out = MB.encode(params, m, batch["frames"],
                                    use_fused=use_fused)
            logits = MB.forward(params, m, batch["tokens"],
                                positions=batch.get("positions"),
                                use_fused=use_fused, enc_out=enc_out)
        # a copy, so the (B, S, V) logits are freed on return
        return logits[:, -1].clone()

    return prefill_step


def _row_axis(mesh, batch: int) -> PAR.ModelAxis:
    """The batch axes a batch of `batch` rows splits over on `mesh`
    (``batch_specs``' rule), as this rank's (group, coordinate, size)."""
    axes = PAR.batch_axes_for(mesh, batch)
    return PAR.ModelAxis(None, 0, 1) if axes is None else PAR.axis(mesh, axes)


def make_decode_step(m: MB.ModelCfg, *, mesh=None,
                     cache_len: Optional[int] = None,
                     fsdp: bool = True) -> Callable:
    """decode_step(params, token, pos, states, enc_out=None, start=None)
    -> (logits (B, 1, V), states), the reference's argument order; see
    ``models/base.decode_step``.  ``mesh`` is installed for the step, as
    in ``make_prefill_step``.  Across a 'model' axis larger than 1 the
    params and states are this rank's blocks (the params' under
    ``param_specs(fsdp=fsdp)``), `cache_len` (the cache the states were
    made for) gives the states' specs (``parallel.state_layout``, built
    out of a counter's sight at a batch size's first call), each rank
    decodes its lanes (the states' batch dim; an encoder-decoder's
    `enc_out` rows alike) and the logits are gathered."""
    if SH.model_axis(mesh) > 1:
        if cache_len is None:
            raise ValueError("make_decode_step across a 'model' axis needs "
                             "the states' cache_len")
        return _decode_sharded(m, mesh, cache_len, fsdp)

    def decode_step(params, token, pos, states, enc_out=None, start=None):
        with torch.no_grad(), SH.use_mesh(mesh):
            return MB.decode_step(params, m, token, pos, states,
                                  enc_out=enc_out, start=start)

    return decode_step


def _decode_sharded(m: MB.ModelCfg, mesh, cache_len: int,
                    fsdp: bool) -> Callable:
    PAR.param_layout(m, mesh, fsdp)         # the specs, once, at set-up

    def decode_step(params, token, pos, states, enc_out=None, start=None):
        b = token.shape[0]
        specs = PAR.state_layout(m, mesh, b, cache_len)
        ax = _row_axis(mesh, b)
        if start is not None:
            start = PAR.rows(start, ax)
        if enc_out is not None:
            enc_out = PAR.rows(enc_out, ax)
        with torch.no_grad(), SH.use_mesh(mesh, split=ax.size, fsdp=fsdp):
            logits, states = MB.decode_step(params, m, PAR.rows(token, ax),
                                            pos, states, enc_out=enc_out,
                                            start=start, state_specs=specs)
        return PAR.gather_dim(logits, 0, ax.group), states

    return decode_step


# ---------------------------------------------------------------------------
# shape-struct builders (no allocation: the meta device)
# ---------------------------------------------------------------------------
META = torch.device("meta")


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_structs(m: MB.ModelCfg, shape: Shape,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One batch of `shape`: tokens and labels (B, S) int32, qwen2-vl's
    (3, B, S) positions; an encoder-decoder's cell length is its encoder
    frames (B, S, D) of `dtype`, and its tokens and labels take the
    decoder's own length, at most ``DECODER_TRAIN_LEN``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if m.enc_segments is not None:
        sd = min(DECODER_TRAIN_LEN, s)
        return {"frames": _struct((b, s, m.d_model), dtype),
                "tokens": _struct((b, sd), i32),
                "labels": _struct((b, sd), i32)}
    out = {"tokens": _struct((b, s), i32), "labels": _struct((b, s), i32)}
    if m.family == "vlm":
        out["positions"] = _struct((3, b, s), i32)
    return out


def batch_specs(m: MB.ModelCfg, shape: Shape, mesh) -> Dict[str, SH.P]:
    """The reference's specs of a batch: B over the batch axes where it
    divides their product, else over 'data' where that divides, else
    replicated."""
    ba = SH.batch_axes(mesh)
    b = shape.global_batch
    b_ax = ba if b % SH.axis_size(mesh, ba) == 0 else (
        "data" if b % SH.axis_size(mesh, "data") == 0 else None)
    if m.enc_segments is not None:
        return {"frames": SH.P(b_ax, None, None), "tokens": SH.P(b_ax, None),
                "labels": SH.P(b_ax, None)}
    out = {"tokens": SH.P(b_ax, None), "labels": SH.P(b_ax, None)}
    if m.family == "vlm":
        out["positions"] = SH.P(None, b_ax, None)
    return out


def param_structs(m: MB.ModelCfg, dtype=torch.bfloat16):
    """``init_params``'s tree on the meta device: every leaf's shape, no
    draw (``core/prng`` skips the draws on meta), in `dtype`."""
    p = MB.init_params(prng.prng_key(torch.tensor(0)), m, META)
    return p if dtype == torch.float32 else tree_map(
        lambda t: t.to(dtype), p)


def state_structs(params_struct, m: MB.ModelCfg, batch: int, cache_len: int,
                  dtype=torch.bfloat16):
    """``init_decode_state``'s tree for `params_struct`'s model: the KV
    caches in `dtype`, the recurrent states in float32."""
    states = MB.init_decode_state(params_struct, m, batch, cache_len)
    if dtype != torch.float32:
        for seg in states:
            for st in seg:
                if isinstance(st, dict):
                    st["kv"] = tuple(t.to(dtype) for t in st["kv"])
    return states


# ---------------------------------------------------------------------------
# the packaged case: everything the cost tools need for one cell
# ---------------------------------------------------------------------------
#: ``Case.bytes_by_part``'s entry that is no argument of the step
SAVED = "remat_saves"


@dataclasses.dataclass
class Case:
    name: str
    fn: Callable                 # fn(*args) runs the step once
    args: Tuple[Any, ...]        # meta structs (this rank's blocks)
    #: the mesh's axis sizes and the rank counted; None: one card
    mesh: Optional[Dict[str, int]] = None
    rank: int = 0
    #: a device's bytes of each input from its specs (``block_bytes``):
    #: params, opt_state (mu, nu and the step), batch, states, pos; and
    #: ``SAVED``, a train step's residual stream at its remat save points
    bytes_by_part: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def arg_bytes(self) -> int:
        """A device's bytes of the step's inputs, from the specs: the
        parts but ``SAVED``."""
        return sum(v for k, v in self.bytes_by_part.items() if k != SAVED)


def _whole(tree):
    """Specs that shard nothing, for every tensor leaf of `tree`."""
    return tree_map(lambda t: SH.P(*([None] * t.dim()))
                    if isinstance(t, torch.Tensor) else t, tree)


def _saved_bytes(m: MB.ModelCfg, shape: Shape, mesh, rows: int, dtype,
                 act_shard: str) -> int:
    """A device's bytes of the residual stream that a train step's remat
    save points keep (one a repeat of every segment, the encoder's too),
    a microbatch of `rows` under ``activation_spec``."""
    seqs = [(sum(seg.repeats for seg in m.segments),
             min(DECODER_TRAIN_LEN, shape.seq_len)
             if m.enc_segments is not None else shape.seq_len)]
    if m.enc_segments is not None:
        seqs.append((sum(seg.repeats for seg in m.enc_segments),
                     shape.seq_len))
    total = 0
    with SH.use_mesh(mesh, act_shard=act_shard):
        for n, s in seqs:
            x = _struct((rows, s, m.d_model), dtype)
            total += n * SH.block_bytes(
                x, SH.activation_spec(mesh, rows, m.d_model, s), mesh)
    return total


def build_case(m: MB.ModelCfg, shape: Shape, mesh=None, *,
               dtype=torch.bfloat16, lr: float = 3e-4, remat: bool = True,
               microbatches: int = 1, fsdp: bool = True,
               act_shard: str = "model") -> Case:
    """One (arch x shape) cell: the train, prefill or decode step of
    ``shape.kind`` and its meta inputs.  Any `Shape` is taken, not only
    those of ``SHAPES``.  A train case's args are (params, optimizer
    state, batch); a prefill's (params, batch without labels); a decode
    step's (params, token (B, 1), its position, the states of a cache of
    ``seq_len`` tokens[, an encoder-decoder's ``enc_out``]).  The keyword
    knobs (microbatches, remat, fsdp, act_shard) are ``launch/perf``'s
    sweep, the reference's.

    With no `mesh` or a mesh of one rank the case is one card's.  On a
    larger mesh (``launch/mesh``; ``counting_world`` makes one of any
    size in this process) the case is this rank's: across a 'model' axis
    larger than 1 the params are its blocks under
    ``param_specs(fsdp=fsdp)``, the optimizer's ``init`` of them and the
    decode states its blocks under ``state_specs``, as the sharded steps
    take them; with no such axis the step is data parallel on whole
    params and states.  Every rank is handed the global batch (the steps
    take their rows) and a decode step's position is a Python int, so
    the counted call's ``arg_bytes`` are not a device's:
    ``bytes_by_part`` counts each input's block under its specs
    (``param_specs``, ``batch_specs``, ``state_specs``; ``pos`` and each
    cached layer's count of tokens, Python ints here, an int32's 4 bytes
    each as the reference's), as its compiled ``argument_size_in_bytes``
    does.  The ranks are not all alike (a ``PAR.Owned`` FFN's layers lie
    on some), so the case records the rank it counts."""
    name = f"{m.name}:{shape.name}"
    p_struct = param_structs(m, dtype)
    sizes = None if mesh is None else SH.mesh_sizes(mesh)
    if sizes is not None and int(np.prod(list(sizes.values()))) == 1:
        mesh = sizes = None
    sharded = SH.model_axis(mesh) > 1
    rank = dist.get_rank() if mesh is not None else 0
    p_specs = (SH.param_specs(p_struct, mesh, fsdp=fsdp) if sharded
               else _whole(p_struct))
    params = SH.shard_params(p_struct, mesh, fsdp=fsdp) if sharded \
        else p_struct
    parts = {"params": SH.block_bytes(p_struct, p_specs, mesh)}

    def case(fn, *args) -> Case:
        return Case(name, fn, args, sizes, rank, parts)

    if shape.kind in ("train", "prefill"):
        batch = batch_structs(m, shape, dtype)
        b_specs = (batch_specs(m, shape, mesh) if mesh is not None
                   else _whole(batch))
        if shape.kind == "prefill":
            del batch["labels"], b_specs["labels"]
        parts["batch"] = SH.block_bytes(batch, b_specs, mesh)
    if shape.kind == "train":
        step, optim = make_train_step(m, lr=lr, remat=remat, mesh=mesh,
                                      microbatches=microbatches,
                                      act_shard=act_shard, fsdp=fsdp)
        full = optim.init(p_struct)
        parts["opt_state"] = SH.block_bytes(
            full, type(full)(SH.P(), p_specs, p_specs), mesh)
        if remat and sharded:
            parts[SAVED] = _saved_bytes(
                m, shape, mesh, shape.global_batch // max(microbatches, 1),
                dtype, act_shard)
        return case(step, params, optim.init(params), batch)
    if shape.kind == "prefill":
        return case(make_prefill_step(m, mesh=mesh, fsdp=fsdp), params,
                    batch)
    # decode: one new token against a cache of seq_len
    b = shape.global_batch
    full = state_structs(p_struct, m, b, shape.seq_len, dtype)
    s_specs = SH.state_specs(full, mesh, b) if sharded else _whole(full)
    states = SH.shard_states(full, mesh, b) if sharded else full
    b_ax = PAR.batch_axes_for(mesh, b) if mesh is not None else None
    inputs = {"token": (_struct((b, 1), torch.int32), SH.P(b_ax, None))}
    if m.enc_segments is not None:
        inputs["enc_out"] = (_struct((b, m.max_enc_len, m.d_model), dtype),
                             SH.P(b_ax, None, None))
    layers = sum(seg.repeats for seg, seg_st in zip(m.segments, full)
                 for st in seg_st if isinstance(st, dict))
    parts.update(
        batch=sum(SH.block_bytes(t, p, mesh) for t, p in inputs.values()),
        pos=4, states=SH.block_bytes(full, s_specs, mesh) + 4 * layers)
    args = [params, inputs["token"][0], shape.seq_len - 1, states]
    if m.enc_segments is not None:
        args.append(inputs["enc_out"][0])
    step = make_decode_step(m, mesh=mesh, fsdp=fsdp,
                            cache_len=shape.seq_len if sharded else None)
    return case(step, *args)
