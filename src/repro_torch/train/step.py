"""Step factories of the LM substrate: ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``, the counterparts of the
reference's, and its loss ``next_token_loss``.

No mesh: one card.  The reference's ``mesh`` and ``act_shard`` place the
step's arrays on a device mesh (``train/shardings``, ROADMAP Queue 1's
multi-device half); on one card they are the identity, so the port's
factories do not take them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import base as MB
from repro_torch.optim import adamw, tree_leaves, tree_unflatten


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


def make_train_step(m: MB.ModelCfg, *, lr=3e-4, remat: bool = True,
                    microbatches: int = 1, grad_compress=None,
                    use_fused: Optional[bool] = None
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
    """
    optim = adamw(lr, weight_decay=0.1, clip_norm=1.0)

    def grads_of(params, batch):
        if microbatches <= 1:
            return loss_and_grads(m, params, batch, remat=remat,
                                  use_fused=use_fused)
        micro = {k: _split(v, microbatches) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        g_sum = [torch.zeros_like(p, dtype=torch.float32)
                 for p in tree_leaves(params)]
        for i in range(microbatches):
            loss, g = loss_and_grads(m, params,
                                     {k: v[i] for k, v in micro.items()},
                                     remat=remat, use_fused=use_fused)
            loss_sum = loss_sum + loss
            for acc, gi in zip(g_sum, tree_leaves(g)):
                acc.add_(gi)
            del g
        inv = 1.0 / microbatches
        return loss_sum * inv, tree_unflatten(params,
                                              [g.mul_(inv) for g in g_sum])

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        if grad_compress is not None:
            grads = grad_compress(grads)
        opt_state = optim.update_in_place(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step, optim


def make_prefill_step(m: MB.ModelCfg, *,
                      use_fused: Optional[bool] = None) -> Callable:
    """prefill_step(params, batch) -> last-position logits (B, V).

    ``batch["tokens"]`` (B, S); ``batch["positions"]`` optional; an
    encoder-decoder's ``batch["frames"]`` (B, S_enc, D), encoded first.
    Every attention layer runs the flash-attention kernel on the card;
    ``use_fused=False`` takes the plain attention instead."""
    def prefill_step(params, batch):
        with torch.no_grad():
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


def make_decode_step(m: MB.ModelCfg) -> Callable:
    """decode_step(params, token, pos, states, enc_out=None, start=None)
    -> (logits (B, 1, V), states), the reference's argument order; see
    ``models/base.decode_step``."""
    def decode_step(params, token, pos, states, enc_out=None, start=None):
        with torch.no_grad():
            return MB.decode_step(params, m, token, pos, states,
                                  enc_out=enc_out, start=start)

    return decode_step
