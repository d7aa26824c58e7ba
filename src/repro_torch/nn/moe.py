"""Mixture-of-Experts FFN (mixtral, phi3.5-moe): the twin of the
reference's ``nn/moe.py``.

Top-k routing on float32 router logits, then capacity dispatch: each
(token, k) assignment takes the next free slot of its expert's buffer of
``cap`` rows, in token-major, k-minor order; an assignment past ``cap``
is dropped.  The tokens are gathered into the (E, cap, D) buffers (never
an O(T x E x cap) one-hot), the experts' SwiGLU FFNs run as three batched
products, and each token sums its kept assignments' outputs weighted by
their routing weights.

What one card leaves out: the reference splits the tokens into groups
along the mesh's batch axes (``_num_groups``), pins its buffers with
sharding constraints (``_c``) and takes an expert-parallel combine
(``e_par``) when E divides the 'model' axis.  With no mesh its group
count is 1 and the constraints are the identity, so the port has one
group and none of the three; they come back with the multi-device half
(ROADMAP Queue 1).

Copied from the reference as written (ROADMAP Queue 3):

* the capacity is ``max(int(capacity_factor * top_k * T / E), 1)`` per
  call, in Python float arithmetic.  A decode step's T is its number of
  lanes, so at 4 lanes and 8 experts each expert takes one assignment a
  step, and decode is not prefill;
* an unoccupied slot gathers token 0 and multiplies it by 0: a non-finite
  token 0 makes those rows NaN, which the combine never reads but the
  experts' weight gradients sum.

The expert products are library batched matmuls, as they are XLA einsums
in the reference.  The gathers into and out of the buffers are
``autograd.Function``s whose backward passes are gathers and a scatter
into distinct slots, so no gradient is summed by atomic adds: two
backward passes give the same bits, on the card as on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng


def moe_init(key: torch.Tensor, n_experts: int, d_model: int, d_ff: int,
             device):
    """The reference's ``moe_init``, bit for bit: router (D, E), w_gate and
    w_up (E, D, F), w_down (E, F, D), float32, drawn from the four keys of
    ``split(key, 4)`` in that order (``core/prng``)."""
    r = prng.split(key.to(device), 4)
    s_in = (2.0 / d_model) ** 0.5
    s_out = (1.0 / d_ff) ** 0.5
    return {
        "router": prng.normal_scaled(r[0], (d_model, n_experts), 0.02,
                                     device),
        "w_gate": prng.normal_scaled(r[1], (n_experts, d_model, d_ff), s_in,
                                     device),
        "w_up": prng.normal_scaled(r[2], (n_experts, d_model, d_ff), s_in,
                                   device),
        "w_down": prng.normal_scaled(r[3], (n_experts, d_ff, d_model), s_out,
                                     device),
    }


def route_topk(router_logits: torch.Tensor,
               top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., E) logits -> (..., K) expert indices and their weights, the
    softmax of the K chosen logits in float32.  The order is
    ``jax.lax.top_k``'s: the float32 total order (-0.0 below 0.0), the
    lower index first on an exact tie — a stable descending sort of the
    logits' bits mapped onto int32 in that order (``torch.topk`` promises
    no order among ties)."""
    bits = router_logits.to(torch.float32).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True,
                     stable=True).indices[..., :top_k]
    w = router_logits.gather(-1, idx)
    return idx, torch.softmax(w.to(torch.float32), dim=-1)


def capacity(t: int, e: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert for `t` tokens: the reference's formula as
    written."""
    return max(int(capacity_factor * top_k * t / e), 1)


def _dispatch_group(idx: torch.Tensor, e: int, cap: int):
    """idx (T, K) -> (buf_tok (E·cap,), occupied (E·cap,), slot (T·K,),
    keep (T·K,)): the token each slot holds (0 where unoccupied), whether
    it is occupied, each assignment's slot (its position clamped to the
    last row where it is dropped) and whether it is kept.  Positions come
    from an int64 cumulative count over the (T·K, E) one-hot, the same
    integers as the reference's float32 count."""
    t, k = idx.shape
    flat = idx.reshape(t * k)
    onehot = F.one_hot(flat, e)                                # (T·K, E)
    pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = pos < cap
    slot = flat * cap + pos.clamp(max=cap - 1)
    token_of = torch.arange(t, device=idx.device).repeat_interleave(k)
    slot_safe = torch.where(keep, slot, e * cap)               # dropped
    buf_tok = torch.zeros(e * cap + 1, dtype=torch.long,
                          device=idx.device).scatter_(0, slot_safe, token_of)
    occupied = torch.zeros(e * cap + 1, dtype=torch.float32,
                           device=idx.device).scatter_(
        0, slot_safe, keep.to(torch.float32))
    return buf_tok[:-1], occupied[:-1], slot, keep


class _Dispatch(torch.autograd.Function):
    """xe = x[buf_tok] · occupied, (E·cap, D).  backward: token t's
    gradient is the sum over k of its kept slots' rows, a gather."""

    @staticmethod
    def forward(ctx, x, buf_tok, occupied, slot, keep):
        ctx.save_for_backward(slot, keep)
        ctx.top_k = slot.numel() // x.shape[0]
        return x.index_select(0, buf_tok) * occupied[:, None]

    @staticmethod
    def backward(ctx, dxe):
        slot, keep = ctx.saved_tensors
        g = dxe.index_select(0, slot) * keep[:, None].to(dxe.dtype)
        return (g.reshape(-1, ctx.top_k, g.shape[-1]).sum(1),
                None, None, None, None)


class _Combine(torch.autograd.Function):
    """Each assignment's slot output, ye[slot], (T·K, D).  backward: a
    kept assignment's gradient is written to its own slot (kept slots are
    distinct); a dropped one's, zero in the layer since its weight is 0,
    goes to an overflow row that is cut off."""

    @staticmethod
    def forward(ctx, ye, slot, keep):
        ctx.save_for_backward(slot, keep)
        ctx.n_slots = ye.shape[0]
        return ye.index_select(0, slot)

    @staticmethod
    def backward(ctx, dpa):
        slot, keep = ctx.saved_tensors
        n = ctx.n_slots
        dye = dpa.new_zeros((n + 1, dpa.shape[-1]))
        dye.index_copy_(0, torch.where(keep, slot, n), dpa)
        return dye[:-1], None, None


def dispatch(x: torch.Tensor, idx: torch.Tensor, e: int, cap: int):
    """x (T, D) float32, idx (T, K) -> (xe (E, cap, D), slot, keep): the
    tokens gathered into their experts' buffers, zero where a slot is
    unoccupied."""
    buf_tok, occupied, slot, keep = _dispatch_group(idx, e, cap)
    xe = _Dispatch.apply(x, buf_tok, occupied, slot, keep)
    return xe.reshape(e, cap, x.shape[1]), slot, keep


def expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their buffers: xe (E, cap, D) -> (E, cap,
    D), three batched products."""
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe,
                                                            params["w_up"])
    return torch.bmm(h, params["w_down"])


def combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            wts: torch.Tensor) -> torch.Tensor:
    """ye (E, cap, D), wts (T, K) -> (T, D): each token's kept
    assignments' slot outputs weighted by their routing weights and summed
    in k order (a dropped assignment's weight is zeroed)."""
    t, k = wts.shape
    per = _Combine.apply(ye.reshape(-1, ye.shape[-1]), slot, keep)
    w_keep = wts.reshape(t * k, 1) * keep[:, None].to(torch.float32)
    return (per * w_keep).reshape(t, k, -1).sum(1)


def moe_apply(params, x: torch.Tensor, *, top_k: int = 2,
              capacity_factor: float = 1.25, aux_loss: bool = False):
    """x (T, D) flattened tokens -> (T, D) [and the Switch load-balancing
    loss over all tokens if `aux_loss`]."""
    t = x.shape[0]
    e = params["router"].shape[-1]
    cap = capacity(t, e, top_k, capacity_factor)
    xf = x.to(torch.float32)
    logits = xf @ params["router"]
    idx, wts = route_topk(logits, top_k)
    xe, slot, keep = dispatch(xf, idx, e, cap)
    y = combine(expert_ffn(params, xe), slot, keep, wts).to(x.dtype)
    if not aux_loss:
        return y
    me = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    pe = torch.softmax(logits, dim=-1).mean(0)
    return y, e * torch.sum(me * pe)
