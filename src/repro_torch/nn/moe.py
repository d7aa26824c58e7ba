"""Mixture-of-Experts FFN (mixtral, phi3.5-moe): the twin of the
reference's ``nn/moe.py``.

Top-k routing on float32 router logits, then capacity dispatch: each
(token, k) assignment takes the next free slot of its expert's buffer of
``cap`` rows, in token-major, k-minor order; an assignment past ``cap``
is dropped.  The tokens are gathered into the (E, cap, D) buffers (never
an O(T x E x cap) one-hot), the experts' SwiGLU FFNs run as three batched
products, and each token sums its kept assignments' outputs weighted by
their routing weights.

Under a mesh (``train/shardings.use_mesh``) the reference's groups come
back: the tokens split into G groups along the mesh's batch axes
(``_num_groups``: the ('pod', 'data') extent when it divides the global
token count), each group routes its own tokens into its own buffers with
its own capacity, and with a 'model' axis whose size divides E the combine
is expert parallel (``e_par``: a gather by capacity position from every
expert, then a one-hot contraction over E) — on one card, every mesh with
a 'model' axis.  G comes from the global T: where the step split its batch
k ways (``shardings.current_split``), this rank's T/k tokens are G/k whole
groups.  Across a 'model' axis (serving and training,
``moe_apply_sharded``) each rank stores and runs its E/m experts where m
divides E, and its F/m block of every expert otherwise, and the ranks'
weighted outputs are summed.

Copied from the reference as written (ROADMAP Queue 3):

* the capacity is ``max(int(capacity_factor * top_k * T / E), 1)`` per
  call, in Python float arithmetic.  A decode step's T is its number of
  lanes, so at 4 lanes and 8 experts each expert takes one assignment a
  step, and decode is not prefill;
* an unoccupied slot gathers token 0 and multiplies it by 0: a non-finite
  token 0 makes those rows NaN, which the plain combine never reads but
  the experts' weight gradients sum.  The ``e_par`` combine multiplies
  every expert's row at an assignment's capacity position by the one-hot,
  so a NaN row of any expert spreads to every assignment at its position.

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
from repro_torch.train import parallel as PAR
from repro_torch.train import shardings as SH


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
    """idx (G, Tg, K) -> (buf_tok (G·E·cap,), occupied (G·E·cap,), slot
    (G·Tg·K,), keep (G·Tg·K,)): the token each slot holds (its group's
    first token where unoccupied), whether it is occupied, each
    assignment's slot (its position clamped to the last row where it is
    dropped) and whether it is kept.  Group g's slots and tokens follow
    group g-1's, so the flat indices address the flat (T, D) tokens and
    (G·E·cap, D) buffers.  Positions come from an int64 cumulative count
    over each group's (Tg·K, E) one-hot, the same integers as the
    reference's float32 count.  A (T, K) idx is one group."""
    if idx.dim() == 2:
        idx = idx[None]
    g, t, k = idx.shape
    flat = idx.reshape(g, t * k)
    onehot = F.one_hot(flat, e)                                # (G, Tg·K, E)
    pos = (onehot.cumsum(1) - onehot).gather(2, flat[..., None])[..., 0]
    keep = pos < cap
    base = torch.arange(g, device=idx.device)[:, None]
    slot = base * (e * cap) + flat * cap + pos.clamp(max=cap - 1)
    token_of = (base * t + torch.arange(t, device=idx.device)
                .repeat_interleave(k)[None, :])
    n = g * e * cap
    slot_safe = torch.where(keep, slot, n)                     # dropped
    buf_tok = (base * t).expand(g, e * cap).reshape(n)
    buf_tok = torch.cat([buf_tok, buf_tok.new_zeros(1)]).scatter_(
        0, slot_safe.reshape(-1), token_of.reshape(-1))
    occupied = torch.zeros(n + 1, dtype=torch.float32,
                           device=idx.device).scatter_(
        0, slot_safe.reshape(-1), keep.reshape(-1).to(torch.float32))
    return buf_tok[:-1], occupied[:-1], slot.reshape(-1), keep.reshape(-1)


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
    """x (T, D) float32, idx (T, K) or (G, Tg, K) -> (xe (G·E, cap, D),
    slot, keep): the tokens gathered into their group's experts' buffers,
    zero where a slot is unoccupied."""
    buf_tok, occupied, slot, keep = _dispatch_group(idx, e, cap)
    xe = _Dispatch.apply(x, buf_tok, occupied, slot, keep)
    return xe.reshape(-1, cap, x.shape[1]), slot, keep


def expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their buffers: xe (G·E, cap, D) -> (G·E,
    cap, D), three batched products (each expert's G buffers in one), in
    xe's float32 whatever the weights' dtype, as the reference's."""
    e, cap, d = params["w_gate"].shape[0], xe.shape[1], xe.shape[2]
    g = xe.shape[0] // e
    w_gate, w_up, w_down = (params[k].to(xe.dtype)
                            for k in ("w_gate", "w_up", "w_down"))
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)
    return ye.reshape(e, g, cap, -1).transpose(0, 1).reshape(g * e, cap, -1)


def combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            wts: torch.Tensor) -> torch.Tensor:
    """ye (G·E, cap, D), wts (T, K) -> (T, D): each token's kept
    assignments' slot outputs weighted by their routing weights and summed
    in k order (a dropped assignment's weight is zeroed)."""
    per = _Combine.apply(ye.reshape(-1, ye.shape[-1]), slot, keep)
    return _weighted_sum(per, keep, wts)


def combine_e_par(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                  wts: torch.Tensor, g: int) -> torch.Tensor:
    """The reference's expert-parallel combine: each assignment gathers
    the row at its capacity position from every expert of its group, and
    a one-hot over E picks its own expert's.  On finite rows the same bits
    as `combine`; a NaN row of any expert spreads to every assignment at
    its capacity position."""
    ge, cap, d = ye.shape
    e = ge // g
    local = slot.reshape(g, -1) - torch.arange(
        g, device=slot.device)[:, None] * (e * cap)            # (G, Tg·K)
    pos = (local % cap).clamp(max=cap - 1)
    ye4 = ye.reshape(g, e, cap, d)
    gathered = torch.gather(
        ye4, 2, pos[:, None, :, None].expand(g, e, pos.shape[1], d))
    own = F.one_hot(local // cap, e).to(ye.dtype)              # (G, Tg·K, E)
    per = (gathered * own.transpose(1, 2)[..., None]).sum(1)   # (G, Tg·K, D)
    return _weighted_sum(per.reshape(-1, d), keep, wts)


def _weighted_sum(per, keep, wts):
    t, k = wts.shape
    w_keep = wts.reshape(t * k, 1) * keep[:, None].to(torch.float32)
    return (per * w_keep).reshape(t, k, -1).sum(1)


def _num_groups(t: int) -> int:
    """Groups = the ('pod', 'data') mesh extent when it divides the global
    token count `t` (1 with no mesh)."""
    mesh = SH.current_mesh()
    if mesh is None:
        return 1
    g = SH.axis_size(mesh, SH.batch_axes(mesh))
    return g if g > 1 and t % g == 0 else 1


def _e_par(e: int) -> bool:
    """Expert-parallel combine: a mesh with a 'model' axis whose size
    divides E (the reference's rule; size 1 divides every E)."""
    mesh = SH.current_mesh()
    return (mesh is not None and "model" in SH.mesh_sizes(mesh)
            and e % SH.axis_size(mesh, "model") == 0)


def moe_apply(params, x: torch.Tensor, *, top_k: int = 2,
              capacity_factor: float = 1.25, aux_loss: bool = False):
    """x (T, D) flattened tokens -> (T, D) [and the Switch load-balancing
    loss over all tokens if `aux_loss`].  Under a mesh, the tokens route in
    the reference's groups, each with the capacity of its Tg tokens, and
    the combine is ``e_par``'s where the reference's is (module
    docstring)."""
    t = x.shape[0]
    e = params["router"].shape[-1]
    split = SH.current_split()
    g_all = _num_groups(t * split)
    assert g_all % split == 0, (g_all, split)
    g = g_all // split                        # the groups this rank holds
    tg = t // g
    cap = capacity(tg, e, top_k, capacity_factor)
    xf = x.to(torch.float32)
    logits = xf @ params["router"]
    idx, wts = route_topk(logits, top_k)
    xe, slot, keep = dispatch(xf, idx.reshape(g, tg, top_k), e, cap)
    ye = expert_ffn(params, xe)
    if _e_par(e):
        y = combine_e_par(ye, slot, keep, wts, g)
    else:
        y = combine(ye, slot, keep, wts)
    y = y.to(x.dtype)
    if not aux_loss:
        return y
    me = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    pe = torch.softmax(logits, dim=-1).mean(0)
    return y, e * torch.sum(me * pe)


def moe_apply_sharded(params, x: torch.Tensor, ax, *, n_experts: int,
                      d_ff: int, top_k: int = 2,
                      capacity_factor: float = 1.25) -> torch.Tensor:
    """``moe_apply`` across a 'model' axis `ax` on this rank's blocks of
    the leaves (their FSDP dims gathered), for serving and training.
    Every rank routes every token the same way (the router's (D, E), tiny,
    is gathered where its E is split), in ``_num_groups``'s groups with
    their capacity.  Where m divides E (the reference's ``e_par``) rank r
    runs experts [r·E/m, (r+1)·E/m) on their buffers and its share of the
    expert-parallel combine, the sum over its experts; else each expert's
    F is split m ways where m divides it, and each rank combines its
    partial outputs.  Either way the rank's weighted (T, D) part is
    rank-local work from the entered x (and router) and the parts are
    summed over 'model'; where 'model' splits neither, every rank computes
    the layer whole."""
    t = x.shape[0]
    e = n_experts
    el = params["w_gate"].shape[0]
    local = el != e or params["w_down"].shape[-2] != d_ff
    router = params["router"]
    if router.shape[-1] != e:
        router = PAR.gather_dim(router, -1, ax.group)
    elif local:
        router = PAR.enter_local(router, ax.group)
    if local:
        x = PAR.enter_local(x, ax.group)
    split = SH.current_split()
    g_all = _num_groups(t * split)
    assert g_all % split == 0, (g_all, split)
    g = g_all // split
    tg = t // g
    cap = capacity(tg, e, top_k, capacity_factor)
    xf = x.to(torch.float32)
    idx, wts = route_topk(xf @ router, top_k)
    buf_tok, occupied, slot, keep = _dispatch_group(
        idx.reshape(g, tg, top_k), e, cap)
    if el != e:                                   # e_par: this rank's experts
        lo = ax.rank * el
        mine = lambda a: a.reshape(g, e, cap)[:, lo:lo + el].reshape(-1)  # noqa: E731
        local_slot = slot.reshape(g, -1) - torch.arange(
            g, device=slot.device)[:, None] * (e * cap)
        ex, pos = local_slot // cap, local_slot % cap
        ours = (ex >= lo) & (ex < lo + el)
        base = torch.arange(g, device=slot.device)[:, None] * (el * cap)
        slot_l = torch.where(ours, base + (ex - lo) * cap + pos, 0)
        xe = _Dispatch.apply(xf, mine(buf_tok), mine(occupied),
                             slot_l.reshape(-1), keep & ours.reshape(-1))
        ye = expert_ffn(params, xe.reshape(g * el, cap, -1))
        pos = pos.clamp(max=cap - 1)
        d = ye.shape[-1]
        gathered = torch.gather(ye.reshape(g, el, cap, d), 2,
                                pos[:, None, :, None].expand(g, el,
                                                             pos.shape[1], d))
        own = F.one_hot(ex, e)[..., lo:lo + el].to(ye.dtype)
        per = (gathered * own.transpose(1, 2)[..., None]).sum(1)
        y = _weighted_sum(per.reshape(-1, d), keep, wts)
    else:
        xe = _Dispatch.apply(xf, buf_tok, occupied, slot, keep)
        ye = expert_ffn(params, xe.reshape(g * e, cap, -1))
        y = _weighted_sum(_Combine.apply(ye.reshape(-1, ye.shape[-1]), slot,
                                         keep), keep, wts)
    if local:
        y = PAR.sum_over(y, ax.group)
    return y.to(x.dtype)
