"""xLSTM blocks (arXiv:2405.04517): the mLSTM (matrix memory) and the
sLSTM, the twin of the reference's ``nn/xlstm.py``.

Both use stabilized exponential gating.  The mLSTM keeps a per-head
matrix memory C (dh, dh), a normalizer n (dh,) and a stabilizer m; the
sLSTM keeps scalar memories (c, n, m, h) with a block-diagonal (per-head)
recurrence.  Decoding carries the recurrent state explicitly, so one
token costs O(dh^2) (mLSTM) / O(d·dh) (sLSTM) whatever the history.

The mLSTM has two forms, as in the reference: the chunkwise-parallel one
(``mlstm_chunkwise``, products of torch ops chunk by chunk) where
``chunk`` divides S, and the stepwise scan otherwise (decode, short
prompts).  They differ in the last bits (up to ~2e-3 at reduced width in
the reference's own test), so a comparison pairs like with like.  The
sLSTM's recurrence goes to ``kernels/ops.slstm_scan``: on the card the
hand-written sLSTM kernel (``kernels/slstm_scan.py``), on the CPU its
plain version (``kernels/ref.slstm_scan``).

Params keep the reference's layout and initial bits (the inits draw
through ``core/prng`` from the same keys with the same scales).

Across a 'model' axis (``train/parallel``) the mLSTM's prefill is head
parallel (``_mlstm_apply_heads``), its decode steps the blocked state of
``state_specs`` (``_mlstm_decode_blocks``); the sLSTM's recurrence is
replicated work (``slstm_apply``).  The
recurrences run in float32 as the reference's do (a bf16 input is cast
up); a float64 input stays float64, for a float64 yardstick.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.ref import maximum, softplus
from repro_torch.nn import layers as L
from repro_torch.train import parallel as PAR

#: the stabilizer's start, the reference's (a finite "minus infinity")
NEG = -1e30


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)`` with jax's softplus."""
    return -softplus(-x)


def _chunked_scan(cell, state, seqs, s: int, chunk: int = 64):
    """The reference's two-level scan: `cell(carry, inputs) -> (carry, y)`
    over the time-major `seqs` (S, ...), the ys stacked on axis 0.  Under
    autograd, where ``s > chunk`` and `chunk` divides s, each chunk runs
    under ``torch.utils.checkpoint`` (non-reentrant), as the reference's
    ``jax.checkpoint``-ed chunks do: the backward keeps the carry only at
    chunk boundaries.  That changes no math."""
    def run(carry, *part):
        ys = []
        for t in range(part[0].shape[0]):
            carry, y = cell(carry, tuple(p[t] for p in part))
            ys.append(y)
        return carry, torch.stack(ys)

    if not (torch.is_grad_enabled() and chunk > 1 and s % chunk == 0
            and s > chunk):
        return run(state, *seqs)
    ys = []
    for t0 in range(0, s, chunk):
        state, y = checkpoint(run, state, *(q[t0:t0 + chunk] for q in seqs),
                              use_reentrant=False)
        ys.append(y)
    return state, torch.cat(ys)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(key: torch.Tensor, d_model: int, n_heads: int, device):
    """The reference's ``mlstm_init``, bit for bit: keys 0-3 of
    ``split(key, 6)``, scale (1/d)^0.5, b_f 3.0."""
    r = prng.split(key.to(device), 6)
    s = (1.0 / d_model) ** 0.5
    return {
        "wqkv": prng.normal_scaled(r[0], (d_model, 3 * d_model), s, device),
        "wif": prng.normal_scaled(r[1], (d_model, 2 * n_heads), s, device),
        "b_i": torch.zeros(n_heads, dtype=torch.float32, device=device),
        "b_f": torch.full((n_heads,), 3.0, dtype=torch.float32,
                          device=device),                # forget-gate bias
        "wo": prng.normal_scaled(r[2], (d_model, d_model), s, device),
        "gn": L.rmsnorm_init(d_model, device),
        "wz": prng.normal_scaled(r[3], (d_model, d_model), s, device),
    }


def mlstm_state_init(batch: int, n_heads: int, dh: int, device,
                     dtype=torch.float32):
    """(C (B, H, dh, dh), n (B, H, dh), m (B, H)): zeros and m at NEG."""
    return (torch.zeros((batch, n_heads, dh, dh), dtype=dtype,
                        device=device),
            torch.zeros((batch, n_heads, dh), dtype=dtype, device=device),
            torch.full((batch, n_heads), NEG, dtype=dtype, device=device))


def _mlstm_cell(carry, inp):
    """carry: (C (B,H,dh,dh), n (B,H,dh), m (B,H)); inp: q, k, v (B,H,dh),
    i, f raw (B,H)."""
    c, n, m = carry
    q, k, v, i_raw, f_raw = inp
    logf = _log_sigmoid(f_raw)                            # (B,H)
    m_new = torch.maximum(logf + m, i_raw)
    i_g = torch.exp(i_raw - m_new)[..., None]             # (B,H,1)
    f_g = torch.exp(logf + m - m_new)[..., None]
    c = f_g[..., None] * c + i_g[..., None] * (v[..., :, None]
                                               * k[..., None, :])
    n = f_g * n + i_g * k
    num = torch.einsum("bhde,bhe->bhd", c, q)
    den = maximum(torch.einsum("bhd,bhd->bh", n, q).abs(), 1.0)[..., None]
    return (c, n, m_new), num / den


def mlstm_apply(params, x: torch.Tensor, n_heads: int,
                state: Optional[Tuple] = None, chunkwise: bool = True,
                chunk: int = 64):
    """(B, S, D) -> (B, S, D), final state (C, n, m).  The chunkwise form
    where ``chunkwise`` and `chunk` divides S (S >= chunk), the stepwise
    scan otherwise, as the reference chooses.  Across a 'model' axis the
    prefill (no `state`) is head parallel (``_mlstm_apply_heads``) and a
    step from a state takes that state's blocks
    (``_mlstm_decode_blocks``)."""
    ax = PAR.model_axis()
    if ax is not None:
        if state is not None:
            return _mlstm_decode_blocks(params, x, n_heads, state, ax)
        return _mlstm_apply_heads(params, x, n_heads, chunkwise, chunk, ax)
    return _mlstm_whole(params, x, n_heads, state, chunkwise, chunk)


def _mlstm_whole(params, x, n_heads: int, state, chunkwise: bool,
                 chunk: int):
    """``mlstm_apply`` on whole weights."""
    b, s, d = x.shape
    dh = d // n_heads
    f32 = _compute_dtype(x)
    q, k, v = (x @ params["wqkv"]).split(d, dim=-1)
    gi = (x @ params["wif"]).to(f32)
    i_raw = gi[..., :n_heads] + params["b_i"]
    f_raw = gi[..., n_heads:] + params["b_f"]
    state, h = _mlstm_cells(x, *(t.reshape(b, s, n_heads, dh)
                                 for t in (q, k, v)),
                            i_raw, f_raw, state, chunkwise, chunk)
    h = L.rmsnorm_apply(params["gn"], h)
    h = h * F.silu(x @ params["wz"])                      # output gate branch
    return h @ params["wo"], state


def _mlstm_cells(x, q, k, v, i_raw, f_raw, state, chunkwise: bool,
                 chunk: int):
    """The mLSTM's recurrence over the heads of q, k, v (B, S, heads, dh),
    float32 (k not yet scaled): (the final state, h (B, S, heads·dh) in
    x's dtype); the chunkwise or the stepwise form as ``mlstm_apply``
    chooses."""
    b, s, heads, dh = q.shape
    f32 = _compute_dtype(x)
    q, k, v = q.to(f32), (k * (1.0 / (dh ** 0.5))).to(f32), v.to(f32)
    if state is None:
        state = mlstm_state_init(b, heads, dh, x.device, f32)
    if chunkwise and s % chunk == 0 and s >= chunk:
        state, h = mlstm_chunkwise(q, k, v, i_raw, f_raw, state, chunk)
    else:
        mv = lambda a: a.movedim(1, 0)  # noqa: E731
        state, hs = _chunked_scan(_mlstm_cell, state,
                                  (mv(q), mv(k), mv(v), mv(i_raw),
                                   mv(f_raw)), s)
        h = hs.movedim(0, 1)
    return state, h.reshape(b, s, heads * dh).to(x.dtype)


def _mlstm_apply_heads(params, x, n_heads: int, chunkwise: bool, chunk: int,
                       ax):
    """The mLSTM prefill on this rank's H/m heads across the 'model' axis
    `ax` (rank-local work from the entered x): q, k and v from ``wqkv``'s
    columns of those heads (its q | k | v layout: the columns gathered,
    ``PAR.column_blocks``), the gates from the whole entered ``wif``,
    ``b_i`` and ``b_f``, the cells, ``gn`` over the whole D
    (``PAR.rmsnorm_blocks``), the output gate from ``wz``'s column block
    (those heads' columns), then the row-parallel ``wo``.  The final state
    is those heads' (nothing stores it: a decode state is blocked as
    ``state_specs`` says, ``_mlstm_decode_blocks``).  Where 'model' does
    not divide H every rank computes every head, as one rank does, from
    the gathered weights."""
    b, s, d = x.shape
    if n_heads % ax.size or params["wz"].shape[-1] == d:
        return _mlstm_replicated(params, x, n_heads, chunkwise, chunk, ax)
    hl, dh = n_heads // ax.size, d // n_heads
    h0 = ax.rank * hl
    x = PAR.enter_local(x, ax.group)
    q, k, v = PAR.column_blocks(x, params["wqkv"], d, 3, ax).split(hl * dh,
                                                                  dim=-1)
    f32 = _compute_dtype(x)
    gi = (x @ PAR.enter_local(params["wif"], ax.group)).to(f32)
    i_raw = (gi[..., h0:h0 + hl]
             + PAR.enter_local(params["b_i"], ax.group)[h0:h0 + hl])
    f_raw = (gi[..., n_heads + h0:n_heads + h0 + hl]
             + PAR.enter_local(params["b_f"], ax.group)[h0:h0 + hl])
    state, h = _mlstm_cells(x, *(t.reshape(b, s, hl, dh) for t in (q, k, v)),
                            i_raw, f_raw, None, chunkwise, chunk)
    h = PAR.rmsnorm_blocks(params["gn"], h, d, ax)
    h = h * F.silu(x @ params["wz"])
    return PAR.sum_over(h @ params["wo"], ax.group), state


def _mlstm_replicated(params, x, n_heads: int, chunkwise: bool, chunk: int,
                      ax):
    """``mlstm_apply`` on one rank's whole weights, gathered from the
    blocks (replicated work: the gathers' gradients only cut)."""
    d = x.shape[-1]
    whole = dict(params)
    for name, dim in (("wqkv", -1), ("wz", -1), ("wo", -2)):
        if params[name].shape[dim] != (3 * d if name == "wqkv" else d):
            whole[name] = PAR.gather_dim(params[name], dim, ax.group,
                                         grad_group=None)
    return _mlstm_whole(whole, x, n_heads, None, chunkwise, chunk)


def _mlstm_decode_blocks(params, x, n_heads: int, state, ax):
    """One mLSTM step across the 'model' axis `ax` from this rank's
    blocks of the state as ``state_specs`` lays them out: C (B, H, dh/m,
    dh) on its v rows, n (B, H, dh/m) on k's index, m (B, H/m) on the
    heads or whole.  Every rank forms q, k, v and the gates of every head
    (the products' columns gathered) and, with m of every head gathered,
    its rows of C and its block of n; n·q is summed over 'model', each
    rank's rows of h (B, H, dh/m) are gathered into h (B, 1, D), then
    ``gn``, the output gate and the row-parallel ``wo``.  A decode step:
    no gradient."""
    c_blk, n_blk, m_blk = state
    b, s, d = x.shape
    dh = d // n_heads
    if s != 1 or c_blk.shape[1] != n_heads or c_blk.shape[3] != dh \
            or c_blk.shape[2] * ax.size != dh or n_blk.shape[2] != \
            c_blk.shape[2]:
        raise ValueError(f"an mLSTM step across 'model' takes one token and "
                         f"C blocked on its v rows, n on dh; got x "
                         f"{tuple(x.shape)}, C {tuple(c_blk.shape)}, n "
                         f"{tuple(n_blk.shape)}")
    f32 = _compute_dtype(x)
    q, k, v = (PAR.project(x, params["wqkv"], 3 * d, ax, local=False)
               .to(f32).reshape(b, 3, n_heads, dh).unbind(1))
    k = k * (1.0 / (dh ** 0.5))
    gi = (x @ params["wif"]).to(f32)[:, 0]
    i_raw = gi[..., :n_heads] + params["b_i"]
    f_raw = gi[..., n_heads:] + params["b_f"]
    m = m_blk if m_blk.shape[1] == n_heads else PAR.gather_dim(
        m_blk, 1, ax.group)
    r = c_blk.shape[2]
    lo = ax.rank * r
    logf = _log_sigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_g = torch.exp(i_raw - m_new)[..., None]
    f_g = torch.exp(logf + m - m_new)[..., None]
    c_new = f_g[..., None] * c_blk + i_g[..., None] * (
        v[..., lo:lo + r, None] * k[..., None, :])
    n_new = f_g * n_blk + i_g * k[..., lo:lo + r]
    num = torch.einsum("bhde,bhe->bhd", c_new, q)
    nq = PAR.sum_over(torch.einsum("bhd,bhd->bh", n_new, q[..., lo:lo + r]),
                      ax.group)
    h = num / maximum(nq.abs(), 1.0)[..., None]
    h = PAR.gather_dim(h, 2, ax.group).reshape(b, 1, d).to(x.dtype)
    h = L.rmsnorm_apply(params["gn"], h)
    h = h * F.silu(PAR.project(x, params["wz"], d, ax, local=False))
    y = _rows_out(h, params["wo"], ax)
    m_out = m_new if m_blk.shape[1] == n_heads else PAR.rows(m_new, ax, 1)
    return y, (c_new, n_new, m_out)


def _rows_out(h, wo, ax):
    """``h @ wo`` for h (.., D) replicated over 'model' (replicated work)
    where `wo` holds this rank's block of rows: h's block through
    ``keep_block`` (its gradient the blocks' gathered: every rank's h
    gets the whole), the partial products summed."""
    if wo.shape[0] == h.shape[-1]:
        return h @ wo
    return PAR.sum_over(PAR.keep_block(h, -1, ax.group) @ wo, ax.group)


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state, chunk: int):
    """The reference's chunkwise-parallel mLSTM, its chunk body op for op.

    Within a chunk the output is an attention-like masked product (the
    intra term, (L, L) per head) plus the carried matrix memory applied
    once (the inter term); the (dh, dh) state is updated once a chunk.
    q, k, v: (B, S, H, dh) float32 (k pre-scaled); i_raw, f_raw: (B, S,
    H); state (C, n, m).  Returns (the final state, h (B, S, H, dh)).
    """
    b, s, h, dh = q.shape
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    c0, n0, m0 = state
    outs = []
    for t0 in range(0, s, chunk):
        qq, kk, vv, ii, ff = (a[:, t0:t0 + chunk]
                              for a in (q, k, v, i_raw, f_raw))
        logf = _log_sigmoid(ff)                           # (B,L,H)
        bcum = torch.cumsum(logf, dim=1)                  # b_t, t=1..L
        # intra log-weights a[t,s] = b_t - b_s + i_s  (s <= t)
        a = bcum[:, :, None] - bcum[:, None, :] + ii[:, None, :, :]
        a = torch.where(tri[None, :, :, None], a, NEG)    # (B,t,s,H)
        g = bcum + m0[:, None]                            # (B,L,H)
        m_t = torch.maximum(g, a.amax(dim=2))             # (B,L,H)
        w = torch.exp(a - m_t[:, :, None])                # (B,t,s,H)
        cw = torch.exp(g - m_t)                           # (B,L,H)

        scores = torch.einsum("blhd,bshd->blsh", qq, kk)  # (B,t,s,H)
        wsc = w * scores
        num = (torch.einsum("blsh,bshd->blhd", wsc, vv)
               + cw[..., None] * torch.einsum("bhde,blhe->blhd", c0, qq))
        den = wsc.sum(2) + cw * torch.einsum("bhd,blhd->blh", n0, qq)
        outs.append(num / maximum(den.abs(), 1.0)[..., None])

        # ---- state update (once per chunk) ----
        m_l = m_t[:, -1]                                  # (B,H)
        wl = torch.exp(bcum[:, -1:, :] - bcum + ii - m_l[:, None])
        decay = torch.exp(bcum[:, -1] + m0 - m_l)
        c0 = (decay[..., None, None] * c0
              + torch.einsum("bshd,bsh,bshe->bhde", vv, wl, kk))
        n0 = decay[..., None] * n0 + torch.einsum("bsh,bshd->bhd", wl, kk)
        m0 = m_l
    return (c0, n0, m0), torch.cat(outs, 1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(key: torch.Tensor, d_model: int, n_heads: int, device):
    """The reference's ``slstm_init``, bit for bit: ``split(key, 3)``; wx
    and wo at scale (1/d)^0.5, the per-head rh (H, dh, 4dh) at (1/dh)^0.5;
    b = [0]*2d ++ [3]*d ++ [0]*d (the forget gate's bias 3)."""
    r = prng.split(key.to(device), 3)
    s = (1.0 / d_model) ** 0.5
    dh = d_model // n_heads

    def const(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    return {
        "wx": prng.normal_scaled(r[0], (d_model, 4 * d_model), s, device),
        # block-diagonal recurrence: per-head (dh, 4*dh)
        "rh": prng.normal_scaled(r[1], (n_heads, dh, 4 * dh),
                                 (1.0 / dh) ** 0.5, device),
        "b": torch.cat([const(2 * d_model, 0.0), const(d_model, 3.0),
                        const(d_model, 0.0)]),
        "gn": L.rmsnorm_init(d_model, device),
        "wo": prng.normal_scaled(r[2], (d_model, d_model), s, device),
    }


def slstm_state_init(batch: int, d_model: int, device, dtype=torch.float32):
    """(c, n, m, h) each (B, D): zeros, n at 1e-6 and m at NEG."""
    def const(value):
        return torch.full((batch, d_model), value, dtype=dtype,
                          device=device)

    return const(0.0), const(1e-6), const(NEG), const(0.0)


def slstm_apply(params, x: torch.Tensor, n_heads: int,
                state: Optional[Tuple] = None,
                use_fused: Optional[bool] = None):
    """(B, S, D) -> (B, S, D), final state (c, n, m, h).  ``x @ wx`` is a
    plain product; the recurrence is ``kernels/ops.slstm_scan`` (the
    kernel on the card; ``use_fused=False`` the plain loop).

    Across a 'model' axis every rank runs the whole recurrence (replicated
    work): the reference's recurrent product ``einsum("bhd,hde->bhe", h,
    rh).reshape(B, 4D)`` sends head j's 4·dh columns to the gate-major
    columns [j·4dh, (j+1)·4dh), at H = 4 gate j of every channel, so every
    channel's step reads every head's h_{t-1}: no block of heads or
    channels runs a step on its own.  ``x @ wx`` takes every column
    (``PAR.project``) and ``rh``'s blocks are gathered (their gradients
    only cut), a state's blocks (``state_specs`` puts its D on 'model')
    gathered and the new state cut back to them; then ``wo`` row parallel
    (``_rows_out``)."""
    ax = PAR.model_axis()
    b, s, d = x.shape
    f32 = _compute_dtype(x)
    rh, blocked = params["rh"], False
    if ax is None:
        wx = x @ params["wx"]
    else:
        wx = PAR.project(x, params["wx"], 4 * d, ax, local=False)
        if rh.shape[-2] * 4 != rh.shape[-1]:
            rh = PAR.gather_dim(rh, -2, ax.group, grad_group=None)
        if state is not None and state[0].shape[-1] != d:
            blocked = True
            state = tuple(PAR.gather_dim(t, -1, ax.group) for t in state)
    wx = wx.to(f32)                                       # (B,S,4D)
    if state is None:
        state = slstm_state_init(b, d, x.device, f32)
    hs, state = ops.slstm_scan(wx, rh.to(f32), params["b"].to(f32), state,
                               use_fused=use_fused)
    h = L.rmsnorm_apply(params["gn"], hs.to(x.dtype))
    if blocked:
        state = tuple(PAR.rows(t, ax, -1) for t in state)
    if ax is None:
        return h @ params["wo"], state
    return _rows_out(h, params["wo"], ax), state
