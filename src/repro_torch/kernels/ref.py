"""Plain PyTorch versions of the port's kernels, and the MoE layer's
dense-gather oracle (``moe_dispatch_ffn``, the reference's, which has no
kernel).  ``ssm_scan`` and ``slstm_scan`` are the plain versions of the
selective-scan and sLSTM kernels, whose references are ``lax.scan``s
rather than Pallas kernels.

Each function is the mathematical definition of its kernel with no tiling
or hardware concerns.  The wrappers in ``kernels/`` take them for CPU
tensors; on the card they are only the yardstick the kernels are held to,
with TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``) so the
product is full float32 like the reference.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def fused_mlp(x: torch.Tensor, ws: Sequence[torch.Tensor],
              bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whole-MLP chain (hidden ReLU, linear head) in float32 — the plain
    version of the whole-MLP forward kernel."""
    y = x.to(torch.float32)
    for i, (w, b) in enumerate(zip(ws, bs)):
        y = y @ w.to(torch.float32) + b.to(torch.float32)
        if i < len(ws) - 1:
            y = torch.relu(y)
    return y.to(x.dtype)


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                relu: bool) -> torch.Tensor:
    """[relu](x @ w + b) in float32 — the plain version of the dense
    forward kernel (differentiable by torch's own autograd)."""
    y = x @ w + b
    return torch.relu(y) if relu else y


def _masked(dy: torch.Tensor, y: torch.Tensor, relu: bool) -> torch.Tensor:
    """g = dy ⊙ [y > 0] (the ReLU mask recomputed from the saved output),
    or dy itself for the linear head."""
    return dy * (y > 0) if relu else dy


def dense_dx(dy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
             relu: bool) -> torch.Tensor:
    """dx = g @ wᵀ — the plain version of the dx kernel."""
    return _masked(dy, y, relu) @ w.t()


def dense_dw_db(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor,
                relu: bool):
    """(dW, db) = (xᵀ @ g, Σ_M g) — the plain version of the dW/db
    kernel."""
    g = _masked(dy, y, relu)
    return x.t() @ g, g.sum(0)


@functools.lru_cache(maxsize=None)
def _scalar(value: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """`value` as a 0-dim tensor, made once per dtype and device (a new
    one on the card would be a copy from the host at every call)."""
    return torch.tensor(value, dtype=dtype, device=device)


def maximum(x: torch.Tensor, value: float) -> torch.Tensor:
    """``jnp.maximum(x, value)`` for a constant: the values of
    ``torch.clamp(x, min=value)`` (the bits too, but a NaN's payload and
    the sign of a zero against 0.0, which torch's vectorized maximum may
    return as +0.0), and jax's gradient, which splits a tie 0.5 / 0.5
    where ``clamp`` passes the whole of it to x."""
    return torch.maximum(x, _scalar(value, x.dtype, x.device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), with no threshold (``F.softplus`` returns x itself
    above 20); its gradient at 0 is jax's 0.5 (``maximum``).
    ``jax.nn.log_sigmoid(x)`` is ``-softplus(-x)``."""
    return maximum(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


#: the finite mask value of the reference (``-inf`` would turn a fully
#: masked tile into ``inf - inf = NaN`` in the online softmax)
NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, return_lse: bool = False):
    """Unblocked GQA attention, softmax in float32 — the plain version of
    the flash-attention kernel.  q (B, H, Sq, D), k and v (B, Hkv, Sk, D);
    q head h reads kv head h // (H // Hkv); query row i sits at absolute
    position ``q_offset + i``.  Returns (B, H, Sq, D) in q's dtype, and
    with ``return_lse`` also each row's log-sum-exp of its scaled, masked
    scores, (B, H, Sq) float32 (a masked score is ``NEG_INF``, as in the
    reference's ``_flash_fwd_impl``).  Differentiable by torch's own
    autograd."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / d ** 0.5
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    out = out.reshape(b, h, sq, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(b, h, sq)
    return out


def moe_dispatch_ffn(x: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor,
                     expert_idx: torch.Tensor,
                     expert_w: torch.Tensor) -> torch.Tensor:
    """Dense-gather MoE oracle, the reference's ``moe_dispatch_ffn``:
    every token runs through its K experts in float32, with no capacity
    and no buffers.  x (T, D); w_gate, w_up (E, D, F); w_down (E, F, D);
    expert_idx (T, K) int, expert_w (T, K) routing weights (zero a
    dropped assignment's to mirror a capacity).  Each (token, k) output is
    its expert's SwiGLU of the token, computed one expert at a time over
    the tokens that chose it; the K outputs are weighted and summed."""
    t, dm = x.shape
    xf = x.to(torch.float32)
    out = xf.new_zeros((t, expert_idx.shape[1], dm))
    for e in range(w_gate.shape[0]):
        tok, k = (expert_idx == e).nonzero(as_tuple=True)
        if tok.numel():
            xe = xf.index_select(0, tok)
            h = F.silu(xe @ w_gate[e].to(torch.float32)) \
                * (xe @ w_up[e].to(torch.float32))
            out[tok, k] = h @ w_down[e].to(torch.float32)
    return (out * expert_w.to(torch.float32)[..., None]).sum(1).to(x.dtype)


def _scan_chunk(h: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, x: torch.Tensor, a: torch.Tensor):
    """L steps of the selective scan from state h (B, Di, N): the chunk's
    ``exp(dt·a)`` and ``dt·b·x`` (B, L, Di, N) at once (elementwise, so
    the bits of a step at a time), then one ``addcmul`` a step, then every
    step's ``Σ_n h·c``.  Returns (ys (B, L, Di), the last h)."""
    da = torch.exp(dt[..., None] * a)
    dbx = dt[..., None] * bmat[:, :, None, :] * x[..., None]
    hs = []
    for t in range(dt.shape[1]):
        h = torch.addcmul(dbx[:, t], da[:, t], h)
        hs.append(h)
    ys = (torch.stack(hs, 1) * cmat[:, :, None, :]).sum(-1)
    return ys, h


def ssm_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
             chunk: int = 64, *, boundaries: bool = False):
    """The selective scan's recurrence, a time loop in torch ops — the
    plain version of the selective-scan kernel and the reference's inner
    ``lax.scan`` step for step: ``h_t = exp(dt_t·a)·h_{t-1} + dt_t·b_t·x_t``
    and ``y_t = Σ_n h_t·c_t``.  dt, x (B, S, Di); bmat, cmat (B, S, N);
    a (Di, N); h0 (B, Di, N).  Returns (ys (B, S, Di), h_S (B, Di, N)) in
    the inputs' dtype (float64 inputs give the float64 scan); with
    ``boundaries=True`` also the state entering each chunk, (B, ⌈S/chunk⌉,
    Di, N): index k is the state after k·chunk steps (h0 first), what the
    backward (``ssm_scan_bwd``) recomputes each chunk from.

    The loop runs in chunks of `chunk` steps.  Under autograd, where
    ``S > chunk`` and `chunk` divides S (the reference's condition), each
    chunk runs under ``torch.utils.checkpoint`` (non-reentrant), as the
    reference's ``jax.checkpoint``-ed chunks do: the backward keeps the
    state only at chunk boundaries.  That saves memory and changes no
    math.  Differentiable by torch's own autograd."""
    s = dt.shape[1]
    remat = (torch.is_grad_enabled() and chunk > 1 and s > chunk
             and s % chunk == 0)
    ys, h, starts = [], h0, []
    for t0 in range(0, s, max(chunk, 1)):
        starts.append(h)
        part = [v[:, t0:t0 + chunk] for v in (dt, bmat, cmat, x)]
        if remat:
            y, h = checkpoint(_scan_chunk, h, *part, a, use_reentrant=False)
        else:
            y, h = _scan_chunk(h, *part, a)
        ys.append(y)
    if boundaries:
        return torch.cat(ys, 1), h, torch.stack(starts, 1)
    return torch.cat(ys, 1), h


def ssm_scan_bwd(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 x: torch.Tensor, a: torch.Tensor, h_chunks: torch.Tensor,
                 dys: torch.Tensor, dh_last: Optional[torch.Tensor] = None,
                 chunk: int = 64):
    """The selective scan's backward by its adjoint recurrence — the plain
    version of the backward kernel.  From the states entering each chunk
    (`h_chunks`, ``ssm_scan(..., boundaries=True)``'s) and the cotangents
    of ys (B, S, Di) and of the final state (`dh_last`, zeros when None),
    chunk by chunk from the last: the chunk's states again (the forward's
    ops, so its bits), then t backward with the state's adjoint

        g_t = dys_t·c_t + exp(dt_{t+1}·a)·g_{t+1}    (g_S = dh_last)

    and ``d_c_t = Σ_d dys_t·h_t``, ``d_b_t = Σ_d g_t·dt_t·x_t``,
    ``d_x_t = dt_t·Σ_n g_t·b_t``, ``d_dt_t = Σ_n g_t·(a·exp(dt_t·a)·h_{t-1}
    + b_t·x_t)``, ``d_a = Σ_{b,t} g_t·dt_t·exp(dt_t·a)·h_{t-1}``,
    ``d_h0 = exp(dt_0·a)·g_0``.  Returns (d_dt, d_bmat, d_cmat, d_x, d_a,
    d_h0).  Torch ops in a time loop: a yardstick, not a route."""
    carry = (torch.zeros_like(h_chunks[:, 0]) if dh_last is None
             else dh_last.clone())
    d_a = torch.zeros_like(a)
    parts = []
    for k in reversed(range(h_chunks.shape[1])):
        t0 = k * chunk
        dt_c, b_c, c_c, x_c, dy_c = (v[:, t0:t0 + chunk] for v in (
            dt, bmat, cmat, x, dys))
        da = torch.exp(dt_c[..., None] * a)               # (B, L, Di, N)
        dbx = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
        hs = [h_chunks[:, k]]
        for t in range(dt_c.shape[1]):
            hs.append(torch.addcmul(dbx[:, t], da[:, t], hs[-1]))
        hs = torch.stack(hs, 1)              # h_{t-1} at t, h_t at t + 1
        gs = [None] * dt_c.shape[1]
        for t in reversed(range(dt_c.shape[1])):
            gs[t] = dy_c[:, t, :, None] * c_c[:, t, None, :] + carry
            carry = da[:, t] * gs[t]
        g = torch.stack(gs, 1)
        dah = da * hs[:, :-1]
        gdt = g * dt_c[..., None]
        d_a += (gdt * dah).sum((0, 1))
        parts.append((
            (g * (a * dah + b_c[:, :, None, :] * x_c[..., None])).sum(-1),
            (gdt * x_c[..., None]).sum(2),
            (dy_c[..., None] * hs[:, 1:]).sum(2),
            (g * b_c[:, :, None, :]).sum(-1) * dt_c))
    d_dt, d_b, d_c, d_x = (torch.cat(p[::-1], 1) for p in zip(*parts))
    return d_dt, d_b, d_c, d_x, d_a, carry


def _slstm_pre(h_prev: torch.Tensor, wx_t: torch.Tensor, rh: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """A step's pre-activations (B, 4D), the reference's order: the
    per-head recurrence ``einsum("bhd,hde->bhe")`` flattened to (B, 4D),
    so head k's 4·dh outputs fill gate columns [k·4dh, (k+1)·4dh) (at
    H = 4 head k alone feeds gate k of every channel), then ``(wx_t +
    rec) + bias``."""
    b, d = h_prev.shape
    hd, dh = rh.shape[0], rh.shape[1]
    rec = torch.einsum("bhd,hde->bhe", h_prev.reshape(b, hd, dh),
                       rh).reshape(b, 4 * d)
    return wx_t + rec + bias


def _slstm_gates(pre: torch.Tensor):
    """(z, i_raw, f_raw, o) of the gate columns [z | i | f | o]."""
    d = pre.shape[-1] // 4
    return (torch.tanh(pre[:, :d]), pre[:, d:2 * d], pre[:, 2 * d:3 * d],
            torch.sigmoid(pre[:, 3 * d:]))


def _slstm_update(pre: torch.Tensor, c, n, m):
    """The stabilized exponential gates and the new (c, n, m, h):
    ``h = (o·c) / max(n, 1e-6)``."""
    z_t, i_raw, f_raw, o_t = _slstm_gates(pre)
    logf = -softplus(-f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(logf + m - m_new)
    c = f_g * c + i_g * z_t
    n = f_g * n + i_g
    h = o_t * c / maximum(n, 1e-6)
    return c, n, m_new, h


def _slstm_cell(carry, wx_t: torch.Tensor, rh: torch.Tensor,
                bias: torch.Tensor):
    """One sLSTM step, the reference's ``cell`` op for op."""
    c, n, m, h_prev = carry
    return _slstm_update(_slstm_pre(h_prev, wx_t, rh, bias), c, n, m)


def _slstm_steps(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
                 c, n, m, h):
    """`_slstm_cell` over wx's steps -> (hs (B, S, D), c, n, m, h)."""
    hs = []
    for t in range(wx.shape[1]):
        c, n, m, h = _slstm_cell((c, n, m, h), wx[:, t], rh, bias)
        hs.append(h)
    return torch.stack(hs, 1), c, n, m, h


def slstm_scan(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
               state, chunk: int = 64, *, boundaries: bool = False):
    """The sLSTM's recurrence as a time loop in torch ops — the plain
    version of the sLSTM kernel.  wx (B, S, 4D) the projected inputs, rh
    (H, dh, 4dh) the block-diagonal recurrent weights, bias (4D,), state
    (c, n, m, h) each (B, D) -> (hs (B, S, D), the final (c, n, m, h));
    with ``boundaries=True`` also (c, n, m) entering each chunk of
    `chunk` steps, each (B, ⌈S/chunk⌉, D): index k is the state after
    k·chunk steps (the initial state first), what the backward
    (``slstm_scan_bwd``) recomputes each chunk from.

    Under autograd, where ``S > chunk`` and `chunk` divides S (the
    reference's ``_chunked_scan`` condition), each chunk of steps runs
    under ``torch.utils.checkpoint`` (non-reentrant), as the reference's
    ``jax.checkpoint``-ed chunks do; that changes no math.
    Differentiable by torch's own autograd."""
    s = wx.shape[1]
    remat = (torch.is_grad_enabled() and chunk > 1 and s > chunk
             and s % chunk == 0)
    if not (remat or boundaries):
        hs, *state = _slstm_steps(wx, rh, bias, *state)
        return hs, tuple(state)
    parts, starts = [], []
    for t0 in range(0, s, chunk):
        starts.append(state[:3])
        part = (wx[:, t0:t0 + chunk], rh, bias, *state)
        if remat:
            hs, *state = checkpoint(_slstm_steps, *part, use_reentrant=False)
        else:
            hs, *state = _slstm_steps(*part)
        parts.append(hs)
    out = torch.cat(parts, 1), tuple(state)
    if boundaries:
        return (*out, tuple(torch.stack(v, 1) for v in zip(*starts)))
    return out


def _tie(x: torch.Tensor, y) -> torch.Tensor:
    """jax's share of ``max(x, y)``'s gradient that goes to x: 1 where
    x > y, 0.5 at a tie, 0 below."""
    return (x > y).to(x.dtype) + 0.5 * (x == y).to(x.dtype)


def _slstm_cell_adjoint(pre: torch.Tensor, c, n, m, g_h, g_c, g_n, g_m):
    """One step of the sLSTM's adjoint, as autodiff differentiates the
    reference's ``cell``: from the step's pre-activations and the state
    entering it (c, n, m), the cotangents of the step's h and of the
    state leaving it, to d_pre (B, 4D) and the cotangents of (c, n, m)
    entering it.  Every path is kept: m inside both exponentials and
    through ``m_new = max(logf + m, i)``; both ``max``es split a tie 0.5
    / 0.5; ``logf = -softplus(-f)`` takes ``logaddexp``'s derivative
    ``exp(y - softplus(y))`` at y = -f."""
    z, i_raw, f_raw, o = _slstm_gates(pre)
    sp = softplus(-f_raw)
    lm = -sp + m                                  # logf + m
    m_new = torch.maximum(lm, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(lm - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    den = maximum(n_new, 1e-6)
    num = o * c_new                               # h = num / den
    d_num = g_h / den
    g_c = g_c + d_num * o
    g_n = g_n + (-g_h * num / (den * den)) * _tie(n_new, 1e-6)
    u_f = (g_c * c + g_n * n) * f_g               # d f_g · f_g
    u_i = (g_c * z + g_n) * i_g                   # d i_g · i_g
    d_m_new = g_m - u_i - u_f
    sel = _tie(lm, i_raw)
    d_lm = u_f + sel * d_m_new                    # d logf = d m
    d_pre = torch.cat([g_c * i_g * (1 - z * z),
                       u_i + (1 - sel) * d_m_new,
                       d_lm * torch.exp(-f_raw - sp),
                       d_num * c_new * o * (1 - o)], -1)
    return d_pre, g_c * f_g, g_n * f_g, d_lm


def slstm_scan_bwd(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
                   state, hs: torch.Tensor, chunks,
                   dys: Optional[torch.Tensor] = None, d_state=None,
                   chunk: int = 64):
    """The sLSTM recurrence's backward by its adjoint loop — the plain
    version of the backward kernel.  From the forward's inputs (wx, rh,
    bias, the initial state (c, n, m, h)), its hs and the states entering
    each chunk (`chunks`, ``slstm_scan(..., boundaries=True)``'s (c, n,
    m)), and the cotangents of hs (`dys`, (B, S, D)) and of the final
    (c, n, m, h) (`d_state`; None, or any one None, is zeros), chunk by
    chunk from the last: the chunk's pre-activations again from h_{t-1}
    (hs, h0 at t = 0) and its states again from the chunk's start (the
    forward's ops, so its bits), then t backward: ``_slstm_cell_adjoint``
    with the cotangent of h_t = dys_t + the recurrent adjoint from t + 1,

        d_h_{t-1}[k·dh + i] = Σ_e rh[k, i, e] · d_pre_t[k·4dh + e],

    then ``d_rh[k] = Σ_{b,t} h_{t-1}[k·dh:(k+1)·dh] ⊗ d_pre_t[k·4dh:
    (k+1)·4dh]`` and ``d_bias = Σ_{b,t} d_pre_t``.  Returns (d_wx (=
    d_pre, (B, S, 4D)), d_rh, d_bias, dc0, dn0, dm0, dh0).  Torch ops in a
    time loop: a yardstick, not a route."""
    b, s, four_d = wx.shape
    d = four_d // 4
    hd, dh = rh.shape[0], rh.shape[1]
    zero = torch.zeros_like(state[0])
    g_c, g_n, g_m, g_h = (zero if g is None else g
                          for g in (d_state or (None,) * 4))
    h_prev = torch.cat([state[3][:, None], hs[:, :-1]], 1)
    d_pre = torch.empty_like(wx)
    for k in reversed(range(chunks[0].shape[1])):
        t0 = k * chunk
        c, n, m = (v[:, k] for v in chunks)
        pres, prev = [], []
        for t in range(t0, min(t0 + chunk, s)):
            pres.append(_slstm_pre(h_prev[:, t], wx[:, t], rh, bias))
            prev.append((c, n, m))
            c, n, m, _ = _slstm_update(pres[-1], c, n, m)
        for t in reversed(range(t0, min(t0 + chunk, s))):
            if dys is not None:
                g_h = g_h + dys[:, t]
            d_pre[:, t], g_c, g_n, g_m = _slstm_cell_adjoint(
                pres[t - t0], *prev[t - t0], g_h, g_c, g_n, g_m)
            g_h = torch.einsum("bhe,hde->bhd",
                               d_pre[:, t].reshape(b, hd, 4 * dh),
                               rh).reshape(b, d)
    return (d_pre, *slstm_weight_grads(state[3], hs, d_pre, hd),
            g_c, g_n, g_m, g_h)


def slstm_weight_grads(h0: torch.Tensor, hs: torch.Tensor,
                       d_pre: torch.Tensor, heads: int):
    """(d_rh, d_bias) from every step's d_pre (B, S, 4D) and h_{t-1} (h0,
    then hs): ``d_rh[k] = Σ_{b,t} h_{t-1}[k·dh:(k+1)·dh] ⊗ d_pre_t[k·4dh:
    (k+1)·4dh]`` as one batched product over the heads, ``d_bias =
    Σ_{b,t} d_pre_t``.  Plain products, as the reference leaves them to
    XLA; the backward kernel's wrapper takes them too."""
    b, s, d = hs.shape
    dh = d // heads
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], 1)
    d_rh = torch.einsum("bshd,bshe->hde", h_prev.reshape(b, s, heads, dh),
                        d_pre.reshape(b, s, heads, 4 * dh))
    return d_rh, d_pre.sum((0, 1))
