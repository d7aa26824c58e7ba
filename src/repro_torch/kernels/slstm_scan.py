"""The sLSTM recurrence of xLSTM on the card: the hand-written CUDA kernels
in ``csrc/slstm_scan.cu`` (forward and backward), their wrappers and
``SLSTMScanFn``, the autograd Function over them.

Replaces no Pallas kernel: the reference's recurrence is the ``cell`` of
``nn/xlstm.slstm_apply`` (reference package) under its
``_chunked_scan``/``lax.scan``, which XLA compiles and differentiates;
eager torch would take ~15 launches a time step, so on the card it is one
launch a layer for the whole sequence each way (and one a decode step, at
S = 1), for each group of up to MAX_BATCH = 8 batch rows.  A persistent
grid, launched cooperatively: each block owns 16
channels' four gate columns, its threads keep those columns of rh in
registers, form the pre-activations from h_{t-1} (staged in shared
memory) and update c, n, m in registers, then wait at a grid barrier
before the next step.  The forward keeps, when asked, the state (c, n, m)
entering every chunk of CHUNK steps.  The backward walks the sequence from
the end, a chunk at a time: the chunk's pre-activations and states again
(the forward's order, so its bits), then a step at a time the adjoint of
the reference's cell (jax's tie rules) and, after a grid barrier, the
recurrent adjoint from a whole head's d_pre_t.  d_rh and d_bias are plain
products after it.  Float32, sums in a fixed order: the same inputs give
the same bits on every run.

Bound on an H100 SXM at xlstm-1.3b's prefill (2 x 4096 x 2048, H 4): the
recurrent products' 68.7 GFLOP at the 67 TFLOP/s float32 peak (1.03 ms)
over the 352 MB of wx, hs and rh (0.105 ms); at the train step's 2 x 2048
the backward's products (the recompute's and the adjoint's, 68.7 GFLOP,
1.03 ms) over its bytes (~0.1 ms).  The S dependent steps, each a
grid-wide exchange, set a latency floor above both.

The device rule lives here (``build.route``): a CPU tensor gets the plain
versions (``kernels/ref.slstm_scan``, ``ref.slstm_scan_bwd``); a CUDA
tensor gets the kernels or an exception (a card that is not sm_90, a
failed build, a shape, dtype or layout the kernels do not take, a grid
that cannot be co-resident, a refused launch); a meta tensor gets empty
meta outputs (the chunk states too) and charges ``work`` or ``bwd_work``
to ``utils/op_cost``'s counter, with no launch (bf16 operands there
counted as the float32 kernel's work at their own bytes, under
``build.meta_name``'s name).  Nothing falls back.
Inputs that need a gradient go through ``SLSTMScanFn`` on either device.
``kernels/ops.slstm_scan`` adds only the caller's ``use_fused=False``
(torch's autograd of the plain loop).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref
from repro_torch.utils import op_cost as _cost

SOURCE = _build.CSRC / "slstm_scan.cu"
#: batch rows the kernels are built for (a template parameter: 1..MAX_BATCH);
#: the wrappers take a larger batch in groups of MAX_BATCH rows, a launch
#: a group
MAX_BATCH = 8
#: channels a block owns (D must be a multiple), and the threads that
#: share one gate column's dot product in the forward
CHANNELS, PARTS = 16, 4
#: threads a block, and those sharing one row of rh in the backward
THREADS = 256
#: head widths the kernels are built for (dh / PARTS weights in registers,
#: a template parameter)
HEAD_DIMS = (16, 32, 64, 128, 256, 512)
#: steps between the states the forward keeps for the backward (the
#: kernel's CHUNK, and the reference's chunk)
CHUNK = 64
#: floats the backward keeps a step of a chunk, a (row, channel): the
#: state entering it, its gates, the new c and n, two derivatives
KEPT = 10
#: a block's shared memory on sm_90, bytes
SMEM_LIMIT = 232448
#: cudaErrorCooperativeLaunchTooLarge
_TOO_LARGE = 82


def _bind(lib: ctypes.CDLL) -> None:
    lib.slstm_scan_f32.argtypes = ([ctypes.c_void_p] * 15
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.slstm_scan_f32.restype = ctypes.c_int
    lib.slstm_scan_bwd_f32.argtypes = ([ctypes.c_void_p] * 19
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
    lib.slstm_scan_bwd_f32.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source revision) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def n_chunks(s: int) -> int:
    return -(-s // CHUNK)


def smem_bytes(b: int, d: int) -> int:
    """The forward's dynamic shared memory a block: h_{t-1} of every row
    (B x D) and the partial sums (4 x B x 64), float32."""
    return 4 * (b * d + PARTS * b * 4 * CHANNELS)


def bwd_smem_bytes(b: int, d: int, dh: int) -> int:
    """The backward's: h_{t-1} of every row or a head's d_pre_t of every
    row (B x max(D, 4dh)), and both phases' partial sums."""
    return 4 * (b * max(d, 4 * dh) + PARTS * b * 4 * CHANNELS
                + THREADS // CHANNELS * b * CHANNELS)


def _check(wx, rh, bias, state, backward: bool = False, **more) -> None:
    """The operands (and `more`, by name) against wx's and rh's shapes and
    what the kernels take; then the card and each tensor's dtype, layout
    and device."""
    if wx.dim() != 3 or rh.dim() != 3:
        raise ValueError(f"wx must be (B, S, 4D) and rh (H, dh, 4dh); got "
                         f"{tuple(wx.shape)} and {tuple(rh.shape)}")
    b, s, four_d = wx.shape
    h, dh = rh.shape[0], rh.shape[1]
    d = four_d // 4
    nc = n_chunks(s)
    shapes = {"wx": (b, s, 4 * d), "rh": (h, dh, 4 * dh), "bias": (4 * d,),
              "c": (b, d), "n": (b, d), "m": (b, d), "h": (b, d),
              "hs": (b, s, d), "dys": (b, s, d), "c_chunks": (b, nc, d),
              "n_chunks": (b, nc, d), "m_chunks": (b, nc, d),
              "dc": (b, d), "dn": (b, d), "dm": (b, d), "dh": (b, d)}
    if len(state) != 4 or h * dh != d:
        raise ValueError(f"rh {tuple(rh.shape)} does not split D = {d} into "
                         f"heads, or the state is not (c, n, m, h)")
    named = dict(wx=wx, rh=rh, bias=bias, **dict(zip("cnmh", state)), **more)
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if s < 1 or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"the sLSTM kernel takes 1..{MAX_BATCH} rows a "
                         f"launch and S >= 1; got B = {b}, S = {s}")
    if d % CHANNELS or dh not in HEAD_DIMS:
        raise ValueError(f"the sLSTM kernel takes D a multiple of {CHANNELS} "
                         f"and dh one of {HEAD_DIMS}; got D = {d}, dh = {dh}")
    smem = bwd_smem_bytes(b, d, dh) if backward else smem_bytes(b, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the sLSTM kernel at B = {b}, D = {d} needs {smem} "
                         f"bytes of shared memory a block, more than "
                         f"{SMEM_LIMIT}")
    if wx.device.type == "cuda":
        _build.check_card(wx.device, "the sLSTM kernel")
    _build.check_operands(wx.device, named.items())


def work(b: int, s: int, d: int, h: int, boundaries: bool = False,
         itemsize: int = 4) -> Tuple[float, float, str]:
    """The forward's own work: (operations, bytes, unit).  The recurrent
    products, 2·dh for each of the 4 gate columns of each (b, t, channel),
    and the 36 around them (8 adds into the pre-activations, tanh, the
    sigmoid's 4, log-sigmoid's 8, the stabilizer's 2, the gates' 5, c's 3,
    n's 2, h's 3; a transcendental counted as one), float32 on the SIMT
    cores (``fp32_simt``).  Bytes: wx, rh, bias and the state read once,
    hs and the final state (and the chunk states) written once; wx and hs
    at `itemsize` bytes an element (the meta route's operands'), the rest
    at float32's 4."""
    dh = d // h
    seq = b * s * 4 * d + b * s * d
    rest = h * dh * 4 * dh + 4 * d + 8 * b * d
    if boundaries:
        rest += 3 * b * n_chunks(s) * d
    return (float(b * s * d * (8 * dh + 36)), float(itemsize * seq + 4 * rest),
            "fp32_simt")


def bwd_work(b: int, s: int, d: int, h: int,
             itemsize: int = 4) -> Tuple[float, float, str]:
    """The backward kernel's own work (d_rh and d_bias are plain products
    after it, counted as such): (operations, bytes, unit).  The
    pre-activations again and the recurrent adjoint, 2·dh for each of the
    4 gate columns of each (b, t, channel) each, and ~80 pointwise around
    them (the forward's 36 again and the adjoint's ~44).  Bytes: wx, hs,
    dys, rh, bias, h0 and the chunk states (c, n, m) read once; d_wx and
    the initial state's four cotangents written once; wx, hs, dys and d_wx
    at `itemsize` bytes, as ``work``'s."""
    dh = d // h
    seq = 2 * b * s * 4 * d + 2 * b * s * d
    rest = (h * dh * 4 * dh + 4 * d + b * d + 3 * b * n_chunks(s) * d
            + 4 * b * d)
    return (float(b * s * d * (16 * dh + 80)),
            float(itemsize * seq + 4 * rest), "fp32_simt")


def _row_groups(b: int) -> list:
    """The batch's rows in groups of at most MAX_BATCH, one launch each
    (rows are independent); a batch of none is one (refused) group."""
    return [slice(i, i + MAX_BATCH) for i in range(0, max(b, 1), MAX_BATCH)]


def _cat_rows(parts: list):
    """The row groups' results joined along the batch: (nested) tuples
    element by element, None kept; one group's as it is."""
    if len(parts) == 1 or parts[0] is None:
        return parts[0]
    if isinstance(parts[0], tuple):
        return tuple(_cat_rows(list(p)) for p in zip(*parts))
    return torch.cat(parts)


def _launch(name: str, err: int, d: int, device) -> None:
    if err == _TOO_LARGE:
        raise RuntimeError(f"{name}: its {d // CHANNELS} blocks cannot all be "
                           f"resident on {device} at once")
    if err != 0:
        raise RuntimeError(f"{name} launch failed with error {err}")


def slstm_scan_fwd(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
                   state, boundaries: bool = True):
    """The forward: (hs (B, S, D), the final (c, n, m, h)) and, with
    `boundaries`, the states (c, n, m) entering every chunk of CHUNK
    steps, each (B, ⌈S/CHUNK⌉, D), the initial state first.  CPU tensors
    take the plain loop; CUDA tensors launch ``slstm_scan_f32`` (counted
    in ``slstm_scan.launches``) or raise; meta tensors charge ``work``.
    Not differentiable itself: ``SLSTMScanFn`` is."""
    if _build.route(wx.device) == "plain":
        return _ref.slstm_scan(wx, rh, bias, state, chunk=CHUNK,
                               boundaries=boundaries)
    if wx.dim() == 3 and wx.shape[0] > MAX_BATCH:
        return _cat_rows([slstm_scan_fwd(wx[g], rh, bias,
                                         tuple(t[g] for t in state),
                                         boundaries)
                          for g in _row_groups(wx.shape[0])])
    _check(wx, rh, bias, state)
    b, s, four_d = wx.shape
    d = four_d // 4
    hs = torch.empty((b, s, d), dtype=wx.dtype, device=wx.device)
    out = tuple(torch.empty_like(t) for t in state)
    chunks = (tuple(torch.empty((b, n_chunks(s), d), dtype=state[0].dtype,
                                device=wx.device) for _ in range(3))
              if boundaries else (None,) * 3)
    if wx.is_meta:
        _cost.charge(_build.meta_name("slstm_scan_f32", wx.dtype),
                     *work(b, s, d, rh.shape[0], boundaries,
                           wx.element_size()))
        return (hs, out, chunks) if boundaries else (hs, out)
    lib = load_library()
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    with torch.cuda.device(wx.device):
        err = lib.slstm_scan_f32(
            wx.data_ptr(), rh.data_ptr(), bias.data_ptr(),
            *(t.data_ptr() for t in state), hs.data_ptr(),
            *(t.data_ptr() for t in out),
            *(None if t is None else t.data_ptr() for t in chunks),
            b, s, d, rh.shape[0], stream)
    _launch("slstm_scan_f32", err, d, wx.device)
    slstm_scan.launches += 1
    return (hs, out, chunks) if boundaries else (hs, out)


def slstm_scan_bwd(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
                   state, hs: torch.Tensor, chunks,
                   dys: Optional[torch.Tensor] = None, d_state=None):
    """The backward from the forward's inputs, its hs and chunk states and
    the cotangents of hs and of the final (c, n, m, h) (None, or any one
    None: zeros) -> (d_wx, d_rh, d_bias, dc0, dn0, dm0, dh0).  CPU tensors
    take the plain adjoint loop (``ref.slstm_scan_bwd``); CUDA tensors
    launch ``slstm_scan_bwd_f32`` (counted in ``slstm_scan_bwd.launches``;
    d_rh and d_bias are ``ref.slstm_weight_grads``'s plain products) or
    raise; meta tensors charge ``bwd_work`` and run those products on
    meta."""
    if _build.route(wx.device) == "plain":
        return _ref.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys,
                                   d_state, chunk=CHUNK)
    if dys is None:
        dys = torch.zeros_like(hs)
    d_state = tuple(d_state or (None,) * 4)
    rows = (lambda g, ts: tuple(None if t is None else t[g] for t in ts))
    d_wx, *d_init = _cat_rows([
        _bwd_rows(wx[g], rh, bias, rows(g, state), hs[g], rows(g, chunks),
                  dys[g], rows(g, d_state))
        for g in _row_groups(wx.shape[0] if wx.dim() == 3 else 0)])
    return (d_wx, *_ref.slstm_weight_grads(state[3], hs, d_wx, rh.shape[0]),
            *d_init)


def _bwd_rows(wx, rh, bias, state, hs, chunks, dys, d_state):
    """The backward kernel on at most MAX_BATCH rows: (d_wx, dc0, dn0,
    dm0, dh0)."""
    more = dict(hs=hs, dys=dys, **dict(zip(("c_chunks", "n_chunks",
                                            "m_chunks"), chunks)))
    more.update((k, g) for k, g in zip(("dc", "dn", "dm", "dh"), d_state)
                if g is not None)
    _check(wx, rh, bias, state, backward=True, **more)
    b, s, four_d = wx.shape
    d = four_d // 4
    d_wx = torch.empty_like(wx)
    d_init = tuple(torch.empty_like(t) for t in state)
    if wx.is_meta:
        _cost.charge(_build.meta_name("slstm_scan_bwd_f32", wx.dtype),
                     *bwd_work(b, s, d, rh.shape[0], wx.element_size()))
        return (d_wx, *d_init)
    work = torch.empty((b, CHUNK, KEPT, d), dtype=wx.dtype, device=wx.device)
    lib = load_library()
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    with torch.cuda.device(wx.device):
        err = lib.slstm_scan_bwd_f32(
            wx.data_ptr(), rh.data_ptr(), bias.data_ptr(),
            state[3].data_ptr(), hs.data_ptr(),
            *(t.data_ptr() for t in chunks), dys.data_ptr(),
            *(None if g is None else g.data_ptr() for g in d_state),
            d_wx.data_ptr(), *(t.data_ptr() for t in d_init),
            work.data_ptr(), b, s, d, rh.shape[0], stream)
    _launch("slstm_scan_bwd_f32", err, d, wx.device)
    slstm_scan_bwd.launches += 1
    return (d_wx, *d_init)


class SLSTMScanFn(torch.autograd.Function):
    """The sLSTM recurrence under autograd: the forward keeps its inputs,
    hs and the states entering each chunk of CHUNK steps; the backward is
    ``slstm_scan_bwd``.  Under ``torch.utils.checkpoint`` the forward runs
    again in the backward and makes them again."""

    @staticmethod
    def forward(ctx, wx, rh, bias, c0, n0, m0, h0):
        state = (c0, n0, m0, h0)
        hs, out, chunks = slstm_scan_fwd(wx, rh, bias, state)
        ctx.save_for_backward(wx, rh, bias, *state, hs, *chunks)
        ctx.set_materialize_grads(False)
        return (hs, *out)

    @staticmethod
    def backward(ctx, dys, *d_state):
        wx, rh, bias, c0, n0, m0, h0, hs, *chunks = ctx.saved_tensors
        grads = slstm_scan_bwd(
            wx, rh, bias, (c0, n0, m0, h0), hs, chunks,
            None if dys is None else dys.contiguous(),
            tuple(None if g is None else g.contiguous() for g in d_state))
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def slstm_scan(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
               state):
    """The sLSTM's recurrence: wx (B, S, 4D), rh (H, dh, 4dh), bias (4D,),
    state (c, n, m, h) each (B, D) -> (hs (B, S, D), the final state).

    Inputs that need a gradient go through ``SLSTMScanFn`` (CPU: the plain
    loop and the plain adjoint loop; CUDA: the two kernels).  Otherwise
    CPU tensors take the plain loop and CUDA tensors launch
    ``slstm_scan_f32`` (counted in ``slstm_scan.launches``) or raise."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (wx, rh, bias, *state)):
        hs, *out = SLSTMScanFn.apply(wx, rh, bias, *state)
        return hs, tuple(out)
    if _build.route(wx.device) == "plain":
        return _ref.slstm_scan(wx, rh, bias, state)
    return slstm_scan_fwd(wx, rh, bias, state, boundaries=False)


#: calls that launched the forward kernel (not the CPU plain-version route)
slstm_scan.launches = 0  # type: ignore[attr-defined]
#: calls that launched the backward kernel (ditto)
slstm_scan_bwd.launches = 0  # type: ignore[attr-defined]
