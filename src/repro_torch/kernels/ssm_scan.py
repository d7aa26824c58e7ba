"""The selective scan of hymba's SSM branch on the card: the hand-written
CUDA kernels in ``csrc/ssm_scan.cu`` (forward and backward), their
wrappers and ``SSMScanFn``, the autograd Function over them.

Replaces no Pallas kernel: the reference's recurrence is the inner
``lax.scan`` of ``nn/ssm.ssm_scan`` (reference package), which XLA
compiles and differentiates; eager torch would take launches a time
step, so on the card it is one kernel a layer each way.  Float32: the
state (B, Di, N) stays in registers over one pass of the sequence, a
thread a (b, d, n), and the sums over n are a fixed butterfly across a
channel's N lanes.  The backward walks the sequence from the end, the
state's adjoint in a register, recomputing each chunk's states from the
state the forward stored at the chunk's start (every CHUNK steps, as the
reference's ``jax.checkpoint``-ed chunks keep them); its sums over the
channels cross blocks and are added in a fixed order by a second kernel,
no atomics.  The same inputs give the same bits on every run.  N is 4,
8, 16 or 32.

Bound on an H100 SXM: the bytes of dt, x and ys (B, S, Di) over 3.35 TB/s
forward; of dt, x, dys, d_dt and d_x backward; the B·S·Di·N exponentials
and the few float32 operations around each come second.

The device rule lives here (``build.route``): a CPU tensor gets the plain
versions (``kernels/ref.ssm_scan``, ``ref.ssm_scan_bwd``); a CUDA tensor
gets the kernels or an exception (a card that is not sm_90, a failed
build, an unsupported shape, dtype or layout, a refused launch); a meta
tensor gets empty meta outputs (the chunk states too) and charges
``work`` or ``bwd_work`` to ``utils/op_cost``'s counter, with no launch;
bf16 operands there (the cost tools' default) are counted as the float32
kernel's work at their own bytes, under ``build.meta_name``'s name.
Nothing falls back.  Inputs that need a gradient go through
``SSMScanFn`` on either device.  ``kernels/ops.ssm_scan`` adds only the
caller's ``use_fused=False``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref
from repro_torch.utils import op_cost as _cost

SOURCE = _build.CSRC / "ssm_scan.cu"
STATE_SIZES = (4, 8, 16, 32)
#: steps between the states the forward keeps for the backward (the
#: kernel's CHUNK, and the reference's chunk)
CHUNK = 64


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssm_scan_f32.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p])
    lib.ssm_scan_f32.restype = ctypes.c_int
    lib.ssm_scan_bwd_workspace.argtypes = [ctypes.c_int] * 4
    lib.ssm_scan_bwd_workspace.restype = ctypes.c_longlong
    lib.ssm_scan_bwd_f32.argtypes = ([ctypes.c_void_p] * 15
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.ssm_scan_bwd_f32.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source revision) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def n_chunks(s: int) -> int:
    return -(-s // CHUNK)


def _check(dt, bmat, cmat, x, a, **more) -> None:
    """The scan's operands (and `more`, by name) against dt's and a's
    shapes; then the card and each tensor's dtype, layout and device."""
    b, s, di = dt.shape
    n = a.shape[-1]
    shapes = {"dt": (b, s, di), "bmat": (b, s, n), "cmat": (b, s, n),
              "x": (b, s, di), "a": (di, n), "h0": (b, di, n),
              "h_chunks": (b, n_chunks(s), di, n), "dys": (b, s, di),
              "dh_last": (b, di, n)}
    named = dict(dt=dt, bmat=bmat, cmat=cmat, x=x, a=a, **more)
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} is not one the kernel is built for "
                         f"{STATE_SIZES}")
    if dt.device.type == "cuda":
        _build.check_card(dt.device, "the selective-scan kernel")
    _build.check_operands(dt.device, named.items())


def work(b: int, s: int, di: int, n: int, boundaries: bool = False,
         itemsize: int = 4) -> Tuple[float, float, str]:
    """The forward's own work: (operations, bytes, unit).  At each (b, t,
    d, n) the product dt·a, the exponential, two products dt·b·x, a fused
    multiply-add (2) and h·c with its add to the sum over n: 8 float32
    operations on the SIMT cores (``fp32_simt``), an exponential counted
    as one.  Bytes: dt, x, bmat, cmat, a and h0 read once, ys and the
    final state (and the chunk states) written once; the (B, S, ·)
    sequences at `itemsize` bytes an element (the meta route's operands'),
    a, h0 and the states at float32's 4."""
    seq = 3 * b * s * di + 2 * b * s * n
    states = di * n + 2 * b * di * n
    if boundaries:
        states += b * n_chunks(s) * di * n
    return 8.0 * b * s * di * n, float(itemsize * seq + 4 * states), \
        "fp32_simt"


def bwd_work(b: int, s: int, di: int, n: int,
             itemsize: int = 4) -> Tuple[float, float, str]:
    """The backward's own work: (operations, bytes, unit).  At each (b,
    t, d, n) the state again (6, as the forward's) and the adjoint's 20
    (g's fused multiply-add, exp(dt·a), its product with h, g·dt, d_a's
    fused multiply-add, d_dt's term (4) and sum, d_x's product and sum,
    d_b's and d_c's products and sums, the carry): 26 float32 operations.
    Bytes: dt, x, dys, bmat, cmat, a and the chunk states read once;
    d_dt, d_x, d_bmat, d_cmat, d_a and d_h0 written once (the partial
    sums the kernel writes and reads again are its own choice); the
    sequences at `itemsize` bytes, as ``work``'s."""
    seq = 5 * b * s * di + 4 * b * s * n
    states = 2 * di * n + b * n_chunks(s) * di * n + b * di * n
    return 26.0 * b * s * di * n, float(itemsize * seq + 4 * states), \
        "fp32_simt"


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def ssm_scan_fwd(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                 boundaries: bool = True):
    """The forward: (ys (B, S, Di), h (B, Di, N)) and, with `boundaries`,
    the state entering every chunk of CHUNK steps, h_chunks (B,
    ⌈S/CHUNK⌉, Di, N), h0 first.  CPU tensors take the plain loop; CUDA
    tensors launch ``ssm_scan_f32`` (counted in ``ssm_scan.launches``)
    or raise; meta tensors charge ``work``.  Not differentiable itself:
    ``SSMScanFn`` is."""
    if _build.route(dt.device) == "plain":
        return _ref.ssm_scan(dt, bmat, cmat, x, a, h0, chunk=CHUNK,
                             boundaries=boundaries)
    _check(dt, bmat, cmat, x, a, h0=h0)
    b, s, di = dt.shape
    n = a.shape[-1]
    ys = torch.empty_like(dt)
    h = torch.empty_like(h0)
    h_chunks = (torch.empty((b, n_chunks(s), di, n), dtype=h0.dtype,
                            device=dt.device) if boundaries else None)
    if dt.is_meta:
        _cost.charge(_build.meta_name("ssm_scan_f32", dt.dtype),
                     *work(b, s, di, n, boundaries, dt.element_size()))
        return (ys, h, h_chunks) if boundaries else (ys, h)
    lib = load_library()
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    with torch.cuda.device(dt.device):
        err = lib.ssm_scan_f32(
            dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), x.data_ptr(),
            a.data_ptr(), h0.data_ptr(), ys.data_ptr(), h.data_ptr(),
            None if h_chunks is None else h_chunks.data_ptr(), b, s, di, n,
            stream)
    _launch("ssm_scan_f32", err)
    ssm_scan.launches += 1
    return (ys, h, h_chunks) if boundaries else (ys, h)


def ssm_scan_bwd(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 x: torch.Tensor, a: torch.Tensor, h_chunks: torch.Tensor,
                 dys: torch.Tensor, dh_last: Optional[torch.Tensor] = None):
    """The backward from the forward's inputs, its h_chunks and the
    cotangents of ys and of the final state (None: zeros) -> (d_dt,
    d_bmat, d_cmat, d_x, d_a, d_h0).  CPU tensors take the plain adjoint
    loop (``ref.ssm_scan_bwd``); CUDA tensors launch ``ssm_scan_bwd_f32``
    (counted in ``ssm_scan_bwd.launches``) or raise; meta tensors charge
    ``bwd_work``."""
    if _build.route(dt.device) == "plain":
        return _ref.ssm_scan_bwd(dt, bmat, cmat, x, a, h_chunks, dys,
                                 dh_last, chunk=CHUNK)
    more = dict(h_chunks=h_chunks, dys=dys)
    if dh_last is not None:
        more["dh_last"] = dh_last
    _check(dt, bmat, cmat, x, a, **more)
    b, s, di = dt.shape
    n = a.shape[-1]
    d_dt, d_x = torch.empty_like(dt), torch.empty_like(x)
    d_b, d_c = torch.empty_like(bmat), torch.empty_like(cmat)
    d_a = torch.empty_like(a)
    d_h0 = torch.empty((b, di, n), dtype=h_chunks.dtype, device=dt.device)
    if dt.is_meta:
        _cost.charge(_build.meta_name("ssm_scan_bwd_f32", dt.dtype),
                     *bwd_work(b, s, di, n, dt.element_size()))
        return d_dt, d_b, d_c, d_x, d_a, d_h0
    lib = load_library()
    work = torch.empty(lib.ssm_scan_bwd_workspace(b, s, di, n),
                       dtype=dt.dtype, device=dt.device)
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    with torch.cuda.device(dt.device):
        err = lib.ssm_scan_bwd_f32(
            dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), x.data_ptr(),
            a.data_ptr(), h_chunks.data_ptr(), dys.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), d_dt.data_ptr(),
            d_b.data_ptr(), d_c.data_ptr(), d_x.data_ptr(), d_a.data_ptr(),
            d_h0.data_ptr(), work.data_ptr(), b, s, di, n, stream)
    _launch("ssm_scan_bwd_f32", err)
    ssm_scan_bwd.launches += 1
    return d_dt, d_b, d_c, d_x, d_a, d_h0


class SSMScanFn(torch.autograd.Function):
    """The selective scan under autograd: the forward keeps the inputs and
    the states at chunk starts (h_chunks, (B, ⌈S/64⌉, Di, N)); the
    backward is ``ssm_scan_bwd``.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward and makes h_chunks again."""

    @staticmethod
    def forward(ctx, dt, bmat, cmat, x, a, h0):
        ys, h, h_chunks = ssm_scan_fwd(dt, bmat, cmat, x, a, h0)
        ctx.save_for_backward(dt, bmat, cmat, x, a, h_chunks)
        ctx.set_materialize_grads(False)
        return ys, h

    @staticmethod
    def backward(ctx, dys, dh_last):
        dt, bmat, cmat, x, a, h_chunks = ctx.saved_tensors
        dys = torch.zeros_like(dt) if dys is None else dys.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        grads = ssm_scan_bwd(dt, bmat, cmat, x, a, h_chunks, dys, dh_last)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def ssm_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
             chunk: int = 64):
    """The selective scan's recurrence: dt, x (B, S, Di), bmat, cmat
    (B, S, N), a (Di, N), h0 (B, Di, N) -> (ys (B, S, Di), h (B, Di, N)).

    Inputs that need a gradient go through ``SSMScanFn`` (CPU: the plain
    loop and the plain adjoint loop; CUDA: the two kernels).  Otherwise
    CPU tensors take the plain loop (in chunks of `chunk` steps) and CUDA
    tensors launch the forward kernel (counted in ``ssm_scan.launches``)
    or raise."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, bmat, cmat, x, a, h0)):
        return SSMScanFn.apply(dt, bmat, cmat, x, a, h0)
    if _build.route(dt.device) == "plain":
        return _ref.ssm_scan(dt, bmat, cmat, x, a, h0, chunk=chunk)
    return ssm_scan_fwd(dt, bmat, cmat, x, a, h0, boundaries=False)


#: calls that launched the forward kernel (not the CPU plain-version route)
ssm_scan.launches = 0  # type: ignore[attr-defined]
#: calls that launched the backward kernel (ditto)
ssm_scan_bwd.launches = 0  # type: ignore[attr-defined]
