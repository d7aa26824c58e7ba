"""The selective scan of hymba's SSM branch on the card: the hand-written
CUDA kernel in ``csrc/ssm_scan.cu`` and its wrapper.

Replaces no Pallas kernel: the reference's recurrence is the inner
``lax.scan`` of ``nn/ssm.ssm_scan`` (reference package), which XLA
compiles; eager torch would take launches a time step, so on the card it
is one kernel a layer.  Forward only, float32: the state (B, Di, N) stays
in registers over one pass of the sequence, a thread a (b, d, n), and y's
sum over n is a fixed butterfly across a channel's N lanes (the same
inputs give the same bits on every run).  N is 4, 8, 16 or 32.

Bound on an H100 SXM: the bytes of dt, x and ys (B, S, Di) and of bmat,
cmat (B, S, N) over 3.35 TB/s; the B·S·Di·N exponentials and seven more
float32 operations each come second.

The device rule lives here: a CPU tensor gets the plain version
(``kernels/ref.ssm_scan``); a CUDA tensor gets the kernel or an exception
(a card that is not sm_90, a failed build, an unsupported shape, dtype or
layout, a refused launch).  Nothing falls back.  There is no backward
kernel yet, so a CUDA input that needs a gradient raises
``NotImplementedError`` rather than taking the plain loop quietly
(ROADMAP Queue 1, "hymba training on the card").
``kernels/ops.ssm_scan`` adds only the caller's ``use_fused=False``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

SOURCE = _build.CSRC / "ssm_scan.cu"
STATE_SIZES = (4, 8, 16, 32)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssm_scan_f32.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p])
    lib.ssm_scan_f32.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source revision) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def _check(dt, bmat, cmat, x, a, h0) -> None:
    b, s, di = dt.shape
    n = a.shape[-1]
    want = {"dt": (b, s, di), "bmat": (b, s, n), "cmat": (b, s, n),
            "x": (b, s, di), "a": (di, n), "h0": (b, di, n)}
    for name, t in zip(want, (dt, bmat, cmat, x, a, h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} is not one the kernel is built for "
                         f"{STATE_SIZES}")
    _build.check_card(dt.device, "the selective-scan kernel")
    _build.check_operands(dt.device, zip(want, (dt, bmat, cmat, x, a, h0)))


def ssm_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
             chunk: int = 64):
    """The selective scan's recurrence: dt, x (B, S, Di), bmat, cmat
    (B, S, N), a (Di, N), h0 (B, Di, N) -> (ys (B, S, Di), h (B, Di, N)).

    CPU tensors take the plain version (its loop in chunks of `chunk`
    steps); CUDA tensors launch the kernel (counted in
    ``ssm_scan.launches``) or raise."""
    if dt.device.type == "cpu":
        return _ref.ssm_scan(dt, bmat, cmat, x, a, h0, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, bmat, cmat, x, a, h0)):
        raise NotImplementedError(
            "the selective-scan kernel has no backward yet (ROADMAP Queue 1, "
            "hymba training on the card); pass use_fused=False for the "
            "plain loop under autograd")
    _check(dt, bmat, cmat, x, a, h0)
    b, s, di = dt.shape
    n = a.shape[-1]
    ys = torch.empty_like(dt)
    h = torch.empty_like(h0)
    lib = load_library()
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    with torch.cuda.device(dt.device):
        err = lib.ssm_scan_f32(dt.data_ptr(), bmat.data_ptr(),
                               cmat.data_ptr(), x.data_ptr(), a.data_ptr(),
                               h0.data_ptr(), ys.data_ptr(), h.data_ptr(),
                               b, s, di, n, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_f32 launch failed with CUDA error {err}")
    ssm_scan.launches += 1
    return ys, h


#: calls that launched the kernel (not the CPU plain-version route)
ssm_scan.launches = 0  # type: ignore[attr-defined]
