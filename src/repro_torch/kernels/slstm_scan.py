"""The sLSTM recurrence of xLSTM on the card: the hand-written CUDA kernel
in ``csrc/slstm_scan.cu`` and its wrapper.

Replaces no Pallas kernel: the reference's recurrence is the ``cell`` of
``nn/xlstm.slstm_apply`` (reference package) under its
``_chunked_scan``/``lax.scan``, which XLA compiles; eager torch would
take ~15 launches a time step, so on the card it is one launch a layer
for the whole sequence (and one a decode step, at S = 1).  A persistent
grid, launched cooperatively: each block owns 16 channels' four gate
columns, its threads keep those columns of rh in registers, form the
pre-activations from h_{t-1} (staged in shared memory) and update c, n,
m in registers, then wait at a grid barrier before the next step.
Float32, sums in a fixed order: the same inputs give the same bits on
every run.

Bound on an H100 SXM at xlstm-1.3b's prefill (2 x 4096 x 2048, H 4): the
recurrent products' 68.7 GFLOP at the 67 TFLOP/s float32 peak (1.03 ms)
over the 352 MB of wx, hs and rh (0.105 ms); and the S dependent steps,
each a grid-wide exchange of h, set a latency floor above both.

The device rule lives here: a CPU tensor gets the plain loop
(``kernels/ref.slstm_scan``, differentiable by torch's autograd); a CUDA
tensor gets the kernel or an exception (a card that is not sm_90, a
failed build, a shape, dtype or layout the kernel does not take, a grid
that cannot be co-resident, a refused launch, or inputs that need a
gradient: the kernel has no backward yet, so ``use_fused=False`` is the
route for training on the card).  Nothing falls back.
``kernels/ops.slstm_scan`` adds only the caller's ``use_fused=False``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

SOURCE = _build.CSRC / "slstm_scan.cu"
#: batch rows the kernel is built for (a template parameter: 1..MAX_BATCH)
MAX_BATCH = 8
#: channels a block owns (D must be a multiple), and the threads that
#: share one gate column's dot product
CHANNELS, PARTS = 16, 4
#: head widths the kernel is built for (dh / PARTS weights in registers,
#: a template parameter)
HEAD_DIMS = (16, 32, 64, 128, 256, 512)
#: a block's shared memory on sm_90, bytes
SMEM_LIMIT = 232448
#: cudaErrorCooperativeLaunchTooLarge
_TOO_LARGE = 82


def _bind(lib: ctypes.CDLL) -> None:
    lib.slstm_scan_f32.argtypes = ([ctypes.c_void_p] * 12
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.slstm_scan_f32.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source revision) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def smem_bytes(b: int, d: int) -> int:
    """A block's dynamic shared memory: h_{t-1} of every row (B x D) and
    the partial sums (4 x B x 64), float32."""
    return 4 * (b * d + PARTS * b * 4 * CHANNELS)


def _check(wx, rh, bias, state) -> None:
    """The operands against wx's and rh's shapes and what the kernel takes;
    then the card and each tensor's dtype, layout and device."""
    if wx.dim() != 3 or rh.dim() != 3:
        raise ValueError(f"wx must be (B, S, 4D) and rh (H, dh, 4dh); got "
                         f"{tuple(wx.shape)} and {tuple(rh.shape)}")
    b, s, four_d = wx.shape
    h, dh = rh.shape[0], rh.shape[1]
    d = four_d // 4
    shapes = {"wx": (b, s, 4 * d), "rh": (h, dh, 4 * dh), "bias": (4 * d,),
              "c": (b, d), "n": (b, d), "m": (b, d), "h": (b, d)}
    named = dict(wx=wx, rh=rh, bias=bias, **dict(zip("cnmh", state)))
    if len(state) != 4 or h * dh != d:
        raise ValueError(f"rh {tuple(rh.shape)} does not split D = {d} into "
                         f"heads, or the state is not (c, n, m, h)")
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if s < 1 or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"the sLSTM kernel takes 1..{MAX_BATCH} rows and "
                         f"S >= 1; got B = {b}, S = {s}")
    if d % CHANNELS or dh not in HEAD_DIMS:
        raise ValueError(f"the sLSTM kernel takes D a multiple of {CHANNELS} "
                         f"and dh one of {HEAD_DIMS}; got D = {d}, dh = {dh}")
    if smem_bytes(b, d) > SMEM_LIMIT:
        raise ValueError(f"the sLSTM kernel at B = {b}, D = {d} needs "
                         f"{smem_bytes(b, d)} bytes of shared memory a "
                         f"block, more than {SMEM_LIMIT}")
    _build.check_card(wx.device, "the sLSTM kernel")
    _build.check_operands(wx.device, named.items())


def slstm_scan(wx: torch.Tensor, rh: torch.Tensor, bias: torch.Tensor,
               state):
    """The sLSTM's recurrence: wx (B, S, 4D), rh (H, dh, 4dh), bias (4D,),
    state (c, n, m, h) each (B, D) -> (hs (B, S, D), the final state).

    CPU tensors take the plain loop (``ref.slstm_scan``).  CUDA tensors
    launch ``slstm_scan_f32`` (counted in ``slstm_scan.launches``) or
    raise."""
    if wx.device.type == "cpu":
        return _ref.slstm_scan(wx, rh, bias, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (wx, rh, bias, *state)):
        raise NotImplementedError(
            "the sLSTM kernel has no backward yet (ROADMAP Queue 1): pass "
            "use_fused=False to differentiate the plain loop")
    _check(wx, rh, bias, state)
    b, s, four_d = wx.shape
    d = four_d // 4
    hs = torch.empty((b, s, d), dtype=wx.dtype, device=wx.device)
    out = tuple(torch.empty_like(t) for t in state)
    lib = load_library()
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    with torch.cuda.device(wx.device):
        err = lib.slstm_scan_f32(
            wx.data_ptr(), rh.data_ptr(), bias.data_ptr(),
            *(t.data_ptr() for t in state), hs.data_ptr(),
            *(t.data_ptr() for t in out), b, s, d, rh.shape[0], stream)
    if err == _TOO_LARGE:
        raise RuntimeError(f"slstm_scan_f32: its {d // CHANNELS} blocks "
                           f"cannot all be resident on {wx.device} at once")
    if err != 0:
        raise RuntimeError(f"slstm_scan_f32 launch failed with error {err}")
    slstm_scan.launches += 1
    return hs, out


#: calls that launched the kernel (not the CPU plain-version route)
slstm_scan.launches = 0  # type: ignore[attr-defined]
