"""GQA flash-attention forward on the card: the hand-written CUDA kernel in
``csrc/flash_attention.cu`` and its wrapper.

Replaces the Pallas kernel ``_flash_kernel`` (reference package,
``kernels/flash_attention.py``, public ``flash_attention``): causal and
sliding-window masks with the finite ``NEG_INF``, an online softmax in
float32, the key tiles outside the band skipped, ``q_offset`` for a
continued prefill, kv head = q head // group read in place.  float32 or
bf16 in, float32-accurate arithmetic on the tensor cores (3xTF32 for
float32; exact bf16 products and a bf16 hi + lo split of P for bf16), the
output in q's dtype.  Head dims 16, 32, 64, 128 and 256.  With
``return_lse=True`` it also returns each row's log-sum-exp of its scaled,
masked scores, (B, H, Sq) float32, from the instantiations that store it
(the residual of the autograd Function in ``nn/attention``); the output's
bits are the same either way.

The wrapper takes (B, H, S, D) tensors whose last dim is contiguous and
passes the other three strides to the kernel, so a (B, S, H, D) tensor
viewed with ``transpose(1, 2)`` is read in place; the output is allocated
in q's own layout (``empty_like``), so ``nn/attention`` gets (B, S, H, D)
back without a copy.  Rows are copied 16 bytes at a time, so each row
must start on a 16-byte boundary.

Bound on an H100 SXM, the way the kernel computes: per kept (query, key)
pair 12·D flops of TF32 products at 495 TFLOP/s (float32) or 6·D of bf16
at 989 TFLOP/s; the bytes of q, k, v and o are two orders of magnitude
smaller at the LM's shapes.

The device rule lives here (``build.route``): a CPU tensor gets the plain
version (``kernels/ref.flash_attention``); a CUDA tensor gets the kernel
or an exception (a card that is not sm_90, a failed build, an unsupported
head dim, dtype or layout, a refused launch) — nothing falls back; a meta
tensor gets empty meta outputs of the kernel's shapes, dtypes and strides,
launches nothing and charges ``work`` to ``utils/op_cost``'s counter.
``kernels/ops.flash_attention`` adds only the caller's ``use_fused=False``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref
from repro_torch.utils import op_cost as _cost

SOURCE = _build.CSRC / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def _bind(lib: ctypes.CDLL) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source revision) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, H, Sq, D) and k, v (B, Hkv, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if q.device.type == "cuda":
        _build.check_card(q.device, "the flash-attention kernel")
    if q.dtype not in _ENTRY:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    # the kernel copies 16 bytes at a time along d: rows must be aligned
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s % per16 for s, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1):
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned "
                             f"last dim, got strides {t.stride()}")


def kept_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
               q_offset: int) -> int:
    """(query, key) pairs the masks keep for one head: what the kernel's
    arithmetic scales with (it skips the key tiles outside the band)."""
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(b: int, h: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
         window: Optional[int], q_offset: int, dtype: torch.dtype,
         lse: bool = False) -> Tuple[float, float, str]:
    """One call's own work: (flops, bytes, unit).  float32: the 4·D flops
    of QKᵀ and PV for every kept (query, key) pair, on the 3xTF32 tile
    (``tf32x3``); bf16: 6·D a pair (QKᵀ once, PV twice for P's hi + lo
    split) on the bf16 tensor cores.  Bytes: q, k and v read once, o (and
    lse) written once."""
    size = torch.empty((), dtype=dtype).element_size()
    n_bytes = size * (2 * b * h * sq * d + 2 * b * hkv * sk * d)
    if lse:
        n_bytes += 4 * b * h * sq
    pairs = b * h * kept_pairs(sq, sk, causal, window, q_offset)
    if dtype == torch.float32:
        return 4.0 * d * pairs, float(n_bytes), "tf32x3"
    return 6.0 * d * pairs, float(n_bytes), "bf16"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, return_lse: bool = False):
    """GQA attention forward: q (B, H, Sq, D), k and v (B, Hkv, Sk, D) ->
    (B, H, Sq, D) in q's dtype and layout, and with ``return_lse`` also
    the (B, H, Sq) float32 log-sum-exp of each row.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``, and those that also store
    lse in ``flash_attention.lse_launches``) or raise; meta tensors get
    the outputs' shapes and charge ``work``."""
    if _build.route(q.device) == "plain":
        return _ref.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, return_lse=return_lse)
    _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    b, h, sq, d = q.shape
    out = torch.empty_like(q)           # q's layout where q is dense
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.device.type == "meta":
        _cost.charge(_ENTRY[q.dtype] + " with lse" * return_lse, *work(
            b, h, k.shape[1], sq, k.shape[2], d, causal, window, q_offset,
            q.dtype, return_lse))
        return (out, lse) if return_lse else out
    lib = load_library()
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, b, h,
            k.shape[1], sq, k.shape[2], d, strides, int(causal),
            window or 0, q_offset, 1.0 / d ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[q.dtype]} launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    if return_lse:
        flash_attention.lse_launches += 1
        return out, lse
    return out


#: calls that launched the kernel (not the CPU plain-version route)
flash_attention.launches = 0  # type: ignore[attr-defined]
#: of those, the launches that also stored lse
flash_attention.lse_launches = 0  # type: ignore[attr-defined]
