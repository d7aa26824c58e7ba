"""Whole-MLP forward on the card: the hand-written CUDA kernel in
``csrc/mlp_forward.cu`` and its wrapper.

Replaces the Pallas megakernel ``_mlp_kernel`` (reference package,
``kernels/fused_mlp.py``, driver ``_mlp_forward``, public ``fused_mlp``):
hidden layers ``relu(h @ W + b)`` and a linear head, float32 with float32
accumulation.  The TPU kernel padded every layer onto one (h, h) square
and kept the activations in VMEM; this kernel keeps each layer's own
shape, masks the ragged edges, and ping-pongs the activations through two
scratch buffers (about 512 KB at 64 rows, resident in the 50 MB L2).
Each layer is one launch of the tensor-core tile of
``csrc/gemm_3xtf32.cuh`` (3xTF32: float32-accurate), shared with the
training kernels of ``kernels/fused_dense.py``, with the bias and ReLU in
its epilogue.  Layers with K >= 512 are cut into K slices by K alone,
summed in order either across the grid (partial tiles in a workspace the
wrapper allocates, then a second kernel) or inside each block, whichever
the shape favours; each way gives a row the same bits, so a row's bits do
not depend on the batch.

Bound on an H100 SXM: for the im2col generator at 64 rows (~42.1 M
weights, ~169 MB read once) the bytes at 3.35 TB/s (~51 us) outweigh
three TF32 products at 495 TFLOP/s (~33 us); PERF.md keeps the measured
time beside the bound.

The kernel is built with ``nvcc`` at first use from the sources in this
package into ``kernels/build/`` (``kernels/build.py``: a plain C
interface, loaded with ctypes) and launched on PyTorch's current stream.

The device rule lives in each kernel's wrapper, here ``fused_mlp``
(``build.route``): a CPU tensor gets the plain version
(``kernels/ref.py``); a CUDA tensor gets the kernel or an exception (a
card that is not sm_90, a failed build, a refused launch) — nothing falls
back; a meta tensor gets an empty meta output and charges ``work`` to
``utils/op_cost``'s counter, with no launch.  ``kernels/dispatch.py``
only adds the caller's ``use_fused=False`` opt-out.

Both routes are differentiable, as the reference's ``custom_vjp`` is: the
plain version through autograd, the kernel through ``FusedMLP``, whose
backward re-runs the layer chain on the dense kernels of
``kernels/fused_dense.py`` (their launches count in their own wrappers).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import fused_dense as _fd
from repro_torch.kernels import ref as _ref
from repro_torch.utils import op_cost as _cost

SOURCE = _build.CSRC / "mlp_forward.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.mlp_forward_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.mlp_forward_f32_workspace
    ws.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    ws.restype = ctypes.c_longlong


def load_library() -> ctypes.CDLL:
    """Build (once per source revision) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def _check(x: torch.Tensor, ws: Sequence[torch.Tensor],
           bs: Sequence[torch.Tensor]) -> None:
    if len(ws) != len(bs) or not ws:
        raise ValueError(f"need one bias per weight, got {len(ws)} and {len(bs)}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D_in), got shape {tuple(x.shape)}")
    if x.device.type == "cuda":
        _build.check_card(x.device, "the whole-MLP kernel")
    width = x.shape[1]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: w {tuple(w.shape)} / b "
                             f"{tuple(b.shape)} do not chain from width {width}")
        width = w.shape[1]
    _build.check_operands(x.device, [
        ("x", x), *((f"w{i}", w) for i, w in enumerate(ws)),
        *((f"b{i}", b) for i, b in enumerate(bs))])


def work(m: int, dims: Sequence[int]) -> Tuple[float, float, str]:
    """One call's own work over layers of widths ``dims`` (input first):
    (flops, bytes, unit), the layers' 2·M·K·N products on the 3xTF32 tile
    (``tf32x3``), and x, every weight and bias read once and the output
    written once (the activations stay in L2)."""
    pairs = list(zip(dims[:-1], dims[1:]))
    n_bytes = m * dims[0] + sum(k * n + n for k, n in pairs) + m * dims[-1]
    return 2.0 * m * sum(k * n for k, n in pairs), 4.0 * n_bytes, "tf32x3"


def _launch(x: torch.Tensor, ws: Sequence[torch.Tensor],
            bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One C call of the kernel (one grid per layer), counted once in
    ``fused_mlp.launches``."""
    _check(x, ws, bs)
    m = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    out = torch.empty((m, dims[-1]), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    if x.is_meta:
        _cost.charge("mlp_forward_f32", *work(m, dims))
        return out
    lib = load_library()
    n = len(ws)
    dims_c = (ctypes.c_int * (n + 1))(*dims)
    w_ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws])
    b_ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bs])
    hidden = max(dims[1:-1], default=1)
    act = torch.empty((2, m, hidden), dtype=torch.float32, device=x.device)
    # split-K partial tiles (see the kernel's header note)
    scratch = torch.empty(max(lib.mlp_forward_f32_workspace(dims_c, n, m), 1),
                          dtype=torch.float32, device=x.device)
    # act and scratch are freed on return while the kernels may still run:
    # safe, because the caching allocator reuses their memory only for
    # work queued later on this same stream
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mlp_forward_f32(x.data_ptr(), w_ptrs, b_ptrs, dims_c, n, m,
                                  act[0].data_ptr(), act[1].data_ptr(),
                                  scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlp_forward_f32 launch failed with CUDA error {err}")
    fused_mlp.launches += 1
    return out


def chain_vjp(x: torch.Tensor, ws: Sequence[torch.Tensor],
              bs: Sequence[torch.Tensor], dy: torch.Tensor,
              needs: Sequence[bool]) -> list:
    """The whole MLP's gradients, as the reference's ``_fused_mlp_vjp``
    takes them: the layer chain re-run through ``fused_dense`` (hidden
    ReLU, linear head) and differentiated through its backward.  On CUDA
    tensors that is the dense forward, dx and dW/db kernels, counted in
    their own wrappers; on CPU tensors their plain versions.  `needs`
    flags x, every w, then every b; a gradient not needed is None and its
    kernel is not launched."""
    n = len(ws)
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip([x, *ws, *bs], needs)]
    with torch.enable_grad():
        h = leaves[0]
        for i in range(n):
            h = _fd.fused_dense(h, leaves[1 + i], leaves[1 + n + i],
                                relu=i < n - 1)
        want = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(h, want, dy) if want else ())
    return [next(grads) if t.requires_grad else None for t in leaves]


class FusedMLP(torch.autograd.Function):
    """The whole-MLP kernel's forward with the reference's gradient: the
    backward re-runs the layer chain through the dense kernels
    (`chain_vjp`) rather than shipping a second whole-MLP kernel, as
    ``_fused_mlp_vjp`` does.  Inputs: x, then the n weights, then the n
    biases."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, *wb: torch.Tensor) -> torch.Tensor:
        n = len(wb) // 2
        ctx.save_for_backward(x, *wb)
        return _launch(x, wb[:n], wb[n:])

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, *wb = ctx.saved_tensors
        n = len(wb) // 2
        return tuple(chain_vjp(x, wb[:n], wb[n:], dy.contiguous(),
                               ctx.needs_input_grad))


def fused_mlp(x: torch.Tensor, ws: Sequence[torch.Tensor],
              bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whole-MLP forward (hidden ReLU, linear head): x (M, D_in), per-layer
    w (K_l, N_l) and b (N_l,) -> (M, N_last) float32, differentiable on
    both routes.

    CPU tensors take the plain version (differentiated by autograd); CUDA
    tensors launch the kernel (one grid per layer from one C call, counted
    once in ``fused_mlp.launches``) or raise, and differentiate through
    `FusedMLP`; meta tensors take `FusedMLP` too, its charges in place of
    the launches."""
    if _build.route(x.device) == "plain":
        return _ref.fused_mlp(x, ws, bs)
    if len(ws) != len(bs):
        raise ValueError(f"need one bias per weight, got {len(ws)} and {len(bs)}")
    return FusedMLP.apply(x, *ws, *bs)


#: calls that launched the kernel (not the CPU plain-version route)
fused_mlp.launches = 0  # type: ignore[attr-defined]
