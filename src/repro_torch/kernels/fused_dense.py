"""The dense layer of Algorithm 1's training step on the card: three
hand-written CUDA kernels (``csrc/dense_train.cu``), their wrappers, and
the autograd function that joins them.

Replaces the reference package's Pallas kernels of ``kernels/fused_mlp.py``
— ``_fused_dense_kernel`` (y = [relu](x·W + b)), ``_dx_kernel`` (dx =
g·Wᵀ) and ``_dw_db_kernel`` (dW = xᵀ·g, db = Σ_M g), with g = dy ⊙ [y > 0]
recomputed from the saved output — and their ``custom_vjp``
(``_fused_dense_vjp``), whose residuals ``(x, W, y)`` ``FusedDense``
saves too.  Every G and D layer of the training step runs through them
(``nn/layers.mlp_apply`` -> ``kernels/dispatch.dense`` -> ``fused_dense``).

Bound on an H100 SXM at a hidden layer of the training step (M = 1024,
K = N = 2048): 8.6 GFLOP each against 34-42 MB of operands, so each is
bound by operations.  All three run on the tensor cores
(``csrc/gemm_3xtf32.cuh``: mma.sync TF32 with each operand split into
big + small parts, three products, float32-accurate and held to the same
tolerance; about 0.052 ms at 495 TFLOP/s).  The forward adds the bias
and applies ReLU in the tile's epilogue; masks and transposes of the
backward pair are applied before or as the tiles land; a reduction is
split only where the output has too few tiles for the card.  PERF.md
keeps the times beside the bounds.

The device rule lives in each kernel's wrapper (``dense_forward``,
``dense_dx``, ``dense_dw_db``; ``build.route``): a CPU tensor gets the
plain version (``kernels/ref.py``), a CUDA tensor the kernel or an
exception (a card that is not sm_90, a failed build, a refused launch), a
meta tensor empty meta outputs and its ``work`` charged to
``utils/op_cost``'s counter, with no launch.  Each wrapper counts its
launches in ``<wrapper>.launches``.  Kernels launch on
PyTorch's current stream; workspace and outputs come from the caching
allocator.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref
from repro_torch.utils import op_cost as _cost

SOURCE = _build.CSRC / "dense_train.cu"


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_train_workspace.argtypes = [i, i, i]
    lib.dense_backward_workspace.argtypes = [i, i, i, i]
    for ws in (lib.dense_train_workspace, lib.dense_backward_workspace):
        ws.restype = ctypes.c_longlong
    lib.dense_forward_f32.argtypes = [p, p, p, p, i, i, i, i, p, p]
    lib.dense_dx_f32.argtypes = [p, p, p, p, i, i, i, i, p, p]
    lib.dense_dw_db_f32.argtypes = [p, p, p, p, p, i, i, i, i, p, p]
    for fn in (lib.dense_forward_f32, lib.dense_dx_f32, lib.dense_dw_db_f32):
        fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source revision) and load the kernel library."""
    return _build.load(SOURCE, _bind)


def _shape2(t: torch.Tensor, name: str) -> Tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    return tuple(t.shape)


def _check(*operands: Tuple[str, torch.Tensor, Tuple[int, ...]]) -> None:
    """sm_90, float32, contiguous, one device, and each operand of the
    shape the call implies: (name, tensor, expected shape) triples."""
    device = operands[0][1].device
    if device.type == "cuda":
        _build.check_card(device, "the dense training kernels")
    for name, t, shape in operands:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    _build.check_operands(device, ((name, t) for name, t, _ in operands))


def work(kernel: str, m: int, k: int, n: int, relu: bool
         ) -> Tuple[float, float, str]:
    """One call's own work: (flops, bytes, unit), the 2·M·K·N product on
    the 3xTF32 tile (``tf32x3``; the bias adds, db sums and masks are a
    fraction of a percent) and the bytes of each operand read once and
    each output written once (dy and, under relu, y for the mask)."""
    dy_y = m * n * (2 if relu else 1)
    n_bytes = {"dense_forward_f32": m * k + k * n + n + m * n,
               "dense_dx_f32": dy_y + k * n + m * k,
               "dense_dw_db_f32": m * k + dy_y + k * n + n}[kernel]
    return 2.0 * m * k * n, 4.0 * n_bytes, "tf32x3"


def _workspace(n: int, device: torch.device) -> torch.Tensor:
    return torch.empty(max(n, 1), dtype=torch.float32, device=device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def dense_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  relu: bool) -> torch.Tensor:
    """y = [relu](x @ w + b): x (M, K), w (K, N), b (N,) -> (M, N)."""
    if _build.route(x.device) == "plain":
        return _ref.fused_dense(x, w, b, relu)
    m, k = _shape2(x, "x")
    n = _shape2(w, "w")[1]
    _check(("x", x, (m, k)), ("w", w, (k, n)), ("b", b, (n,)))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    if x.is_meta:
        _cost.charge("dense_forward_f32", *work("dense_forward_f32", m, k, n,
                                                relu))
        return y
    lib = load_library()
    # the workspace is freed on return while the kernel may still run:
    # safe, because the caching allocator reuses it only for work queued
    # later on this same stream
    scratch = _workspace(lib.dense_train_workspace(m, n, k), x.device)
    with torch.cuda.device(x.device):
        _raise_on(lib.dense_forward_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n,
            int(relu), scratch.data_ptr(), _stream(x.device)),
            "dense_forward_f32")
    dense_forward.launches += 1
    return y


def dense_dx(dy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
             relu: bool) -> torch.Tensor:
    """dx = (dy ⊙ [y > 0]) @ wᵀ (no mask without relu): dy, y (M, N),
    w (K, N) -> (M, K)."""
    if _build.route(dy.device) == "plain":
        return _ref.dense_dx(dy, y, w, relu)
    m, n = _shape2(dy, "dy")
    k = _shape2(w, "w")[0]
    _check(("dy", dy, (m, n)), ("y", y, (m, n)), ("w", w, (k, n)))
    dx = torch.empty((m, k), dtype=torch.float32, device=dy.device)
    if m == 0:
        return dx
    if dy.is_meta:
        _cost.charge("dense_dx_f32", *work("dense_dx_f32", m, k, n, relu))
        return dx
    lib = load_library()
    scratch = _workspace(lib.dense_backward_workspace(m, k, n, int(relu)),
                         dy.device)
    with torch.cuda.device(dy.device):
        _raise_on(lib.dense_dx_f32(
            dy.data_ptr(), y.data_ptr(), w.data_ptr(), dx.data_ptr(), m, k, n,
            int(relu), scratch.data_ptr(), _stream(dy.device)),
            "dense_dx_f32")
    dense_dx.launches += 1
    return dx


def dense_dw_db(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor,
                relu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW, db) = (xᵀ @ g, Σ_M g), g = dy ⊙ [y > 0] (dy without relu):
    x (M, K), dy, y (M, N) -> (K, N), (N,)."""
    if _build.route(x.device) == "plain":
        return _ref.dense_dw_db(x, dy, y, relu)
    m, k = _shape2(x, "x")
    n = _shape2(dy, "dy")[1]
    _check(("x", x, (m, k)), ("dy", dy, (m, n)), ("y", y, (m, n)))
    dw = torch.empty((k, n), dtype=torch.float32, device=x.device)
    db = torch.empty((n,), dtype=torch.float32, device=x.device)
    if m == 0:
        return dw.zero_(), db.zero_()
    if x.is_meta:
        _cost.charge("dense_dw_db_f32", *work("dense_dw_db_f32", m, k, n,
                                              relu))
        return dw, db
    lib = load_library()
    scratch = _workspace(lib.dense_backward_workspace(m, k, n, int(relu)),
                         x.device)
    with torch.cuda.device(x.device):
        _raise_on(lib.dense_dw_db_f32(
            x.data_ptr(), dy.data_ptr(), y.data_ptr(), dw.data_ptr(),
            db.data_ptr(), m, k, n, int(relu), scratch.data_ptr(),
            _stream(x.device)), "dense_dw_db_f32")
    dense_dw_db.launches += 1
    return dw, db


#: calls that launched each kernel (not the CPU plain-version route)
dense_forward.launches = 0  # type: ignore[attr-defined]
dense_dx.launches = 0  # type: ignore[attr-defined]
dense_dw_db.launches = 0  # type: ignore[attr-defined]


class FusedDense(torch.autograd.Function):
    """y = [relu](x @ w + b) whose backward is the dx and dW/db kernels.

    Saves the residuals (x, w, y), as the reference's custom_vjp does: the
    mask is recomputed from y, so the backward never re-runs the forward
    product.  The dx kernel runs only when x needs a gradient, the dW/db
    kernel only when w or b does (a frozen layer inside a differentiated
    path launches dx alone)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                relu: bool) -> torch.Tensor:
        y = dense_forward(x, w, b, relu)
        ctx.save_for_backward(x, w, y)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w, y = ctx.saved_tensors
        dy = dy.contiguous()        # autograd may hand in an expanded dy
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx: Optional[torch.Tensor] = None
        dw: Optional[torch.Tensor] = None
        db: Optional[torch.Tensor] = None
        if need_x:
            dx = dense_dx(dy, y, w, ctx.relu)
        if need_w or need_b:
            dw, db = dense_dw_db(x, dy, y, ctx.relu)
        return dx, (dw if need_w else None), (db if need_b else None), None


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                relu: bool = True) -> torch.Tensor:
    """[relu](x @ w + b), differentiable through the three kernels (their
    plain versions for CPU tensors): x (M, K), w (K, N), b (N,)."""
    return FusedDense.apply(x, w, b, relu)
