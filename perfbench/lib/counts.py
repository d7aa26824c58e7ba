"""The yardstick's arithmetic: the H100's published peaks and the work that
GANDSE's shapes need, whatever kernels carry it out.

A product of (M, K) by (K, N) needs 2·M·K·N operations, counted once
however many passes a kernel makes (3xTF32 makes three); its bytes are
each operand read once and the result written once, in float32.  Its
least time is the larger of operations over the TF32 tensor-core peak and
bytes over HBM's bandwidth.  Shares of a roofline or a peak are in %.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_S = 3.35e12
F32 = 4

#: a product: (M, K, N)
Product = Tuple[int, int, int]


def product_flops(p: Product) -> float:
    m, k, n = p
    return 2.0 * m * k * n


def product_bytes(p: Product) -> float:
    m, k, n = p
    return F32 * (m * k + k * n + m * n)


def bound_s(products: Iterable[Product]) -> float:
    """Least time of a list of products, each at its own roofline."""
    return sum(max(product_flops(p) / PEAK_TF32_FLOPS,
                   product_bytes(p) / PEAK_HBM_BYTES_S) for p in products)


def flops(products: Iterable[Product]) -> float:
    return sum(product_flops(p) for p in products)


def pairs(dims: Sequence[int]) -> List[Tuple[int, int]]:
    return list(zip(dims[:-1], dims[1:]))


def mlp_forward_work(m: int, dims: Sequence[int]) -> Tuple[float, float]:
    """The whole-MLP forward at M rows: (operations, bytes), with x, each
    weight and bias read once and the output written once; the hidden
    activations need not leave the chip."""
    ops = sum(2.0 * m * k * n for k, n in pairs(dims))
    n_bytes = F32 * (m * dims[0] + sum(k * n + n for k, n in pairs(dims))
                     + m * dims[-1])
    return ops, n_bytes


def mlp_forward_bound_s(m: int, dims: Sequence[int]) -> float:
    ops, n_bytes = mlp_forward_work(m, dims)
    return max(ops / PEAK_TF32_FLOPS, n_bytes / PEAK_HBM_BYTES_S)


def algorithm1_products(b: int, g_dims: Sequence[int],
                        d_dims: Sequence[int]) -> List[Product]:
    """The products one Algorithm 1 step needs at batch b (§4, Alg. 1):

    - G forward; G's backward: dW of every layer, dx of every layer but
      the first (the inputs need no gradient);
    - D forward once (lines 6, 9 and the D loss read the same Sat);
    - the critic's backward through frozen D: dx of every layer, the first
      included (it reaches G's probabilities);
    - D's own backward: dW of every layer, dx of every layer but the first.
    """
    out: List[Product] = []
    for dims, first_dx in ((g_dims, False), (d_dims, True)):
        layers = pairs(dims)
        out += [(b, k, n) for k, n in layers]                  # forward
        out += [(k, b, n) for k, n in layers]                  # dW
        out += [(b, n, k) for k, n in layers[1:]]              # dx
        if first_dx:
            out += [(b, n, k) for k, n in layers]              # critic dx
    return out
