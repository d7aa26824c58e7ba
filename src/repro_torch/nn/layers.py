"""MLP layers as plain functions on tensors.

Params keep the reference package's layout — ``{"layers": [{"w": (in,
out), "b": (out,)}, ...]}`` — so the kernel reads ``x @ w`` directly and
converted params compare like with like.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels import dispatch as D


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device,
               scale: Optional[float] = None):
    """He init (ReLU nets) unless `scale` is given; zero bias."""
    s = scale if scale is not None else (2.0 / in_dim) ** 0.5
    w = torch.randn(in_dim, out_dim, generator=gen, dtype=torch.float32,
                    device=device) * s
    return {"w": w, "b": torch.zeros(out_dim, dtype=torch.float32,
                                     device=device)}


def mlp_init(gen: torch.Generator, in_dim: int, hidden: Sequence[int],
             out_dim: int, device):
    """Hidden layers He-initialized, the linear head at 1/sqrt(fan_in).
    `gen` must live on `device` (torch draws on the generator's device)."""
    dims = [in_dim, *hidden, out_dim]
    layers = []
    for i in range(len(dims) - 1):
        last = i == len(dims) - 2
        scale = (1.0 / dims[i]) ** 0.5 if last else None
        layers.append(dense_init(gen, dims[i], dims[i + 1], device, scale))
    return {"layers": layers}


def mlp_apply(params, x: torch.Tensor,
              activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
              use_fused: Optional[bool] = None) -> torch.Tensor:
    """Layer-by-layer MLP: hidden layers with `activation`, linear final
    layer — the training forward.  With ReLU every layer goes through
    ``kernels/dispatch.dense`` (the dense kernels and their backward on
    CUDA tensors; ``use_fused=False`` opts out to the plain version).  The
    kernels hard-wire ReLU, so another activation raises on an explicit
    ``use_fused=True`` and otherwise takes the plain path (it is never
    replaced by ReLU)."""
    layers = params["layers"]
    if activation is torch.relu:
        for p in layers[:-1]:
            x = D.dense(x, p["w"], p["b"], relu=True, use_fused=use_fused)
        return D.dense(x, layers[-1]["w"], layers[-1]["b"], relu=False,
                       use_fused=use_fused)
    if use_fused:
        raise ValueError(
            "mlp_apply(use_fused=True) supports only torch.relu — the dense "
            f"kernel hard-wires the ReLU epilogue; got {activation!r}. Pass "
            "use_fused=None/False to use the plain path.")
    for p in layers[:-1]:
        x = activation(x @ p["w"] + p["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def mlp_apply_chained(params, x: torch.Tensor,
                      use_fused: Optional[bool] = None) -> torch.Tensor:
    """Inference MLP forward (hidden ReLU, linear head) through the
    whole-MLP kernel on CUDA tensors (see ``kernels/fused_mlp.py``)."""
    return D.mlp_chain(params["layers"], x, use_fused=use_fused)
