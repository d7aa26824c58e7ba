"""Layer lists -> the port's kernels, with the caller's opt-out.

The device rule (a CPU tensor gets the plain version, a CUDA tensor the
kernel or an exception) is each kernel wrapper's: ``kernels/fused_mlp.py``
(the whole-MLP forward) and ``kernels/fused_dense.py`` (the dense layer of
training and its backward).  This module adds only ``use_fused=False``: an
explicit caller opt-out to the plain version (``kernels/ref.py``) on any
device; None and True follow the wrapper's rule.  ``kernel_route_active``
states that rule for a caller that reports the route (the serving tier's
summary).
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch

from repro_torch.kernels import fused_dense as _fd
from repro_torch.kernels import fused_mlp as _fm
from repro_torch.kernels import ref as _ref


def kernel_route_active(use_fused: Optional[bool],
                        device: Union[str, torch.device, None]) -> bool:
    """True when ``dense``/``mlp_chain`` with this flag, on tensors of
    ``device``, launch the CUDA kernels: a CUDA device and no opt-out.  The
    CPU (or no device) never runs them."""
    return (device is not None and torch.device(device).type == "cuda"
            and use_fused is not False)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
          relu: bool = True, use_fused: Optional[bool] = None) -> torch.Tensor:
    """[relu](x @ w + b); x may carry leading batch dims (flattened to
    rows).  Differentiable on both routes (the kernel route through
    ``FusedDense``'s backward kernels)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_fused is False:
        y = _ref.fused_dense(x2, w, b, relu)
    else:
        y = _fd.fused_dense(x2.contiguous(), w, b, relu)
    return y.reshape(*lead, w.shape[-1])


def mlp_chain(layers: List[dict], x: torch.Tensor, *,
              use_fused: Optional[bool] = None) -> torch.Tensor:
    """Whole-MLP forward (hidden ReLU, linear head) from an
    ``mlp_init``-style layer list; x may carry leading batch dims (flattened
    to rows)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    ws = [p["w"] for p in layers]
    bs = [p["b"] for p in layers]
    if use_fused is False:
        y = _ref.fused_mlp(x2, ws, bs)
    else:
        y = _fm.fused_mlp(x2.contiguous(), ws, bs)
    return y.reshape(*lead, ws[-1].shape[-1])
