"""Layer lists -> the whole-MLP forward, with the caller's opt-out.

The device rule (a CPU tensor gets the plain version, a CUDA tensor the
kernel or an exception) is the kernel wrapper's, ``kernels/fused_mlp.py``.
This module adds only ``use_fused=False``: an explicit caller opt-out to
the plain version (``kernels/ref.py``) on any device; None and True follow
the wrapper's rule.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels import fused_mlp as _fm
from repro_torch.kernels import ref as _ref


def mlp_chain(layers: List[dict], x: torch.Tensor, *,
              use_fused: Optional[bool] = None) -> torch.Tensor:
    """Whole-MLP forward (hidden ReLU, linear head) from an
    ``mlp_init``-style layer list; x may carry leading batch dims
    (flattened to rows)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    ws = [p["w"] for p in layers]
    bs = [p["b"] for p in layers]
    if use_fused is False:
        y = _ref.fused_mlp(x2, ws, bs)
    else:
        y = _fm.fused_mlp(x2.contiguous(), ws, bs)
    return y.reshape(*lead, ws[-1].shape[-1])
