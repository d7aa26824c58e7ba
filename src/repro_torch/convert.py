"""Carry generator params between the two packages as numpy arrays.

The reference keeps params as ``{"layers": [{"w": (in, out), "b": (out,)},
...]}`` pytrees; converted to numpy (``jax.tree.map(np.asarray, params)``)
they come here, so this package never sees a ``jax.Array``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def g_params_from_numpy(tree: Dict, device) -> Dict:
    """numpy ``{"layers": [{"w", "b"}, ...]}`` -> the port's float32
    params on `device`."""
    return {"layers": [
        {k: torch.tensor(np.asarray(p[k], np.float32), device=device)
         for k in ("w", "b")}
        for p in tree["layers"]]}


def g_params_to_numpy(params: Dict) -> Dict:
    """The port's params -> numpy ``{"layers": [{"w", "b"}, ...]}``."""
    return {"layers": [{k: p[k].detach().cpu().numpy() for k in ("w", "b")}
                       for p in params["layers"]]}
