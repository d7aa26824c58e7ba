"""Serve-step factories of the LM substrate: ``make_prefill_step`` and
``make_decode_step``, the counterparts of the reference's (with no mesh:
one card).  The train step comes with LM training (ROADMAP Queue 1
item 8)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import base as MB


def make_prefill_step(m: MB.ModelCfg, *,
                      use_fused: Optional[bool] = None) -> Callable:
    """prefill_step(params, batch) -> last-position logits (B, V).

    ``batch["tokens"]`` (B, S); ``batch["positions"]`` optional.  Every
    attention layer runs the flash-attention kernel on the card;
    ``use_fused=False`` takes the plain attention instead."""
    def prefill_step(params, batch):
        with torch.no_grad():
            logits = MB.forward(params, m, batch["tokens"],
                                positions=batch.get("positions"),
                                use_fused=use_fused)
        # a copy, so the (B, S, V) logits are freed on return
        return logits[:, -1].clone()

    return prefill_step


def make_decode_step(m: MB.ModelCfg) -> Callable:
    """decode_step(params, token, pos, states, start=None) -> (logits
    (B, 1, V), states); see ``models/base.decode_step``."""
    def decode_step(params, token, pos, states, start=None):
        with torch.no_grad():
            return MB.decode_step(params, m, token, pos, states, start=start)

    return decode_step
