"""Streaming tiled select: enumerate -> score -> select over candidate tiles.

Plain torch ops on the probs' device (the reference is jnp that XLA fuses,
not a Pallas kernel).  The candidate tensor is never materialized: each
tile step

- decodes its tile-sized index window by *incremental* mixed-radix
  arithmetic — the in-tile offset digits are divmod-decoded once per call
  and every tile adds them to the running tile-base digits with a
  carry-propagating compare/subtract (``radix_add``), so peak candidate
  memory is O(T * tile * n_dims) at any cap;
- scores the tile with the torch float32 oracle;
- folds the tile into each task's running Algorithm-2 winner.

Exactness.  Algorithm 2's update chain is path-dependent, so no
carry-independent per-tile reduction can match it.  The *accept test* is
vectorized instead: under a fixed carry (L_opt, P_opt) the chain's next
accepted row is the first row whose update predicate holds.  The replay
loop below builds that accept mask for every task at once, moves every
task that has a set bit to its first accepting row (reloading its carry),
and repeats until no task accepts — the sequential chain, first-wins tie
order included, in O(accepted rows) vectorized rounds.  Accepted rows are
rare (each must improve on the last), so most tiles end after the first
mask.

Selections equal the reference's (``tests/test_torch_explore.py``): the
same float32 compares on the same oracle values, and winner metrics from
the float64 host oracle through ``selections_from_winners``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.explorer import _PROD_LIM, _enum_core
from repro_torch.core.selector import (NOISE_TOL, Selection,
                                       selections_from_winners)
from repro_torch.design_models.base import DesignModel

#: default tile width — peak candidate memory is O(T * tile * n_dims)
FUSED_TILE = 1024


def radix_add(base: torch.Tensor, add: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """Mixed-radix add with the last dim least significant
    (``itertools.product`` order).  Both addends are digit-wise < counts,
    so the ripple carry is at most 1; the carry out of the top digit is
    dropped (wraps mod prod(counts), like the divmod form does for indices
    past the product)."""
    n_dims = counts.shape[-1]
    shape = torch.broadcast_shapes(base.shape, add.shape, counts.shape)
    out = torch.empty(shape, dtype=base.dtype, device=base.device)
    carry = torch.zeros(shape[:-1], dtype=base.dtype, device=base.device)
    for d in range(n_dims - 1, -1, -1):
        s = base[..., d] + add[..., d] + carry
        carry = (s >= counts[..., d]).to(base.dtype)
        out[..., d] = s - carry * counts[..., d]
    return out


def accept_mask(l_opt, p_opt, lo, po, lat, pw, fin):
    """Algorithm 2's update predicate (selector.select, lines 7-22) for
    every row of a (T, tile) block under the per-task carry (T,): the
    case split is per-task scalars, only the metric compares are per-row."""
    init = (l_opt == 0.0) & (p_opt == 0.0)
    both = ((l_opt > lo) & (p_opt > po)) | ((l_opt < lo) & (p_opt < po))
    sc2 = (l_opt > lo) & (p_opt < po)
    sc3 = (p_opt > po) & (l_opt < lo)
    lt_l = lat < l_opt[:, None]
    lt_p = pw < p_opt[:, None]
    return fin & (
        init[:, None]
        | ((~init & both)[:, None] & lt_l & lt_p)
        | ((~init & ~both & sc2)[:, None] & lt_l & (pw < po[:, None]))
        | ((~init & ~both & ~sc2 & sc3)[:, None] & lt_p & (lat < lo[:, None])))


def fused_select_batch(
    model: DesignModel,
    net_idx: np.ndarray,
    probs: torch.Tensor,
    thresh: float,
    max_candidates: int,
    lat_obj,
    pow_obj,
    noise_tol: float = NOISE_TOL,
    tile: int = FUSED_TILE,
) -> List[Selection]:
    """Batched Algorithm 2 straight from generator probs, streaming tiles
    on ``probs.device``.

    net_idx (T, n_net_dims), probs (T, onehot_width) float32 tensor,
    objectives (T,).  Requires a torch oracle (``model.has_torch_oracle``).
    Task t's Selection equals the host route's (``enumerate_candidates`` +
    ``select``) wherever float32 and float64 scoring agree on the chain's
    decisions, at any tile size.
    """
    if not model.has_torch_oracle:
        raise ValueError(f"{model.name} has no torch oracle")
    if not 1 <= max_candidates <= _PROD_LIM or tile < 1:
        raise ValueError(f"need 1 <= max_candidates <= 2**26 and tile >= 1, "
                         f"got {max_candidates} and {tile}")
    dev = probs.device
    masks_core, radix_core = _enum_core(model.space)
    net_idx = np.asarray(net_idx, np.int32)
    lo = np.asarray(lat_obj, np.float64).reshape(-1)
    po = np.asarray(pow_obj, np.float64).reshape(-1)
    t = probs.shape[0]

    keep, counts, total = masks_core(probs, thresh, max_candidates)
    table, stride = radix_core(keep, counts)
    net_d = torch.as_tensor(net_idx, dtype=torch.int64, device=dev)[:, None, :]
    lo_d = torch.as_tensor(lo.astype(np.float32), device=dev)
    po_d = torch.as_tensor(po.astype(np.float32), device=dev)
    rows = torch.arange(tile, dtype=torch.int64, device=dev)
    # the only divmod decodes, once per call: in-tile offset digits
    # (T, tile, n_dims) and the per-tile-step digit increment (T, n_dims)
    off_dig = (rows[None, :, None] // stride[:, None, :]) % counts[:, None, :]
    step_dig = (tile // stride) % counts
    # eager torch needs the trip count on the host: one read per call
    n_tiles = int(torch.max(total).item() + tile - 1) // tile  # lint: dispatch-sync-ok

    l_opt = torch.zeros(t, dtype=torch.float32, device=dev)
    p_opt = torch.zeros(t, dtype=torch.float32, device=dev)
    chosen = torch.full((t,), -1, dtype=torch.int64, device=dev)
    base_dig = torch.zeros_like(step_dig)
    task = torch.arange(t, device=dev)
    for k in range(n_tiles):
        j0 = k * tile
        digit = radix_add(base_dig[:, None, :], off_dig, counts[:, None, :])
        cand = torch.gather(table, 2, digit.transpose(1, 2)).transpose(1, 2)
        lat, pw = model.evaluate_torch_indices(net_d, cand)
        lat, pw = lat.to(torch.float32), pw.to(torch.float32)
        fin = (torch.isfinite(lat) & torch.isfinite(pw)
               & ((j0 + rows)[None, :] < total[:, None]))
        pos = torch.zeros(t, dtype=torch.int64, device=dev)
        while True:
            acc = accept_mask(l_opt, p_opt, lo_d, po_d, lat, pw, fin) \
                & (rows[None, :] >= pos[:, None])
            has = acc.any(dim=-1)
            # the replay loop's exit test is a host read of the device mask
            if not bool(has.any()):  # lint: dispatch-sync-ok
                break
            i = torch.argmax(acc.to(torch.uint8), dim=-1)   # first set bit
            l_opt = torch.where(has, lat[task, i], l_opt)
            p_opt = torch.where(has, pw[task, i], p_opt)
            chosen = torch.where(has, j0 + i, chosen)
            pos = torch.where(has, i + 1, pos)
        base_dig = radix_add(base_dig, step_dig, counts)

    # winner configs from the same mixed radix; rows with chosen < 0 yield
    # arbitrary values here and are masked by the host tail
    jw = chosen.clamp(min=0)[:, None]
    digit_w = (jw // stride) % counts
    win = torch.gather(table, 2, digit_w[:, :, None])[..., 0]
    return selections_from_winners(
        model, net_idx, chosen.cpu().numpy(),
        win.to(torch.int32).cpu().numpy(), total.cpu().numpy(), lo, po,
        noise_tol)
