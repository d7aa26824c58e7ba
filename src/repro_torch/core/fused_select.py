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
- folds the tile into each task's running Algorithm-2 winner
  (``selector.fold_chain``: the chain replayed, not reduced, since it is
  path-dependent; most tiles end after the first accept mask).

Selections equal the reference's (``tests/test_torch_explore.py``): the
same float32 compares on the same oracle values, and winner metrics from
the float64 host oracle through ``selections_from_winners``.

``select_from_probs`` is the one place the batched explorers (GANDSE's and
LargeMLP's ``explore_batch``) pick between this route and the dense one
(``explorer.enumerate_candidates_batch`` + ``selector.select_batch``):
the dense route scores the whole materialized block in one pass, which
is faster wherever that block is small enough to hold (PERF.md); past
that, or past the dense cap, this route streams tiles.  The Selections
are the same either way.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core import shard
from repro_torch.core.explorer import (_DENSE_LIM, _PROD_LIM, ExplorerConfig,
                                       _enum_core, enumerate_candidates_batch)
from repro_torch.core.selector import (NOISE_TOL, Selection, fold_chain,
                                       init_carry, select_batch,
                                       selections_from_winners)
from repro_torch.core.shard import pow2_bucket
from repro_torch.design_models.base import DesignModel

#: default tile width — peak candidate memory is O(T * tile * n_dims)
FUSED_TILE = 1024
#: the most candidate rows (tasks x the cap's power-of-two bucket) that
#: `select_from_probs` materializes for the dense route; larger batches
#: stream tiles
DENSE_ROWS = 1 << 22


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
    decisions, at any tile size.  Under an active task mesh whose shard
    count divides T, each rank streams its block of tasks and the
    Selections are gathered in task order (``shard.map_rows``); only the
    task axis splits, and each lane walks its own tiles, so the Selections
    are one rank's.
    """
    if not model.has_torch_oracle:
        raise ValueError(f"{model.name} has no torch oracle")
    if not 1 <= max_candidates <= _PROD_LIM or tile < 1:
        raise ValueError(f"need 1 <= max_candidates <= 2**26 and tile >= 1, "
                         f"got {max_candidates} and {tile}")
    return shard.map_rows(
        lambda *rows: _fused_rows(model, *rows, thresh, max_candidates,
                                  noise_tol, tile),
        np.asarray(net_idx, np.int32), probs,
        np.asarray(lat_obj, np.float64).reshape(-1),
        np.asarray(pow_obj, np.float64).reshape(-1))


def _fused_rows(model, net_idx, probs, lo, po, thresh, max_candidates,
                noise_tol, tile) -> List[Selection]:
    dev = probs.device
    masks_core, radix_core = _enum_core(model.space)
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

    carry = init_carry(t, dev)
    base_dig = torch.zeros_like(step_dig)
    for k in range(n_tiles):
        j0 = k * tile
        digit = radix_add(base_dig[:, None, :], off_dig, counts[:, None, :])
        cand = torch.gather(table, 2, digit.transpose(1, 2)).transpose(1, 2)
        lat, pw = model.evaluate_torch_indices(net_d, cand)
        lat, pw = lat.to(torch.float32), pw.to(torch.float32)
        fin = (torch.isfinite(lat) & torch.isfinite(pw)
               & ((j0 + rows)[None, :] < total[:, None]))
        carry = fold_chain(carry, lo_d, po_d, lat, pw, fin, j0)
        base_dig = radix_add(base_dig, step_dig, counts)
    chosen = carry[2]

    # winner configs from the same mixed radix; rows with chosen < 0 yield
    # arbitrary values here and are masked by the host tail
    jw = chosen.clamp(min=0)[:, None]
    digit_w = (jw // stride) % counts
    win = torch.gather(table, 2, digit_w[:, :, None])[..., 0]
    return selections_from_winners(
        model, net_idx, chosen.cpu().numpy(),
        win.to(torch.int32).cpu().numpy(), total.cpu().numpy(), lo, po,
        noise_tol)


def dense_route_fits(model: DesignModel, n_tasks: int,
                     max_candidates: int) -> bool:
    """Whether `select_from_probs` takes the dense route for a batch of
    n_tasks: the cap within the dense route's limits, and the largest
    block it could materialize, n_tasks x pow2(cap) rows, within
    DENSE_ROWS."""
    return (max_candidates <= _DENSE_LIM
            and model.space.max_group_size <= 1024
            and n_tasks * pow2_bucket(max_candidates) <= DENSE_ROWS)


def select_from_probs(model: DesignModel, net_idx: np.ndarray,
                      probs: torch.Tensor, xcfg: ExplorerConfig, lat_obj,
                      pow_obj) -> List[Selection]:
    """Batched Algorithm 2 over the candidates of (T, onehot_width) probs
    on their device, with `xcfg`'s threshold, cap and tile: the dense
    route where `dense_route_fits`, else the streaming route.  Requires a
    torch oracle; the Selections do not depend on the route."""
    t = probs.shape[0]
    if dense_route_fits(model, t, xcfg.max_candidates):
        cand, valid, counts = enumerate_candidates_batch(
            model.space, probs, xcfg.prob_threshold, xcfg.max_candidates)
        return select_batch(model, net_idx, cand, valid, counts, lat_obj,
                            pow_obj)
    return fused_select_batch(model, net_idx, probs, xcfg.prob_threshold,
                              xcfg.max_candidates, lat_obj, pow_obj,
                              tile=xcfg.select_tile)
