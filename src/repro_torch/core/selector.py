"""Design Selector — Algorithm 2 (paper §6.2), exactly as published.

Scans the candidate configuration sets, keeping (L_opt, P_opt) and the
priority rules:
  scenario 1: both current objectives satisfied or both unsatisfied ->
              update only if the candidate improves BOTH;
  scenario 2: latency unsatisfied, power satisfied -> update if candidate
              improves latency while its power still satisfies PO;
  scenario 3: symmetric to 2.

The chain is copied as written, including its stall at equality: once
``L_opt == LO`` (or ``P_opt == PO``) no branch's strict inequality can
hold, so no later candidate is taken.

Three routes run the chain:

- ``select``'s host loop: float64 numpy, one task;
- the device route (``select(use_torch=True)`` and the batched
  ``select_batch``): the torch float32 oracle scores a whole (T, C) block
  of candidates, then `fold_chain` replays the chain over it for every
  task at once — the batched twin of the reference's vmapped
  ``lax.scan``;
- ``core/fused_select``: the same fold over streamed candidate tiles.

The device routes steer the chain in float32 and end in
``selections_from_winners``, which re-derives every reported metric from
the float64 host oracle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import shard
from repro_torch.core.explorer import resolve_device
from repro_torch.design_models.base import DesignModel


@dataclasses.dataclass
class Selection:
    cfg_idx: Optional[np.ndarray]   # (n_dims,) chosen config indices or None
    latency: float
    power: float
    satisfied: bool
    n_candidates: int

    def improvement_ratio(self, lo: float, po: float) -> Optional[float]:
        """sqrt(1/2 ((L-LO)/LO)^2 + 1/2 ((P-PO)/PO)^2) when satisfied (§7.2)."""
        if not self.satisfied:
            return None
        return float(np.sqrt(0.5 * (((self.latency - lo) / lo) ** 2
                                    + ((self.power - po) / po) ** 2)))


#: the paper allows 1% noise when judging satisfaction (§7.2)
NOISE_TOL = 0.01


def is_satisfied(lat: float, pw: float, lo: float, po: float,
                 noise_tol: float = NOISE_TOL) -> bool:
    """§7.2 satisfaction: both metrics within (1 + noise_tol) of the
    objectives; non-finite metrics never satisfy."""
    return bool(np.isfinite(lat) and np.isfinite(pw)
                and lat <= lo * (1 + noise_tol)
                and pw <= po * (1 + noise_tol))


#: auto-route cutover of `select`: from this many candidates on, a model
#: with a torch oracle takes the device route (the reference's
#: JAX_MIN_CANDIDATES, the crossover measured there on the CPU)
TORCH_MIN_CANDIDATES = 512

def accept_mask(l_opt, p_opt, lo, po, lat, pw, fin):
    """Algorithm 2's update predicate (lines 7-22) for every row of a
    (T, n) block under the per-task carry (T,): the case split is
    per-task scalars, only the metric compares are per-row."""
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


def init_carry(t: int, device) -> Tuple[torch.Tensor, ...]:
    """The chain's starting carry for t tasks: L_opt = P_opt = 0 (lines
    7-8's init test) and no row chosen (-1)."""
    zeros = torch.zeros(t, dtype=torch.float32, device=device)
    return zeros, zeros.clone(), torch.full((t,), -1, dtype=torch.int64,
                                            device=device)


def fold_chain(carry, lo, po, lat, pw, fin, j0: int = 0):
    """Run Algorithm 2's update chain over a (T, n) block of scored rows
    for every task at once; carry = (L_opt, P_opt, chosen), each (T,);
    row i of the block has rank j0 + i.

    The chain is path-dependent, so it is replayed, not reduced: under a
    fixed carry the chain's next accepted row is the first row whose
    update predicate holds.  Each round builds that mask for every task,
    moves every task with a set bit to its first accepting row (reloading
    its carry), and repeats until no task accepts — the sequential chain,
    first-wins tie order included, in O(accepted rows) vectorized rounds.
    Accepted rows are rare (each must improve on the last)."""
    l_opt, p_opt, chosen = carry
    t, n = lat.shape
    rows = torch.arange(n, device=lat.device)
    task = torch.arange(t, device=lat.device)
    pos = torch.zeros(t, dtype=torch.int64, device=lat.device)
    while True:
        acc = accept_mask(l_opt, p_opt, lo, po, lat, pw, fin) \
            & (rows[None, :] >= pos[:, None])
        has = acc.any(dim=-1)
        # the replay loop's exit test is a host read of the device mask
        if not bool(has.any()):  # lint: dispatch-sync-ok
            return l_opt, p_opt, chosen
        i = torch.argmax(acc.to(torch.uint8), dim=-1)   # first set bit
        l_opt = torch.where(has, lat[task, i], l_opt)
        p_opt = torch.where(has, pw[task, i], p_opt)
        chosen = torch.where(has, j0 + i, chosen)
        pos = torch.where(has, i + 1, pos)


def _algorithm2(model: DesignModel, net_idx: torch.Tensor,
                cand_idx: torch.Tensor, valid: torch.Tensor,
                lo: torch.Tensor, po: torch.Tensor):
    """Score + update chain on the tensors' device (the reference's
    ``_algorithm2_core``, batched): net_idx (T, n_net_dims), cand_idx
    (T, C, n_dims), valid (T, C) marking real rows, float32 objectives
    (T,) -> (L_opt, P_opt, chosen), each (T,).  The update chain sees the
    same float32 values whatever the batch, so batching never changes a
    task's winner."""
    lat, pw = model.evaluate_torch_indices(net_idx[:, None, :],
                                           cand_idx.to(torch.int64))
    lat, pw = lat.to(torch.float32), pw.to(torch.float32)
    fin = torch.isfinite(lat) & torch.isfinite(pw) & valid
    return fold_chain(init_carry(lat.shape[0], lat.device), lo, po, lat, pw,
                      fin)


def select(
    model: DesignModel,
    net_idx: np.ndarray,
    cand_idx: np.ndarray,
    lat_obj: float,
    pow_obj: float,
    noise_tol: float = NOISE_TOL,
    use_torch: Optional[bool] = None,
    device=None,
) -> Selection:
    """Run Algorithm 2 over the candidate set for one DSE task.

    noise_tol only affects the reported `satisfied` flag.  use_torch: None
    = the device route when the model has a torch oracle and the set has
    at least TORCH_MIN_CANDIDATES rows; True/False force a route.  The
    device route is `select_batch` for one task on `device` (None: the
    card, see ``explorer.resolve_device``); it scores in float32 (it can
    pick another near-tied winner than the float64 host loop), but the
    returned metrics always come from the float64 host oracle."""
    if cand_idx.size == 0:
        return Selection(None, np.inf, np.inf, False, 0)
    if use_torch is None:
        use_torch = (model.has_torch_oracle
                     and cand_idx.shape[0] >= TORCH_MIN_CANDIDATES)
    if use_torch:
        dev = resolve_device(device)
        n = cand_idx.shape[0]
        return select_batch(
            model, np.asarray(net_idx).reshape(1, -1),
            torch.as_tensor(cand_idx, device=dev)[None],
            torch.ones((1, n), dtype=torch.bool, device=dev), [n],
            [lat_obj], [pow_obj], noise_tol)[0]
    net = np.repeat(np.atleast_2d(net_idx), cand_idx.shape[0], axis=0)
    lat, pw = model.evaluate_indices(net, cand_idx)      # vectorized (lines 4-5)

    lo, po = float(lat_obj), float(pow_obj)
    l_opt, p_opt, chosen = 0.0, 0.0, -1
    for i in range(cand_idx.shape[0]):
        lg, pg = float(lat[i]), float(pw[i])
        if not (np.isfinite(lg) and np.isfinite(pg)):
            continue
        update = False
        if l_opt == 0.0 and p_opt == 0.0:                 # lines 7-8 (init)
            update = True
        elif (l_opt > lo and p_opt > po) or (l_opt < lo and p_opt < po):
            if lg < l_opt and pg < p_opt:                  # lines 10-13
                update = True
        elif l_opt > lo and p_opt < po:                    # lines 15-18
            if lg < l_opt and pg < po:
                update = True
        elif p_opt > po and l_opt < lo:                    # lines 20-22
            if pg < p_opt and lg < lo:
                update = True
        if update:                                         # lines 26-30
            l_opt, p_opt, chosen = lg, pg, i

    if chosen < 0:
        return Selection(None, np.inf, np.inf, False, int(cand_idx.shape[0]))
    satisfied = is_satisfied(l_opt, p_opt, lo, po, noise_tol)
    return Selection(
        cfg_idx=cand_idx[chosen].copy(),
        latency=l_opt,
        power=p_opt,
        satisfied=satisfied,
        n_candidates=int(cand_idx.shape[0]),
    )


def selections_from_winners(
    model: DesignModel,
    net_idx: np.ndarray,
    chosen: np.ndarray,
    win_cfg: np.ndarray,
    n_candidates: np.ndarray,
    lat_obj,
    pow_obj,
    noise_tol: float = NOISE_TOL,
) -> List[Selection]:
    """Host tail of the batched route: given each task's chosen candidate
    rank (-1 = none feasible) and winner config rows (host arrays), one
    batched float64 host-oracle call re-derives the reported metrics — the
    device float32 only steered the update chains.  Rows with
    ``chosen[t] < 0`` may hold arbitrary ``win_cfg`` values; they are never
    evaluated."""
    net_idx = np.asarray(net_idx, np.int32)
    lo = np.asarray(lat_obj, np.float64).reshape(-1)
    po = np.asarray(pow_obj, np.float64).reshape(-1)
    has = chosen >= 0
    if has.any():       # one float64 host-oracle call for every winner
        lat64, pw64 = model.evaluate_indices(net_idx[has], win_cfg[has])

    out, k = [], 0
    for t in range(chosen.shape[0]):
        n = int(n_candidates[t])
        if not has[t]:
            out.append(Selection(None, np.inf, np.inf, False, n))
            continue
        l_opt, p_opt = float(lat64[k]), float(pw64[k])
        k += 1
        satisfied = is_satisfied(l_opt, p_opt, lo[t], po[t], noise_tol)
        out.append(Selection(win_cfg[t].copy(), l_opt, p_opt, satisfied, n))
    return out


def select_batch(
    model: DesignModel,
    net_idx: np.ndarray,
    cand_idx: torch.Tensor,
    valid: torch.Tensor,
    n_candidates: np.ndarray,
    lat_obj,
    pow_obj,
    noise_tol: float = NOISE_TOL,
) -> List[Selection]:
    """Batched Algorithm 2 over a padded candidate tensor, on its device.

    net_idx (T, n_net_dims), cand_idx (T, C_pad, n_dims) and valid
    (T, C_pad) tensors (as ``enumerate_candidates_batch`` returns them),
    n_candidates (T,) real per-task counts, objectives (T,).  Requires a
    torch oracle.  All T update chains run as one `fold_chain` over the
    whole block; candidates are scored in float32, and the winners'
    metrics come from one batched float64 host-oracle call.  Task t's
    Selection equals ``select(model, net_idx[t], cand_idx[t][:n[t]], ...,
    use_torch=True)``.  Under an active task mesh whose shard count
    divides T, each rank selects its block of tasks and the Selections
    are gathered in task order (``shard.map_rows``)."""
    if not model.has_torch_oracle:
        raise ValueError(f"{model.name} has no torch oracle")
    return shard.map_rows(
        lambda *rows: _select_rows(model, *rows, noise_tol),
        np.asarray(net_idx, np.int32), cand_idx, valid,
        np.asarray(n_candidates), np.asarray(lat_obj, np.float64).reshape(-1),
        np.asarray(pow_obj, np.float64).reshape(-1))


def _select_rows(model, net_idx, cand_idx, valid, n_candidates, lo, po,
                 noise_tol) -> List[Selection]:
    dev = cand_idx.device
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    _, _, chosen = _algorithm2(
        model, torch.as_tensor(net_idx, dtype=torch.int64, device=dev),
        cand_idx, valid, f32(lo), f32(po))
    task = torch.arange(cand_idx.shape[0], device=dev)
    win = cand_idx[task, chosen.clamp(min=0)]
    return selections_from_winners(
        model, net_idx, chosen.cpu().numpy(),
        win.to(torch.int32).cpu().numpy(), np.asarray(n_candidates), lo, po,
        noise_tol)
