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

``select`` is the float64 host loop for one task.  The batched route
(``core/fused_select``) steers the same chain in float32 on the device and
ends in ``selections_from_winners``, which re-derives every reported
metric from the float64 host oracle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

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


def select(
    model: DesignModel,
    net_idx: np.ndarray,
    cand_idx: np.ndarray,
    lat_obj: float,
    pow_obj: float,
    noise_tol: float = NOISE_TOL,
) -> Selection:
    """Run Algorithm 2 over the candidate set for one DSE task (float64
    host loop).  noise_tol only affects the reported `satisfied` flag."""
    if cand_idx.size == 0:
        return Selection(None, np.inf, np.inf, False, 0)
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
