"""GANDSE's exploration after G (paper §6.1-§6.2) in plain numpy and
PyTorch: candidate sets from G's probabilities, then Algorithm 2.

- Candidates: in each configuration group every choice whose probability
  exceeds the threshold (the argmax always), their cartesian product in
  ``itertools.product`` order; a product over the cap drops non-argmax
  choices, lowest probability first (ties group-major, choice-major),
  until it fits.
- Algorithm 2 (published chain, stall at equality included) steered by
  the float32 oracle; the winner's latency and power then come from the
  float64 oracle, and satisfaction allows 1% noise (§7.2).
- Ties: where a probability lies within rounding of a decision's edge
  (the threshold, its group's best, or another choice the cap may drop),
  either side of the edge is an answer the reference accepts.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

NOISE_TOL = 0.01

#: (config indices or None, latency s, power W, satisfied, candidates)
Answer = Tuple[Optional[Tuple[int, ...]], float, float, bool, int]


def employed(sizes: Sequence[int], probs: np.ndarray, thresh: float,
             cap: int) -> List[np.ndarray]:
    """One task's kept choices a group, after the cap."""
    groups, off = [], 0
    for n in sizes:
        groups.append(probs[off:off + n])
        off += n
    thr = np.float32(thresh)
    kept = []
    for g in groups:
        k = np.flatnonzero(g > thr)
        kept.append(k if k.size else np.array([int(np.argmax(g))]))
    counts = [len(k) for k in kept]
    product = int(np.prod(counts, dtype=np.int64))
    if product <= cap:
        return kept
    slots = [(gi, int(ci), g[ci]) for gi, (g, k) in enumerate(zip(groups, kept))
             for ci in k if ci != int(np.argmax(g))]
    order = np.argsort(np.asarray([p for _, _, p in slots]), kind="stable")
    dropped = [set() for _ in groups]
    for j in order:
        if product <= cap:
            break
        gi, ci, _ = slots[j]
        dropped[gi].add(ci)
        product = product // counts[gi] * (counts[gi] - 1)
        counts[gi] -= 1
    return [np.asarray([c for c in k if c not in d]) for k, d in
            zip(kept, dropped)]


def candidates(kept: List[np.ndarray]) -> np.ndarray:
    """The cartesian product of the kept choices, last group fastest:
    (count, n_dims) int64."""
    counts = np.asarray([len(k) for k in kept], np.int64)
    total = int(np.prod(counts))
    stride = np.concatenate([np.cumprod(counts[::-1])[::-1][1:], [1]])
    j = np.arange(total, dtype=np.int64)[:, None]
    digits = (j // stride) % counts
    return np.stack([kept[i][digits[:, i]] for i in range(len(kept))], -1)


def chain(lat: np.ndarray, pw: np.ndarray, count: np.ndarray,
          lo: np.ndarray, po: np.ndarray) -> np.ndarray:
    """Algorithm 2 over (T, C) float32 scores, every task's chain side by
    side (rows past a task's count are skipped) -> (T,) chosen row or -1."""
    t = lat.shape[0]
    l_opt = np.zeros(t, np.float32)
    p_opt = np.zeros(t, np.float32)
    chosen = np.full(t, -1, np.int64)
    lo, po = lo.astype(np.float32), po.astype(np.float32)
    for j in range(lat.shape[1]):
        lg, pg = lat[:, j], pw[:, j]
        ok = (j < count) & np.isfinite(lg) & np.isfinite(pg)
        init = (l_opt == 0) & (p_opt == 0)
        both = ((l_opt > lo) & (p_opt > po)) | ((l_opt < lo) & (p_opt < po))
        sc2 = (l_opt > lo) & (p_opt < po)
        sc3 = (p_opt > po) & (l_opt < lo)
        upd = ok & (init
                    | (~init & both & (lg < l_opt) & (pg < p_opt))
                    | (~init & ~both & sc2 & (lg < l_opt) & (pg < po))
                    | (~init & ~both & ~sc2 & sc3 & (pg < p_opt) & (lg < lo)))
        l_opt = np.where(upd, lg, l_opt)
        p_opt = np.where(upd, pg, p_opt)
        chosen = np.where(upd, j, chosen)
    return chosen


def explore(oracle, net_idx: np.ndarray, probs: np.ndarray, thresh: float,
            cap: int, lo: np.ndarray, po: np.ndarray, device) -> List[Answer]:
    """Every task's answer from its (width,) probabilities."""
    sizes = oracle.cfg.sizes
    cands = [candidates(employed(sizes, p, thresh, cap)) for p in probs]
    count = np.asarray([len(c) for c in cands], np.int64)
    grid = np.zeros((len(cands), int(count.max()), len(sizes)), np.int64)
    for t, c in enumerate(cands):
        grid[t, :len(c)] = c
    with torch.no_grad():
        lat, pw = oracle.device(
            torch.as_tensor(np.asarray(net_idx, np.int64), device=device)[:, None],
            torch.as_tensor(grid, device=device))
    chosen = chain(lat.cpu().numpy(), pw.cpu().numpy(), count, lo, po)
    has = chosen >= 0
    win = grid[np.arange(len(cands)), np.maximum(chosen, 0)]
    lat64, pw64 = oracle.host(np.asarray(net_idx)[has], win[has])
    out: List[Answer] = []
    k = 0
    for t in range(len(cands)):
        if not has[t]:
            out.append((None, float("inf"), float("inf"), False, int(count[t])))
            continue
        la, pa = float(lat64[k]), float(pw64[k])
        k += 1
        sat = bool(np.isfinite(la) and np.isfinite(pa)
                   and la <= lo[t] * (1 + NOISE_TOL)
                   and pa <= po[t] * (1 + NOISE_TOL))
        out.append((tuple(int(v) for v in win[t]), la, pa, sat, int(count[t])))
    return out


#: near decisions a task's variants cover at most (2 ** MAX_NEAR variants)
MAX_NEAR = 8


def near(sizes: Sequence[int], p: np.ndarray, thresh: float, cap: int,
         tie: float) -> List[int]:
    """Indices of one task's probabilities that a change of less than
    `tie` could move across a decision: the threshold, its group's best,
    or (where the cap trims) the order of the choices it may drop."""
    thr = float(np.float32(thresh))
    out, spare, off = set(), [], 0
    counts = []
    for n in sizes:
        g = p[off:off + n]
        top = int(np.argmax(g))
        out.update(off + np.flatnonzero(np.abs(g - thr) < tie))
        close = np.flatnonzero(g[top] - g < tie)
        if close.size > 1:
            out.update(off + close)
        kept = np.flatnonzero(g > thr - tie)
        counts.append(max(kept.size, 1))
        spare += [(float(g[j]), off + int(j)) for j in kept if j != top]
        off += n
    if np.prod(counts, dtype=np.float64) > cap:
        spare.sort()
        for (a, i), (b, j) in zip(spare, spare[1:]):
            if b - a < tie:
                out.update((i, j))
    return sorted(out, key=lambda i: abs(p[i] - thr))[:MAX_NEAR]


def explore_ties(oracle, net_idx: np.ndarray, probs: np.ndarray,
                 thresh: float, cap: int, lo: np.ndarray, po: np.ndarray,
                 device, tie: float) -> List[Set[Answer]]:
    """Every answer a task may have from probabilities within `tie` of
    `probs`: the answer at `probs`, and where some probabilities lie
    within `tie` of a decision, the answers with each of those moved by
    `tie` up or down, in every combination.  Tasks go to the oracle in
    their order, each followed by its variants."""
    rows, owner = [], []
    for t, p in enumerate(probs):
        rows.append(p)
        owner.append(t)
        idx = near(oracle.cfg.sizes, p, thresh, cap, tie)
        for bits in range(1 << len(idx) if idx else 0):
            q = p.copy()
            for k, i in enumerate(idx):
                q[i] += tie if bits >> k & 1 else -tie
            rows.append(q)
            owner.append(t)
    owner = np.asarray(owner)
    answers = explore(oracle, np.asarray(net_idx)[owner], np.stack(rows),
                      thresh, cap, np.asarray(lo)[owner],
                      np.asarray(po)[owner], device)
    out: List[Set[Answer]] = [set() for _ in probs]
    for t, a in zip(owner, answers):
        out[t].add(a)
    return out
