"""Simulated annealing DSE baseline (paper §7.1.4).

Iterative DSE in the classic Fig. 1 loop: the configuration-updating
algorithm is SA over the discrete choice indices; the design model scores
each visited configuration.  "SA terminates once the user's objectives are
satisfied, or the temperature is 3e-8 x the initial one."

Two routes share the annealing schedule:

- **device** (the default when the model has a torch oracle): every task
  is a lane of one batched loop on the method's device — propose, score
  with ``DesignModel.evaluate_torch``, accept — the reference's vmapped
  ``lax.while_loop`` written out.  A lane whose best violation reaches 0
  (or whose budget ends) freezes: every update of its carry is masked,
  its key included, so lane t is the single-task run with seed + t.  The
  loop reads its stop flag on the host every ``CHECK_EVERY`` steps and
  ends when no lane is active.  Each lane's threefry key chain, and every
  draw from it, is computed a check interval ahead on the host, as integer
  arithmetic (the bits do not depend on where they are computed): the
  chain is ~170 tiny integer ops a step, which the host runs several times
  faster than the card can launch them (PERF.md), and one copy an
  interval moves the draws over before its steps.  Winners are re-scored
  once by the float64 host oracle (``selections_from_winners``).
- **host** (models without a torch oracle, or ``use_torch=False``): the
  numpy loop with one ``evaluate_indices`` call per step.

The temperature ``t_init * cooling ** k`` takes the power as XLA does
(``prng.pow_f32``).  The accept test ``u < exp(-(e - cur_e) / temp)``
runs in float32 with torch's ``exp``, which is an ulp away from XLA's at
some arguments (PERF.md): that changes an accept only where ``u`` falls
inside that ulp.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import shard
from repro_torch.core.dse_api import DSEResult
from repro_torch.core.explorer import resolve_device, row_seeds, task_keys
from repro_torch.core.selector import (Selection, is_satisfied,
                                       selections_from_winners)
from repro_torch.dataset.generator import Dataset, DSETask
from repro_torch.design_models.base import DesignModel

#: violation assigned to infeasible (non-finite metric) configurations
_BIG = 1e9
#: steps between two host reads of the device route's stop flag
CHECK_EVERY = 32


def _violation(lat, pw, lo, po):
    """Objective violation; non-finite (inf/NaN) metrics -> _BIG (both
    metrics guarded, so no inf/NaN energy reaches the accept test)."""
    if not (np.isfinite(lat) and np.isfinite(pw)):
        return _BIG
    return max(0.0, (lat - lo) / lo) + max(0.0, (pw - po) / po)


def _temperatures(t_init: float, cooling: float, steps_per_temp: int,
                  max_steps: int) -> np.ndarray:
    """float32 ``max(t_init * cooling ** (step // steps_per_temp), 1e-12)``
    for every step, the power as XLA takes it in float32
    (``prng.pow_f32``), then the float32 product and clamp."""
    k = np.arange(max_steps) // steps_per_temp
    power = prng.pow_f32(float(np.float32(cooling)), np.unique(k))[k]
    return np.maximum(np.float32(t_init) * power, np.float32(1e-12))


def _draws(key: torch.Tensor, n_steps: int, n_dims: int):
    """The next `n_steps` steps of every lane's key chain (``key, kd, km,
    ks, kr, ka = split(key, 6)``) and their draws, on the key's device:
    the chain's next key (T, 2), the dimension d (T, n_steps), and u (T,
    n_steps, 4) for km, ks, kr, ka."""
    subs = []
    for _ in range(n_steps):
        ks = prng.split(key, 6)
        key = ks[:, 0]
        subs.append(ks[:, 1:])
    sub = torch.stack(subs, dim=1)                    # (T, n_steps, 5, 2)
    d = prng.randint(sub[:, :, 0], 1, 0, n_dims)[..., 0]
    u = prng.uniform(sub[:, :, 1:], 1, 0.0, 1.0)[..., 0]
    return key, d, u


def anneal(model: DesignModel, net_idx: torch.Tensor, lo: torch.Tensor,
           po: torch.Tensor, keys: torch.Tensor, t_init: float,
           cooling: float, steps_per_temp: int, max_steps: int):
    """The batched anneal on the device of `net_idx`: net_idx (T,
    n_net_dims) int64, float32 objectives lo, po (T,), threefry keys (T,
    2) -> (best cfg (T, n_dims), best violation (T,), n_eval (T,)).  Lane
    t is the reference's ``_sa_device_kernel`` lane for keys[t]."""
    dev = net_idx.device
    space = model.space
    n_dims = space.n_dims
    sizes = torch.as_tensor(space.group_sizes, dtype=torch.int64,
                            device=dev)
    temps = torch.from_numpy(_temperatures(t_init, cooling, steps_per_temp,
                                           max_steps)).to(dev)
    lane = torch.arange(net_idx.shape[0], device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)

    def score(cfg):
        lat, pw = model.evaluate_torch_indices(net_idx, cfg)
        lat, pw = lat.to(torch.float32), pw.to(torch.float32)
        v = (torch.clamp((lat - lo) / lo, min=0.0)
             + torch.clamp((pw - po) / po, min=0.0))
        return lat, pw, torch.where(torch.isfinite(lat) & torch.isfinite(pw),
                                    v, big)

    keys = prng.split(keys.cpu())
    key, k0 = keys[:, 0], keys[:, 1]
    cur = torch.floor(prng.uniform(k0, n_dims, 0.0, 1.0).to(dev)
                      * sizes).to(torch.int64)
    best_l, best_p, cur_e = score(cur)
    best, best_e = cur, cur_e
    n_eval = torch.ones_like(lane)
    step = 0
    while step < max_steps:
        n = min(CHECK_EVERY, max_steps - step)
        key, d_all, u_all = _draws(key, n, n_dims)
        d_all, u_all = d_all.to(dev), u_all.to(dev)
        for s in range(n):
            active = best_e > 0.0
            d, u = d_all[:, s], u_all[:, s]
            nd = sizes[d]
            local = torch.clamp(cur[lane, d] + torch.where(u[:, 1] < 0.5, -1, 1),
                                min=0)
            local = torch.minimum(local, nd - 1)
            redraw = torch.floor(u[:, 2] * nd).to(torch.int64)
            nxt = cur.clone()
            nxt[lane, d] = torch.where(u[:, 0] < 0.5, local, redraw)
            lat, pw, e = score(nxt)
            temp = temps[step + s].expand_as(e)
            accept = active & ((e < cur_e)
                               | (u[:, 3] < torch.exp(-(e - cur_e) / temp)))
            improved = accept & ((e < best_e)
                                 | ((e == best_e)
                                    & (lat + pw < best_l + best_p)))
            cur = torch.where(accept[:, None], nxt, cur)
            cur_e = torch.where(accept, e, cur_e)
            best = torch.where(improved[:, None], nxt, best)
            best_l = torch.where(improved, lat, best_l)
            best_p = torch.where(improved, pw, best_p)
            best_e = torch.where(improved, e, best_e)
            n_eval = n_eval + active.to(n_eval.dtype)
        step += n
        # the stop flag: one host read a check interval
        if not bool((best_e > 0.0).any()):  # lint: dispatch-sync-ok
            break
    return best, best_e, n_eval


@dataclasses.dataclass
class SimulatedAnnealing:
    model: DesignModel
    t_init: float = 1.0
    t_stop_frac: float = 3e-8
    cooling: float = 0.95
    steps_per_temp: int = 4
    seed: int = 0
    #: None: the card (raises without one); the CPU only when named
    device: Union[str, torch.device, None] = None

    method_name = "SA"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def train(self, n_data: int = 0, iters: int = 0, seed: int = 0,
              ds: Optional[Dataset] = None, log_every: int = 0):
        """SA is model-free: training is a no-op (DSEMethod protocol)."""
        return self

    @property
    def max_steps(self) -> int:
        """Proposal budget of one anneal: temperatures until the stop
        fraction, times steps per temperature (the host loop's count)."""
        n_temps = int(np.ceil(np.log(self.t_stop_frac) / np.log(self.cooling)))
        return n_temps * self.steps_per_temp

    # --- device route -------------------------------------------------------
    def _explore_device(self, tasks: DSETask, seed) -> List[DSEResult]:
        n_tasks = int(tasks.net_idx.shape[0])
        t0 = time.time()
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def rows(tasks_r, seeds_r):
            best, _, n_eval = anneal(
                self.model,
                torch.as_tensor(np.asarray(tasks_r.net_idx),
                                dtype=torch.int64, device=dev),
                f32(tasks_r.lat_obj), f32(tasks_r.pow_obj),
                task_keys(seeds_r, len(seeds_r)), self.t_init, self.cooling,
                self.steps_per_temp, self.max_steps)
            # every lane has a winner: one float64 host-oracle call
            # re-scores them all
            n = len(seeds_r)
            return selections_from_winners(
                self.model, tasks_r.net_idx, np.zeros(n, np.int64),
                best.to(torch.int32).cpu().numpy(), n_eval.cpu().numpy(),
                tasks_r.lat_obj, tasks_r.pow_obj)

        # the anneal lanes shard over the active task mesh (pad, run a
        # block a rank, gather, discard the padded lanes)
        sels = shard.map_tasks(rows, tasks, row_seeds(seed, n_tasks))
        per_task = (time.time() - t0) / n_tasks
        return [DSEResult(sel, float(tasks.lat_obj[t]),
                          float(tasks.pow_obj[t]), per_task)
                for t, sel in enumerate(sels)]

    # --- host route ---------------------------------------------------------
    def _explore_host(self, net_idx: np.ndarray, lat_obj: float,
                      pow_obj: float, seed: Optional[int]) -> DSEResult:
        rng = np.random.default_rng(self.seed if seed is None else seed)
        space = self.model.space
        t0 = time.time()
        lo, po = float(lat_obj), float(pow_obj)

        cur = space.sample_indices(rng, 1)[0]
        lat, pw = self.model.evaluate_indices(net_idx[None], cur[None])
        cur_l, cur_p = float(lat[0]), float(pw[0])
        cur_e = _violation(cur_l, cur_p, lo, po)
        best = (cur.copy(), cur_l, cur_p, cur_e)
        n_eval = 1

        temp = self.t_init
        while temp > self.t_init * self.t_stop_frac and best[3] > 0.0:
            for _ in range(self.steps_per_temp):
                nxt = cur.copy()
                d = rng.integers(0, space.n_dims)
                if rng.random() < 0.5:  # local move
                    nxt[d] = int(np.clip(nxt[d] + rng.choice([-1, 1]), 0,
                                         space.dims[d].n - 1))
                else:                   # random re-draw
                    nxt[d] = rng.integers(0, space.dims[d].n)
                lat, pw = self.model.evaluate_indices(net_idx[None], nxt[None])
                n_eval += 1
                nl, np_ = float(lat[0]), float(pw[0])
                e = _violation(nl, np_, lo, po)
                if e < cur_e or rng.random() < np.exp(-(e - cur_e) / max(temp, 1e-12)):
                    cur, cur_l, cur_p, cur_e = nxt, nl, np_, e
                    if e < best[3] or (e == best[3] and nl + np_ < best[1] + best[2]):
                        best = (cur.copy(), nl, np_, e)
                if best[3] == 0.0:
                    break
            temp *= self.cooling

        cfg, bl, bp, be = best
        sel = Selection(cfg_idx=cfg, latency=bl, power=bp,
                        satisfied=is_satisfied(bl, bp, lo, po),
                        n_candidates=n_eval)
        return DSEResult(sel, lo, po, time.time() - t0)

    # --- public API ---------------------------------------------------------
    def explore(self, net_idx: np.ndarray, lat_obj: float, pow_obj: float,
                seed: Optional[int] = None,
                use_torch: Optional[bool] = None) -> DSEResult:
        # a model without a torch oracle always takes the host route, even
        # when the device route is asked for (the GANDSE fallback rule)
        use_torch = self.model.has_torch_oracle and (use_torch is None
                                                     or use_torch)
        if use_torch:
            tasks = DSETask.single(net_idx, lat_obj, pow_obj)
            return self._explore_device(
                tasks, self.seed if seed is None else seed)[0]
        return self._explore_host(net_idx, lat_obj, pow_obj, seed)

    def explore_tasks(self, tasks: DSETask, seed=0,
                      batched: Optional[bool] = None) -> List[DSEResult]:
        batched = self.model.has_torch_oracle and (batched is None or batched)
        n_tasks = int(tasks.net_idx.shape[0])
        if n_tasks == 0:
            return []
        if batched:
            return self._explore_device(tasks, seed)
        seeds = row_seeds(seed, n_tasks)
        return [self.explore(tasks.net_idx[i], tasks.lat_obj[i],
                             tasks.pow_obj[i], seed=int(seeds[i]),
                             use_torch=False)
                for i in range(n_tasks)]
