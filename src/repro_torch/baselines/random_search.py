"""Random-search DSE baseline (sanity floor, not in the paper's table).

Uniformly samples N configurations and applies the Algorithm 2 selector.
The weakest reasonable baseline: any learned method should beat it at an
equal evaluation budget.

``explore_tasks`` serves a task batch on the method's device: candidate
sampling stays on the host (task t draws from ``default_rng(seed + t)``,
the same sets as the per-task route), and the T Algorithm 2 chains run as
one ``select_batch``.  Models without a torch oracle take the sequential
host loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core.dse_api import DSEResult
from repro_torch.core.explorer import resolve_device, row_seeds
from repro_torch.core.selector import select, select_batch
from repro_torch.dataset.generator import Dataset, DSETask
from repro_torch.design_models.base import DesignModel


@dataclasses.dataclass
class RandomSearch:
    model: DesignModel
    n_samples: int = 256
    #: None: the card (raises without one); the CPU only when named
    device: Union[str, torch.device, None] = None

    method_name = "RandomSearch"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def train(self, n_data: int = 0, iters: int = 0, seed: int = 0,
              ds: Optional[Dataset] = None, log_every: int = 0):
        """Random search is model-free: training is a no-op (DSEMethod
        protocol)."""
        return self

    def _candidates(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return self.model.space.sample_indices(rng, self.n_samples)

    def explore(self, net_idx: np.ndarray, lat_obj: float, pow_obj: float,
                seed: int = 0) -> DSEResult:
        t0 = time.time()
        cands = self._candidates(seed)
        sel = select(self.model, net_idx, cands, lat_obj, pow_obj,
                     device=self.device)
        return DSEResult(sel, float(lat_obj), float(pow_obj), time.time() - t0)

    def explore_tasks(self, tasks: DSETask, seed=0,
                      batched: Optional[bool] = None) -> List[DSEResult]:
        # a model without a torch oracle always takes the host route, even
        # when the batched route is asked for (the GANDSE fallback rule)
        batched = self.model.has_torch_oracle and (batched is None or batched)
        n_tasks = int(tasks.net_idx.shape[0])
        if n_tasks == 0:
            return []
        seeds = row_seeds(seed, n_tasks)
        if not batched:
            return [self.explore(tasks.net_idx[i], tasks.lat_obj[i],
                                 tasks.pow_obj[i], seed=int(seeds[i]))
                    for i in range(n_tasks)]
        t0 = time.time()
        cand = np.stack([self._candidates(int(seeds[t]))
                         for t in range(n_tasks)])
        valid = torch.ones(cand.shape[:2], dtype=torch.bool,
                           device=self.device)
        counts = np.full(n_tasks, self.n_samples)
        sels = select_batch(self.model, tasks.net_idx,
                            torch.from_numpy(cand).to(self.device), valid,
                            counts, tasks.lat_obj, tasks.pow_obj)
        per_task = (time.time() - t0) / n_tasks
        return [
            DSEResult(sel, float(tasks.lat_obj[i]), float(tasks.pow_obj[i]),
                      per_task)
            for i, sel in enumerate(sels)
        ]
