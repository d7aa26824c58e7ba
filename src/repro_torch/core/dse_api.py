"""High-level GANDSE API: the phases of Fig. 4.

- Parsing phase:  ``parse_network`` (abstract layer description -> net params)
- Training phase: ``GANDSE.train`` (Algorithm 1, ``core/train.py``, on the
  engine's device), or trained params from elsewhere through ``attach``
  (for example converted from the reference package with
  ``repro_torch.convert``)
- Exploration:    ``GANDSE.explore`` (G inference -> candidates -> Algorithm 2)
  and its batched twin ``GANDSE.explore_batch`` (G over the whole task
  batch on the card, then ``fused_select.select_from_probs``: the dense
  route or the streaming one)
- Implementation: ``GANDSE.emit_config`` (structured design artifact)
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Dict, List, Optional, Protocol, Sequence, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core import gan as G
from repro_torch.core import shard
from repro_torch.core.explorer import (Explorer, ExplorerConfig,
                                       resolve_device, row_seeds)
from repro_torch.core.fused_select import select_from_probs
from repro_torch.core.selector import Selection, select
from repro_torch.core.train import TrainState, train_gan
from repro_torch.dataset.generator import Dataset, DSETask, generate_dataset
from repro_torch.design_models.base import DesignModel


def parse_network(desc: Dict[str, float], model: DesignModel) -> np.ndarray:
    """Parsing phase: {'IC':64, 'OC':32, ...} -> net-space indices, each
    value snapped to the nearest legal sampled value."""
    names = [d.name for d in model.net_space.dims]
    vals = np.array([[float(desc[n]) for n in names]])
    return model.net_space.indices_from_values(vals)[0]


#: scalar-or-per-row-array seed accepted by every batch entry point
SeedLike = Union[int, np.ndarray]


def cache_key(model_name: str, net_idx: np.ndarray, lat_obj: float,
              pow_obj: float, seed: int) -> tuple:
    """Hashable identity of one DSE task row.  Two submissions with equal
    keys get the same Selection (the per-task noise key is PRNGKey(seed),
    independent of batch placement — and the same key as the reference
    package draws, so the identity holds across both packages)."""
    return (str(model_name),
            tuple(int(v) for v in np.asarray(net_idx).reshape(-1)),
            float(lat_obj), float(pow_obj), int(seed))


@dataclasses.dataclass
class DSEResult:
    selection: Selection
    lat_obj: float
    pow_obj: float
    dse_seconds: float

    @property
    def satisfied(self) -> bool:
        return self.selection.satisfied

    @property
    def improvement_ratio(self) -> Optional[float]:
        return self.selection.improvement_ratio(self.lat_obj, self.pow_obj)


@runtime_checkable
class DSEMethod(Protocol):
    """What every DSE engine speaks — GANDSE and all baselines
    (``repro_torch.baselines``).  The comparison harness
    (``launch/comparison.py``) treats methods uniformly through it:

    - ``train(n_data, iters, seed=, ds=, log_every=)``: fit on a (shared)
      dataset; model-free methods (SA, random search) accept the call as a
      no-op so one loop drives every method.
    - ``explore(net_idx, lat_obj, pow_obj, seed=)``: one DSE task ->
      ``DSEResult``.
    - ``explore_tasks(tasks, seed=)``: a task batch -> ``List[DSEResult]``,
      served batched on the method's device where the model has a torch
      oracle, else through the sequential host loop.  ``seed`` is a scalar
      (row t explores with seed + t) or a (T,) per-row seed array.
    """

    model: DesignModel
    method_name: str

    def train(self, n_data: int, iters: int, seed: int = 0,
              ds: Optional[Dataset] = None, log_every: int = 0) -> object: ...

    def explore(self, net_idx: np.ndarray, lat_obj: float, pow_obj: float,
                seed: int = 0) -> "DSEResult": ...

    def explore_tasks(self, tasks: DSETask, seed: SeedLike = 0
                      ) -> List["DSEResult"]: ...


class GANDSE:
    """End-to-end framework object for one design template (design model),
    on one device (the card unless the caller names another)."""

    method_name = "GANDSE"

    def __init__(self, model: DesignModel, gan_cfg: Optional[G.GANConfig] = None,
                 explorer_cfg: Optional[ExplorerConfig] = None,
                 device: Union[str, torch.device, None] = None):
        self.model = model
        n_net = model.net_space.n_dims
        self.gan_cfg = gan_cfg or G.GANConfig(n_net=n_net)
        if self.gan_cfg.n_net != n_net:
            raise ValueError(f"gan_cfg.n_net is {self.gan_cfg.n_net}; "
                             f"{model.name} has {n_net} net dims")
        self.explorer_cfg = explorer_cfg or ExplorerConfig()
        self.device = resolve_device(device)
        self.ds: Optional[Dataset] = None
        self.state: Optional[TrainState] = None
        self._explorer: Optional[Explorer] = None

    # ---- training phase ----------------------------------------------------
    def train(self, n_data: int, iters: int, seed: int = 0, log_every: int = 0,
              ds: Optional[Dataset] = None) -> TrainState:
        """Algorithm 1 on this object's device (a dataset of `n_data` rows
        from `seed` unless `ds` is given), then attach the trained G."""
        self.ds = ds if ds is not None else generate_dataset(
            self.model, n_data, seed=seed)
        self.state = train_gan(self.model, self.ds, self.gan_cfg, iters=iters,
                               seed=seed, log_every=log_every,
                               device=self.device)
        self.attach(self.ds, self.state.g_params)
        return self.state

    def set_use_fused(self, use_fused: Optional[bool]) -> "GANDSE":
        """Set ``GANConfig.use_fused`` (None/True: the kernels on the card;
        False: the plain versions everywhere, an explicit opt-out) — the
        serving tier's override hook.  An attached explorer is rebuilt on
        the same params."""
        self.gan_cfg = dataclasses.replace(self.gan_cfg, use_fused=use_fused)
        if self._explorer is not None:
            assert self.ds is not None    # an attached explorer implies it
            self.attach(self.ds, self._explorer.g_params)
        return self

    @property
    def g_params(self) -> Optional[Dict]:
        """Currently attached generator params (None before ``train()`` /
        ``attach()``)."""
        return None if self._explorer is None else self._explorer.g_params

    def attach(self, ds: Dataset, g_params: Dict) -> Explorer:
        """Serving entry: wire a dataset (for its normalizers) and generator
        params (moved to this object's device) into the explorer."""
        self.ds = ds
        params = {"layers": [{k: v.to(self.device) for k, v in p.items()}
                             for p in g_params["layers"]]}
        self._explorer = Explorer(self.model, ds, params, self.gan_cfg,
                                  self.explorer_cfg, self.device)
        return self._explorer

    # ---- exploration phase ---------------------------------------------------
    def explore(self, net_idx: np.ndarray, lat_obj: float, pow_obj: float,
                seed: int = 0) -> DSEResult:
        assert self._explorer is not None, "call train() or attach() first"
        t0 = time.time()
        cands = self._explorer.candidates(net_idx, lat_obj, pow_obj, seed=seed)
        sel = select(self.model, net_idx, cands, lat_obj, pow_obj,
                     device=self.device)
        return DSEResult(sel, float(lat_obj), float(pow_obj), time.time() - t0)

    def explore_batch(self, tasks: DSETask,
                      seed: SeedLike = 0) -> List[DSEResult]:
        """Batched exploration: G inference over the flattened (task,
        sample) rows on the device -> enumerate/score/select on the device
        (``fused_select.select_from_probs``, which picks the dense or the
        streaming route from the batch and the cap) -> float64 host
        re-score of the winners.

        Task i uses seed + i (or seed[i] for a (T,) array), so its candidate
        set equals ``explore(tasks.net_idx[i], ..., seed=seed + i)``'s; the
        winner too, except where the float64 host loop of `explore` and the
        float32 device chain split a near-tie.  dse_seconds is the
        amortized per-task wall-clock (total / n_tasks).  The batch is
        padded to its power-of-two bucket (``shard.pad_tasks``; padded rows
        repeat the last row and are discarded).  Under an active task mesh
        (``shard.set_task_mesh``) the padded size is also a multiple of the
        shard count, each rank runs the chain on its block of rows and the
        Selections are gathered in task order (``shard.map_tasks``): the
        same bits as one rank's.  Models without a torch oracle fall back
        to the sequential host route.
        """
        assert self._explorer is not None, "call train() or attach() first"
        n_tasks = int(tasks.net_idx.shape[0])
        if n_tasks == 0:
            return []
        if not self.model.has_torch_oracle:
            return self._explore_seq(tasks, seed)
        t0 = time.time()

        def rows(tasks_r, seeds_r):
            probs = self._explorer.generator_probs_device(
                tasks_r.net_idx, tasks_r.lat_obj, tasks_r.pow_obj,
                seed=seeds_r)
            return select_from_probs(self.model, tasks_r.net_idx, probs,
                                     self.explorer_cfg, tasks_r.lat_obj,
                                     tasks_r.pow_obj)

        sels = shard.map_tasks(rows, tasks, row_seeds(seed, n_tasks))
        per_task = (time.time() - t0) / n_tasks
        return [
            DSEResult(sel, float(tasks.lat_obj[i]), float(tasks.pow_obj[i]),
                      per_task)
            for i, sel in enumerate(sels)
        ]

    def explore_tasks(self, tasks: DSETask, seed: SeedLike = 0,
                      batched: Optional[bool] = None) -> List[DSEResult]:
        """Explore a task batch.  batched=None routes through
        `explore_batch` whenever the model has a torch oracle; False forces
        the sequential per-task loop."""
        if batched is None:
            batched = self.model.has_torch_oracle
        if batched:
            return self.explore_batch(tasks, seed=seed)
        return self._explore_seq(tasks, seed)

    def _explore_seq(self, tasks: DSETask, seed: SeedLike) -> List[DSEResult]:
        seeds = row_seeds(seed, tasks.net_idx.shape[0])
        return [
            self.explore(tasks.net_idx[i], tasks.lat_obj[i], tasks.pow_obj[i],
                         seed=seeds[i])
            for i in range(tasks.net_idx.shape[0])
        ]

    # ---- implementation phase ------------------------------------------------
    def emit_config(self, result: DSEResult) -> Dict:
        """Structured design artifact (stands in for RTL emission)."""
        sel = result.selection
        assert sel.cfg_idx is not None
        vals = self.model.space.values_from_indices(sel.cfg_idx[None])[0]
        return {
            "design_model": self.model.name,
            "config": {d.name: v for d, v in zip(self.model.space.dims, vals.tolist())},
            "predicted": {"latency_s": sel.latency, "power_w": sel.power},
            "objectives": {"latency_s": result.lat_obj, "power_w": result.pow_obj},
            "satisfied": sel.satisfied,
        }


def summarize(results: Sequence[DSEResult]) -> Dict[str, float]:
    """Table-5-style metrics: satisfied count, improvement ratio, DSE time,
    candidate count, error stds (Fig. 5).  Empty inputs report zero
    counts/times; averages over an empty subset report NaN."""
    n = len(results)
    sat = [r for r in results if r.satisfied]
    irs = [r.improvement_ratio for r in sat if r.improvement_ratio is not None]
    lerr = [(r.selection.latency - r.lat_obj) / r.lat_obj
            for r in results if np.isfinite(r.selection.latency)]
    perr = [(r.selection.power - r.pow_obj) / r.pow_obj
            for r in results if np.isfinite(r.selection.power)]
    return {
        "n_tasks": n,
        "n_satisfied": len(sat),
        "improvement_ratio": float(np.mean(irs)) if irs else float("nan"),
        "dse_time_s": float(np.mean([r.dse_seconds for r in results])) if n else 0.0,
        "n_candidates": float(np.mean([r.selection.n_candidates
                                       for r in results])) if n else 0.0,
        "lat_err_std": float(np.std(lerr)) if lerr else float("nan"),
        "pow_err_std": float(np.std(perr)) if perr else float("nan"),
    }
