"""Large-MLP DSE baseline (paper §7.1.4, AIRCHITECT-style, Fig. 3(a)).

A single MLP regresses from (net params, objectives, noise) to the
training-set configurations with plain per-group cross entropy: no
satisfaction mask, no discriminator.  Its parameter count is matched to
the full GAN (G + D): 16 x 2048 by default.  The design selector
(Algorithm 2) is applied to its thresholded outputs, as in the paper.

Training runs every layer through ``nn/layers.mlp_apply`` (the dense
kernels and their backward on the card); the noise of each step is
``sample_noise_dim`` from ``split(rng)``, as Algorithm 1 draws it.
Exploration mirrors the GANDSE explorer: the MLP receives the same noise
input as G, task t averages ``noise_samples`` forward passes drawn from
``fold_in(PRNGKey(seed + t), s)``, and the (task, sample) rows run as one
batch through the whole-MLP kernel (``mlp_apply_chained``), then
GANDSE's select (``fused_select.select_from_probs``).  Models without a
torch oracle take the sequential host loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core import shard
from repro_torch.core.dse_api import DSEResult
from repro_torch.core.explorer import (ExplorerConfig, enumerate_candidates,
                                       flatten_task_draws, resolve_device,
                                       row_seeds, task_keys)
from repro_torch.core.fused_select import select_from_probs
from repro_torch.core.selector import select
from repro_torch.core.train import encode_dataset, value_and_grad
from repro_torch.dataset.generator import Dataset, DSETask, generate_dataset
from repro_torch.design_models.base import DesignModel
from repro_torch.nn import layers as L
from repro_torch.optim import adam, apply_updates, tree_leaves

#: the training batch's fields the loss reads
_BATCH_KEYS = ("net_enc", "obj_enc", "cfg_onehot")


@dataclasses.dataclass
class LargeMLP:
    model: DesignModel
    hidden_layers: int = 16           # parameter-matched to G+D
    neurons: int = 2048
    lr: float = 2e-5
    batch_size: int = 1024
    noise_dim: int = 8
    explorer_cfg: ExplorerConfig = dataclasses.field(
        default_factory=ExplorerConfig)
    #: None: the card (raises without one); the CPU only when named
    device: Union[str, torch.device, None] = None

    method_name = "LargeMLP"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ds: Optional[Dataset] = None
        self.params = None

    def n_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.params))

    def init_params(self, seed: int = 0):
        """Fresh params on this object's device: ``mlp_init(PRNGKey(seed),
        ...)``, bit for bit the reference's.  The single definition of the
        input width (net params + 2 objective channels + noise)."""
        n_in = self.model.net_space.n_dims + 2 + self.noise_dim
        return L.mlp_init(prng.prng_key(torch.tensor(seed)), n_in,
                          [self.neurons] * self.hidden_layers,
                          self.model.space.onehot_width, self.device)

    # ---- training ----------------------------------------------------------
    def probs(self, params, net_enc: torch.Tensor, obj_enc: torch.Tensor,
              noise: torch.Tensor, use_fused: Optional[bool] = None
              ) -> torch.Tensor:
        """The training forward: per-group softmax of ``mlp_apply`` (one
        dense kernel a layer on the card, differentiable)."""
        x = torch.cat([net_enc, obj_enc, noise], dim=-1)
        return G.group_softmax(self.model.space,
                               L.mlp_apply(params, x, use_fused=use_fused))

    def loss_and_grads(self, params, batch, noise: torch.Tensor,
                       use_fused: Optional[bool] = None):
        """The mean grouped cross entropy of a batch and its gradients (a
        tree like params); the caller's params are left as they are."""
        def loss_fn(p):
            probs = self.probs(p, batch["net_enc"], batch["obj_enc"], noise,
                               use_fused)
            loss = torch.mean(G.grouped_cross_entropy(
                self.model.space, batch["cfg_onehot"], probs))
            return loss, None
        (loss, _), grads = value_and_grad(loss_fn, params)
        return loss, grads

    def make_step(self, use_fused: Optional[bool] = None):
        """(optimizer, step): step(params, opt, batch, rng) -> (params,
        opt, rng, loss), the reference's jitted step: ``rng, nrng =
        split(rng)``, noise ``sample_noise_dim(nrng, B, noise_dim)``, one
        Adam update.  The noise takes the batch's dtype."""
        optim = adam(self.lr)

        def step(params, opt, batch, rng):
            rng, nrng = prng.split(rng)
            b = batch["net_enc"].shape[0]
            noise = G.sample_noise_dim(nrng, b, self.noise_dim) \
                .to(batch["net_enc"].dtype)
            loss, grads = self.loss_and_grads(params, batch, noise, use_fused)
            upd, opt = optim.update(grads, opt)
            return apply_updates(params, upd), opt, rng, loss

        return optim, step

    def train(self, n_data: int, iters: int, seed: int = 0,
              ds: Optional[Dataset] = None, log_every: int = 0):
        """`iters` epochs of mini-batch Adam on this object's device.  The
        dataset is encoded and uploaded once; each epoch's permutation
        comes from ``np.random.default_rng(seed)``, as in the reference."""
        self.ds = ds if ds is not None else generate_dataset(
            self.model, n_data, seed=seed)
        rng = prng.prng_key(torch.tensor(seed)).to(self.device)
        params = self.init_params(seed)
        optim, step = self.make_step()
        opt = optim.init(params)
        data = {k: v for k, v in encode_dataset(
            self.model, self.ds, self.device).items() if k in _BATCH_KEYS}
        np_rng = np.random.default_rng(seed)
        n = self.ds.n
        bs = min(self.batch_size, n)
        for it in range(iters):
            perm = torch.from_numpy(np_rng.permutation(n)).to(self.device)
            for b0 in range(0, n - bs + 1, bs):
                batch = {k: v[perm[b0:b0 + bs]] for k, v in data.items()}
                params, opt, rng, loss = step(params, opt, batch, rng)
            if log_every and it % log_every == 0:
                print(f"[large_mlp] iter={it} loss={float(loss):.4f}")
        self.params = params
        return self

    def attach(self, ds: Dataset, params) -> "LargeMLP":
        """Serving entry (mirrors GANDSE.attach): a dataset (for its
        normalizers) and trained params, moved to this object's device."""
        self.ds = ds
        self.params = {"layers": [{k: v.to(self.device) for k, v in p.items()}
                                  for p in params["layers"]]}
        return self

    # ---- exploration -------------------------------------------------------
    @torch.no_grad()
    def generator_probs_device(self, net_idx: np.ndarray, lat_obj, pow_obj,
                               seed=0) -> torch.Tensor:
        """Noise-averaged probs of a task batch, (T, onehot_width) on this
        object's device.  Task row t draws from PRNGKey(seed + t) (or
        seed[t]), so it equals a single-task call with that seed; the
        (task, sample) rows run as one batch through the whole-MLP
        kernel."""
        net_enc = self.ds.net_encoded(self.model, np.atleast_2d(net_idx))
        obj_enc = self.ds.obj_encoded(np.atleast_1d(lat_obj),
                                      np.atleast_1d(pow_obj))
        t, n_s = net_enc.shape[0], self.explorer_cfg.noise_samples
        net_r, obj_r, noise_r = flatten_task_draws(
            torch.from_numpy(net_enc), torch.from_numpy(obj_enc),
            task_keys(seed, t), n_s,
            lambda k: G.sample_noise_dim(k, 1, self.noise_dim)[..., 0, :])
        x = torch.cat([net_r, obj_r, noise_r], dim=-1).to(self.device)
        logits = L.mlp_apply_chained(self.params, x)
        probs = G.group_softmax(self.model.space, logits)
        return probs.reshape(t, n_s, -1).mean(dim=1)

    def explore(self, net_idx: np.ndarray, lat_obj: float, pow_obj: float,
                seed: int = 0) -> DSEResult:
        t0 = time.time()
        probs = self.generator_probs_device(net_idx, lat_obj, pow_obj,
                                            seed)[0].cpu().numpy()
        cands = enumerate_candidates(self.model.space, probs,
                                     self.explorer_cfg.prob_threshold,
                                     self.explorer_cfg.max_candidates)
        sel = select(self.model, net_idx, cands, lat_obj, pow_obj,
                     device=self.device)
        return DSEResult(sel, float(lat_obj), float(pow_obj), time.time() - t0)

    def explore_batch(self, tasks: DSETask, seed=0) -> List[DSEResult]:
        """Batched exploration, the structure (and parity contract) of
        ``GANDSE.explore_batch``: the noise-averaged forward, then
        ``select_from_probs``.  dse_seconds is the amortized per-task
        wall-clock."""
        n_tasks = int(tasks.net_idx.shape[0])
        if n_tasks == 0:
            return []
        if not self.model.has_torch_oracle:
            return self._explore_seq(tasks, seed)
        t0 = time.time()

        def rows(tasks_r, seeds_r):
            probs = self.generator_probs_device(
                tasks_r.net_idx, tasks_r.lat_obj, tasks_r.pow_obj, seeds_r)
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

    def explore_tasks(self, tasks: DSETask, seed=0,
                      batched: Optional[bool] = None) -> List[DSEResult]:
        if batched is None:
            batched = self.model.has_torch_oracle
        if batched:
            return self.explore_batch(tasks, seed=seed)
        return self._explore_seq(tasks, seed)

    def _explore_seq(self, tasks: DSETask, seed) -> List[DSEResult]:
        seeds = row_seeds(seed, tasks.net_idx.shape[0])
        return [self.explore(tasks.net_idx[i], tasks.lat_obj[i],
                             tasks.pow_obj[i], seed=int(seeds[i]))
                for i in range(tasks.net_idx.shape[0])]
