"""Deep-reinforcement-learning DSE baseline (paper §7.1.4, ConfuciuX-style).

Policy-gradient (REINFORCE with a moving baseline).  The state is the
current (network parameters, objectives, configuration); actions set one
configuration dimension to one of its choices; the reward is the decrease
in objective violation, with a bonus when the state satisfies the
objectives.  An MLP actor is trained offline over dataset-derived tasks
(the host oracle, Gumbel noise from numpy, the policy through
``nn/layers.mlp_apply``: the dense kernels on the card); at DSE time a
short greedy rollout is run and the best visited configuration is
returned.

Violations are clipped to ``VIOL_CLIP`` per metric, so no one-step reward
of an infeasible config swamps the moving baseline.

DSE-time rollouts have two routes:

- **device** (the default when the model has a torch oracle): the
  rollout's ``rollout_len`` steps run batched over the task lanes, each
  step one ``mlp_apply`` over the (T, n_in) states, one ``argmax`` and one
  torch-oracle call — the reference's vmapped ``lax.scan``.  Lane t draws
  from PRNGKey(seed + t), so a batched lane is the single-task run with
  seed + t; every draw of the rollout is made on the host before its
  first step (``rollout_draws``: the threefry chain is many tiny integer
  ops, cheaper on the host than as launches on the card, PERF.md) and
  copied over once; winners are re-scored once by the float64 host
  oracle (``selections_from_winners``).
- **host** (models without a torch oracle): the numpy loop.
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
from repro_torch.core.train import encode_batch, value_and_grad
from repro_torch.dataset.generator import Dataset, DSETask, generate_dataset
from repro_torch.design_models.base import DesignModel
from repro_torch.nn import layers as L
from repro_torch.optim import adam, apply_updates

#: per-metric violation cap: bounds any one-step reward to
#: 2 * VIOL_CLIP + sat_bonus regardless of how infeasible a config is
VIOL_CLIP = 10.0


def _violation(lat, pw, lo, po):
    """Relative objective violation, each metric's term clipped to
    VIOL_CLIP (NaN/inf metrics saturate at the clip)."""
    lat = np.where(np.isnan(lat), np.inf, np.asarray(lat, np.float64))
    pw = np.where(np.isnan(pw), np.inf, np.asarray(pw, np.float64))
    lv = np.minimum(np.maximum(0.0, (lat - lo) / lo), VIOL_CLIP)
    pv = np.minimum(np.maximum(0.0, (pw - po) / po), VIOL_CLIP)
    return lv + pv


def rollout_draws(keys: torch.Tensor, n_dims: int, rollout_len: int,
                  width: int, explore_eps: float):
    """Every draw of a rollout, on the keys' device, before its first
    step: from ``key, k0 = split(keys)`` the start uniforms (T, n_dims)
    of k0, then the chain ``key, ke, ka = split(key, 3)`` a step, each
    step's exploration flag ``uniform(ke) < eps`` and random action
    ``randint(ka, 0, width)``, both (T, rollout_len).  The reference
    draws the same bits inside its scan."""
    k = prng.split(keys)
    key, k0 = k[:, 0], k[:, 1]
    subs = []
    for _ in range(rollout_len):
        key, ke, ka = prng.split(key, 3).unbind(1)
        subs.append(torch.stack([ke, ka], dim=1))
    sub = torch.stack(subs, dim=1)                    # (T, L, 2, 2)
    eps = float(np.float32(explore_eps))
    rand = prng.uniform(sub[:, :, 0], 1, 0.0, 1.0)[..., 0] < eps
    act = prng.randint(sub[:, :, 1], 1, 0, width)[..., 0]
    return prng.uniform(k0, n_dims, 0.0, 1.0), rand, act


def rollout(model: DesignModel, params, net_idx: torch.Tensor,
            net_enc: torch.Tensor, obj_enc: torch.Tensor, lo: torch.Tensor,
            po: torch.Tensor, keys: torch.Tensor, rollout_len: int,
            explore_eps: float) -> torch.Tensor:
    """The batched greedy rollout on the device of `net_idx`: net_idx (T,
    n_net_dims) int64, encodings (T, ·), float32 objectives (T,), threefry
    keys (T, 2) -> the best visited config (T, n_dims).  Lane t is the
    reference's ``_drl_rollout_kernel`` lane for keys[t]."""
    dev = net_idx.device
    space = model.space
    n_dims, width = space.n_dims, space.onehot_width
    sizes = torch.as_tensor(space.group_sizes, dtype=torch.int64, device=dev)
    offs = np.concatenate([[0], np.cumsum(space.group_sizes)])
    starts = torch.as_tensor(offs[:-1], dtype=torch.int64, device=dev)
    ends = torch.as_tensor(offs[1:], dtype=torch.int64, device=dev)
    lanes = torch.arange(net_idx.shape[0], device=dev)

    def onehot(cfg):
        return torch.zeros((cfg.shape[0], width), dtype=torch.float32,
                           device=dev).scatter_(1, starts + cfg, 1.0)

    def score(cfg):
        lat, pw = model.evaluate_torch_indices(net_idx, cfg)
        lat = torch.where(torch.isnan(lat), float("inf"), lat).to(torch.float32)
        pw = torch.where(torch.isnan(pw), float("inf"), pw).to(torch.float32)
        lv = torch.clamp(torch.clamp((lat - lo) / lo, min=0.0), max=VIOL_CLIP)
        pv = torch.clamp(torch.clamp((pw - po) / po, min=0.0), max=VIOL_CLIP)
        return lat, pw, lv + pv

    u0, rand, act = (a.to(dev) for a in rollout_draws(
        keys.cpu(), n_dims, rollout_len, width, explore_eps))
    cfg = torch.floor(u0 * sizes).to(torch.int64)
    best_l, best_p, best_v = score(cfg)
    best = cfg
    for t in range(rollout_len):
        x = torch.cat([net_enc, obj_enc, onehot(cfg)], dim=-1)
        logits = L.mlp_apply(params, x)
        greedy = torch.argmax(logits, dim=-1)
        a = torch.where(rand[:, t], act[:, t], greedy) if t > 0 else greedy
        di = torch.searchsorted(ends, a, right=True)
        cfg = cfg.clone()
        cfg[lanes, di] = a - starts[di]
        lat, pw, v = score(cfg)
        improved = (v < best_v) | ((v == best_v) & torch.isfinite(lat)
                                   & (lat + pw < best_l + best_p))
        best = torch.where(improved[:, None], cfg, best)
        best_l = torch.where(improved, lat, best_l)
        best_p = torch.where(improved, pw, best_p)
        best_v = torch.where(improved, v, best_v)
    return best


@dataclasses.dataclass
class PolicyGradientDRL:
    model: DesignModel
    hidden_layers: int = 3
    neurons: int = 256
    lr: float = 1e-4
    rollout_len: int = 16
    batch_tasks: int = 64
    gamma: float = 0.95
    sat_bonus: float = 2.0
    explore_eps: float = 0.3
    seed: int = 0
    #: None: the card (raises without one); the CPU only when named
    device: Union[str, torch.device, None] = None

    method_name = "DRL"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ds: Optional[Dataset] = None
        self.params = None
        self._n_actions = self.model.space.onehot_width  # (dim, choice) flat

    # --- helpers -------------------------------------------------------------
    def _logits(self, params, net_enc, obj_enc, cfg_onehot) -> torch.Tensor:
        """The policy forward on this object's device (numpy or tensor
        inputs)."""
        x = torch.cat([torch.as_tensor(a, device=self.device)
                       for a in (net_enc, obj_enc, cfg_onehot)], dim=-1)
        return L.mlp_apply(params, x)

    def _apply_actions(self, cfg_idx: np.ndarray, actions: np.ndarray) -> np.ndarray:
        """actions: flat indices into onehot_width -> set (dim, choice)."""
        space = self.model.space
        out = cfg_idx.copy()
        off = 0
        for di, d in enumerate(space.dims):
            in_group = (actions >= off) & (actions < off + d.n)
            out[in_group, di] = actions[in_group] - off
            off += d.n
        return out

    def attach(self, ds: Dataset, params) -> "PolicyGradientDRL":
        """Serving entry (mirrors GANDSE.attach): a dataset (for its
        normalizers) and trained policy params, moved to this object's
        device."""
        self.ds = ds
        self.params = {"layers": [{k: v.to(self.device) for k, v in p.items()}
                                  for p in params["layers"]]}
        return self

    def init_params(self, seed: int = 0):
        """Fresh policy params on this object's device, the reference's
        for the same seed (net params + 2 objective channels + config
        one-hot in, one logit per action out)."""
        n_in = self.model.net_space.n_dims + 2 + self.model.space.onehot_width
        return L.mlp_init(prng.prng_key(torch.tensor(seed)), n_in,
                          [self.neurons] * self.hidden_layers,
                          self._n_actions, self.device)

    def train(self, n_data: int, iters: int, seed: int = 0,
              ds: Optional[Dataset] = None, log_every: int = 0):
        self.ds = ds if ds is not None else generate_dataset(
            self.model, n_data, seed=seed)
        space = self.model.space
        self.params = self.init_params(seed)
        optim = adam(self.lr)
        opt = optim.init(self.params)

        def pg_loss(params, states, actions, advantages):
            logp = torch.log_softmax(self._logits(params, *states), dim=-1)
            act_logp = torch.gather(logp, 1, actions[:, None])[:, 0]
            return -torch.mean(act_logp * advantages), None

        def update(params, opt, states, actions, advantages):
            (loss, _), grads = value_and_grad(pg_loss, params, states,
                                              actions, advantages)
            upd, opt = optim.update(grads, opt)
            return apply_updates(params, upd), opt, loss

        np_rng = np.random.default_rng(seed)
        baseline = 0.0
        for it in range(iters):
            # sample a batch of tasks from the dataset rows
            rows = np_rng.integers(0, self.ds.n, self.batch_tasks)
            b = encode_batch(self.model, self.ds, rows)
            net_idx = b["net_idx"]
            lo, po = b["lat_obj"], b["pow_obj"]
            cfg = space.sample_indices(np_rng, self.batch_tasks)
            lat, pw = self.model.evaluate_indices(net_idx, cfg)
            viol = _violation(lat, pw, lo, po)

            traj_states, traj_actions, traj_rewards = [], [], []
            for t in range(self.rollout_len):
                states = (b["net_enc"], b["obj_enc"],
                          space.onehot_from_indices(cfg))
                with torch.no_grad():
                    logits = self._logits(self.params, *states).cpu().numpy()
                # sample actions
                z = np_rng.gumbel(size=logits.shape)
                actions = np.argmax(logits + z, axis=-1).astype(np.int64)
                new_cfg = self._apply_actions(cfg, actions)
                lat, pw = self.model.evaluate_indices(net_idx, new_cfg)
                new_viol = _violation(lat, pw, lo, po)
                reward = (viol - new_viol) + self.sat_bonus * (new_viol == 0.0)
                traj_states.append(states)
                traj_actions.append(actions)
                traj_rewards.append(reward)
                cfg, viol = new_cfg, new_viol

            # discounted returns
            ret = np.zeros_like(traj_rewards[0])
            all_s, all_a, all_adv = [], [], []
            for t in reversed(range(self.rollout_len)):
                ret = traj_rewards[t] + self.gamma * ret
                all_s.append(traj_states[t])
                all_a.append(traj_actions[t])
                all_adv.append(ret.copy())
            adv = np.concatenate(all_adv)
            baseline = 0.9 * baseline + 0.1 * float(adv.mean())
            adv = (adv - baseline) / (adv.std() + 1e-6)
            states = tuple(torch.from_numpy(np.concatenate(
                [s[i] for s in all_s])).to(self.device) for i in range(3))
            actions = torch.from_numpy(np.concatenate(all_a)).to(self.device)
            self.params, opt, loss = update(
                self.params, opt, states, actions,
                torch.from_numpy(adv.astype(np.float32)).to(self.device))
            if log_every and it % log_every == 0:
                print(f"[drl] iter={it} loss={float(loss):.4f} "
                      f"final_viol={viol.mean():.4f} sat={(viol == 0).mean():.3f}")
        return self

    # --- device route -------------------------------------------------------
    @torch.no_grad()
    def _explore_device(self, tasks: DSETask, seed) -> List[DSEResult]:
        n_tasks = int(tasks.net_idx.shape[0])
        t0 = time.time()
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def rows(tasks_r, seeds_r):
            net_enc = self.ds.net_encoded(self.model, tasks_r.net_idx)
            obj_enc = self.ds.obj_encoded(tasks_r.lat_obj, tasks_r.pow_obj)
            best = rollout(
                self.model, self.params,
                torch.as_tensor(np.asarray(tasks_r.net_idx),
                                dtype=torch.int64, device=dev),
                f32(net_enc), f32(obj_enc), f32(tasks_r.lat_obj),
                f32(tasks_r.pow_obj), task_keys(seeds_r, len(seeds_r)),
                self.rollout_len, self.explore_eps)
            # every lane has a winner: one float64 host-oracle call
            # re-scores them all
            n = len(seeds_r)
            return selections_from_winners(
                self.model, tasks_r.net_idx, np.zeros(n, np.int64),
                best.to(torch.int32).cpu().numpy(),
                np.full(n, self.rollout_len + 1), tasks_r.lat_obj,
                tasks_r.pow_obj)

        # the rollout lanes shard over the active task mesh (pad, run a
        # block a rank, gather, discard the padded lanes)
        sels = shard.map_tasks(rows, tasks, row_seeds(seed, n_tasks))
        per_task = (time.time() - t0) / n_tasks
        return [DSEResult(sel, float(tasks.lat_obj[t]),
                          float(tasks.pow_obj[t]), per_task)
                for t, sel in enumerate(sels)]

    # --- host route ---------------------------------------------------------
    @torch.no_grad()
    def _explore_host(self, net_idx: np.ndarray, lat_obj: float,
                      pow_obj: float, seed: int) -> DSEResult:
        t0 = time.time()
        space = self.model.space
        rng = np.random.default_rng(seed)
        lo, po = float(lat_obj), float(pow_obj)
        net_enc = self.ds.net_encoded(self.model, np.atleast_2d(net_idx))
        obj_enc = self.ds.obj_encoded([lo], [po])
        cfg = space.sample_indices(rng, 1)
        lat, pw = self.model.evaluate_indices(net_idx[None], cfg)
        best = (cfg[0].copy(), float(lat[0]), float(pw[0]),
                float(_violation(lat, pw, lo, po)[0]))
        n_eval = 1
        for t in range(self.rollout_len):
            cfg_oh = space.onehot_from_indices(cfg)
            logits = self._logits(self.params, net_enc, obj_enc,
                                  cfg_oh).cpu().numpy()
            actions = np.argmax(logits, axis=-1)  # greedy at DSE time
            if t > 0 and rng.random() < self.explore_eps:  # light exploration
                actions = np.array([rng.integers(0, self._n_actions)])
            cfg = self._apply_actions(cfg, actions)
            lat, pw = self.model.evaluate_indices(net_idx[None], cfg)
            n_eval += 1
            v = float(_violation(lat, pw, lo, po)[0])
            l_, p_ = float(lat[0]), float(pw[0])
            if v < best[3] or (v == best[3] and np.isfinite(l_) and l_ + p_ < best[1] + best[2]):
                best = (cfg[0].copy(), l_, p_, v)
        c, bl, bp, bv = best
        sel = Selection(cfg_idx=c, latency=bl, power=bp,
                        satisfied=is_satisfied(bl, bp, lo, po),
                        n_candidates=n_eval)
        return DSEResult(sel, lo, po, time.time() - t0)

    # --- public API ---------------------------------------------------------
    def explore(self, net_idx: np.ndarray, lat_obj: float, pow_obj: float,
                seed: int = 0, use_torch: Optional[bool] = None) -> DSEResult:
        # a model without a torch oracle always takes the host route, even
        # when the device route is asked for (the GANDSE fallback rule)
        use_torch = self.model.has_torch_oracle and (use_torch is None
                                                     or use_torch)
        if use_torch:
            tasks = DSETask.single(net_idx, lat_obj, pow_obj)
            return self._explore_device(tasks, seed)[0]
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
