"""Algorithm 1 — the proposed GAN training scheme.

For each sample s of a batch:
    Config_g <- G(Net_s, LO_s, PO_s)                 (line 5)
    Sat      <- D(Net_s, Config_g, LO_s, PO_s)       (line 6)
    L_g, P_g <- design model(Net_s, Config_g)        (lines 7-8)
    Loss_critic += E(Sat, True)/bs                   (line 9)
    if L_g <= LO_s and P_g <= PO_s:                  (line 10)
        Loss_config += 0;      Loss_dis += E(Sat, True)/bs
    else:
        Loss_config += E(Config_s, Config_g)/bs;  Loss_dis += E(Sat, False)/bs
    update G with Loss_config + w_critic * Loss_critic
    update D with Loss_dis

The design model is an external, non-differentiable oracle, as in the paper
(Fig. 3(c)): its output enters the losses only as constants (labels and
masks), never in the gradient path.  G's gradients flow through D (frozen)
for the critic term and through the per-group CE for the config term.

Two oracle routes: the design model's torch float32 twin
(``DesignModel.evaluate_torch``) on the params' device, the default for
the built-in models; and the host numpy ``evaluate`` for models without
one (it reads the device once per step).

``train_gan`` encodes the dataset once and uploads it once; each epoch
draws one permutation on the host, gathers its batches on the device, and
reads the step metrics back once, at the epoch's end.  Every G and D layer
of the step runs through the dense kernels and their backward on the card
(``nn/layers.mlp_apply`` -> ``kernels/dispatch.dense``);
``GANConfig.use_fused=False`` opts out to the plain versions.

Under a task mesh (``train_gan(mesh=...)``, or the active
``shard.set_task_mesh``) each step is data parallel over the mesh's batch
axes: every rank draws the global batch's noise from the one key and keeps
its rows, runs G, the decode, the oracle and D on its block of the batch,
takes the losses as global means (its local sum over the global count),
and all-reduces the gradients before both Adam updates, so the replicated
params stay the same on every rank.  A batch that the shard count does not
divide falls back to the unsharded step on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core import shard
from repro_torch.core.explorer import resolve_device
from repro_torch.dataset.generator import Dataset
from repro_torch.design_models.base import DesignModel
from repro_torch.optim import (AdamState, adam, apply_updates, tree_leaves,
                               tree_map)

#: what a NaN or +inf metric becomes: infeasible, on both oracle routes
BIG = 3.4e38


@dataclasses.dataclass
class TrainState:
    g_params: dict
    d_params: dict
    g_opt: AdamState
    d_opt: AdamState
    rng: torch.Tensor            # (2,) threefry key, on the params' device
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def make_oracle(model: DesignModel, use_torch_oracle: Optional[bool] = None):
    """The in-step oracle: (cfg_idx, net_idx) -> (lat, pw) float32 on
    cfg_idx's device.

    use_torch_oracle: True forces the torch route (raises if the model has
    none), False the host numpy route, None the torch route whenever the
    model has one.  Returns (fn, on_device).  NaN and +inf metrics become
    `BIG` (infeasible) on both routes, so comparisons against the
    objectives stay well-defined and identical."""
    if use_torch_oracle is None:
        use_torch_oracle = model.has_torch_oracle
    if use_torch_oracle:
        if not model.has_torch_oracle:
            raise ValueError(f"model {model.name!r} has no torch oracle")

        def on_device(cfg_idx, net_idx):
            lat, pw = model.evaluate_torch_indices(net_idx, cfg_idx)
            return (torch.nan_to_num(lat.float(), nan=BIG, posinf=BIG),
                    torch.nan_to_num(pw.float(), nan=BIG, posinf=BIG))

        return on_device, True

    def on_host(cfg_idx, net_idx):
        lat, pw = model.evaluate_indices(net_idx.cpu().numpy(),
                                         cfg_idx.cpu().numpy())
        big = np.float32(BIG)
        lat = np.nan_to_num(lat.astype(np.float32), nan=big, posinf=big)
        pw = np.nan_to_num(pw.astype(np.float32), nan=big, posinf=big)
        return (torch.from_numpy(lat).to(cfg_idx.device),
                torch.from_numpy(pw).to(cfg_idx.device))

    return on_host, False


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, aux), grads of `loss_fn(params, *args)` w.r.t. params, as a
    tree like params; the caller's params are left as they are."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, aux = loss_fn(p, *args)
    grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return (loss.detach(), aux), tree_map(lambda _: next(grads), p)


def _batch_constrainer(mesh):
    """This rank's rows of each batch leaf's leading (sample) axis — the
    data-parallel layout of Algorithm 1 (the reference pins the same
    blocks with a sharding constraint).  The identity when the mesh has no
    task axes (or is None)."""
    if shard.n_task_shards(mesh) <= 1:
        return lambda batch: batch
    return lambda batch: {k: shard.put_sharded(v, mesh)
                          for k, v in batch.items()}


class _DataParallel:
    """The collectives of one data-parallel step over `mesh`'s task axes
    (k ranks): the global count, this rank's noise rows, and the
    all-reduces.  With no mesh (k = 1) every method is the one-rank
    computation, bit for bit."""

    def __init__(self, mesh):
        self.k = shard.n_task_shards(mesh)
        self.mesh = mesh
        if self.k > 1:
            self.r = shard.shard_index(mesh)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global batch mean."""
        if self.k == 1:
            return torch.mean(x)
        return x.sum() / (x.shape[0] * self.k)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor."""
        if self.k == 1:
            return x
        n = x.shape[0] // self.k
        return x[self.r * n:(self.r + 1) * n]

    def all_reduce(self, tree):
        """Sum every leaf of `tree` over the ranks (one collective)."""
        return tree if self.k == 1 else shard.all_reduce(tree, self.mesh)


def _make_step_body(model: DesignModel, cfg: G.GANConfig,
                    use_torch_oracle: Optional[bool] = None, mesh=None):
    """One Algorithm 1 update as a function of (carry, batch).

    Returns (g_optim, d_optim, step_body) where step_body(carry, batch) ->
    (carry, metrics), carry = (g_params, d_params, g_opt, d_opt, rng) and
    metrics are 0-d tensors on the device (nothing is read back here).

    With a `mesh`, `batch` holds this rank's rows of the global batch and
    the step is data parallel (module docstring); the metrics are this
    rank's shares of the global means (their sum over the ranks is the
    global value)."""
    space = model.space
    oracle, _ = make_oracle(model, use_torch_oracle)
    dp = _DataParallel(mesh)

    def losses_g(g_params, d_frozen, batch, noise):
        probs = G.generator_apply(g_params, space, batch["net_enc"],
                                  batch["obj_enc"], noise,
                                  use_fused=cfg.use_fused)
        # external design model on the hard-decoded config (lines 7-8)
        with torch.no_grad():
            cfg_idx = G.decode_hard(space, probs)
            lat_g, pow_g = oracle(cfg_idx, batch["net_idx"])
            sat_actual = ((lat_g <= batch["lat_obj"])
                          & (pow_g <= batch["pow_obj"])).float()
        # D is frozen here (its params are detached, so autograd neither
        # keeps D grads nor launches D's dW kernel); the gradient flows
        # *through* D into G's probs — that is the critic signal
        sat_logits = G.discriminator_apply(d_frozen, batch["net_enc"], probs,
                                           batch["obj_enc"],
                                           use_fused=cfg.use_fused)
        loss_critic = dp.mean(G.satisfaction_ce(
            sat_logits, torch.ones_like(sat_actual)))
        ce_cfg = G.grouped_cross_entropy(space, batch["cfg_onehot"], probs)
        loss_config = dp.mean((1.0 - sat_actual) * ce_cfg)  # lines 11/14
        loss_g = loss_config + cfg.w_critic * loss_critic
        aux = dict(loss_config=loss_config.detach(),
                   loss_critic=loss_critic.detach(), probs=probs.detach(),
                   sat_actual=sat_actual, sat_rate=dp.mean(sat_actual))
        return loss_g, aux

    def losses_d(d_params, batch, probs, sat_actual):
        sat_logits = G.discriminator_apply(d_params, batch["net_enc"], probs,
                                           batch["obj_enc"],
                                           use_fused=cfg.use_fused)
        loss_dis = dp.mean(G.satisfaction_ce(sat_logits, sat_actual))
        d_acc = dp.mean((torch.argmax(sat_logits, -1).float()
                         == sat_actual).float())
        return loss_dis, dict(d_acc=d_acc)

    g_optim = adam(cfg.g_lr)
    d_optim = adam(cfg.d_lr)

    def step_body(carry, batch):
        g_params, d_params, g_opt, d_opt, rng = carry
        rng, nrng = prng.split(rng)
        # the global batch's noise from the one key; this rank's rows
        noise = dp.rows(G.sample_train_noise(
            nrng, batch["net_enc"].shape[0] * dp.k, cfg))
        d_frozen = tree_map(torch.Tensor.detach, d_params)
        (loss_g, aux), g_grads = value_and_grad(losses_g, g_params, d_frozen,
                                                 batch, noise)
        g_upd, g_opt = g_optim.update(dp.all_reduce(g_grads), g_opt)
        g_params = apply_updates(g_params, g_upd)

        # the D loss sees the probs from before G's update (lines 12/15)
        (loss_d, daux), d_grads = value_and_grad(
            losses_d, d_params, batch, aux["probs"], aux["sat_actual"])
        d_upd, d_opt = d_optim.update(dp.all_reduce(d_grads), d_opt)
        d_params = apply_updates(d_params, d_upd)

        metrics = dict(
            loss_g=loss_g, loss_d=loss_d,
            loss_config=aux["loss_config"], loss_critic=aux["loss_critic"],
            sat_rate=aux["sat_rate"], d_acc=daux["d_acc"],
        )
        return (g_params, d_params, g_opt, d_opt, rng), metrics

    return g_optim, d_optim, step_body


def make_train_step(model: DesignModel, cfg: G.GANConfig,
                    use_torch_oracle: Optional[bool] = None, mesh=None):
    """The per-batch update of Algorithm 1 as one call:
    step(g_params, d_params, g_opt, d_opt, batch, rng) -> (g_params,
    d_params, g_opt, d_opt, rng, metrics).  ``train_gan`` loops the same
    body.  With a `mesh` the step takes the global batch, runs data
    parallel on this rank's rows (``_batch_constrainer``) and returns the
    global metrics."""
    g_optim, d_optim, step_body = _make_step_body(model, cfg,
                                                  use_torch_oracle, mesh)
    constrain = _batch_constrainer(mesh)
    dp = _DataParallel(mesh)

    def step(g_params, d_params, g_opt, d_opt, batch, rng):
        carry, metrics = step_body((g_params, d_params, g_opt, d_opt, rng),
                                   constrain(batch))
        return (*carry, dp.all_reduce(metrics))

    return g_optim, d_optim, step


def make_epoch_fn(model: DesignModel, cfg: G.GANConfig,
                  use_torch_oracle: Optional[bool] = None, mesh=None):
    """One epoch as a function: epoch(carry, data, perm) -> (carry,
    metrics), carry = (g_params, d_params, g_opt, d_opt, rng), data the
    encoded dataset on the device (N, ...), perm (n_batches, rows) int64
    row indices on the device — with a `mesh`, this rank's columns of the
    epoch's (n_batches, batch_size) permutation.  Each batch is gathered
    on the device and stepped; metrics are (n_batches,) tensors of the
    global values (one all-reduce an epoch under a mesh)."""
    g_optim, d_optim, step_body = _make_step_body(model, cfg,
                                                  use_torch_oracle, mesh)
    dp = _DataParallel(mesh)

    def epoch(carry, data, perm):
        steps = []
        for b in range(perm.shape[0]):
            carry, metrics = step_body(carry,
                                       {k: v[perm[b]] for k, v in data.items()})
            steps.append(metrics)
        out = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        return carry, dp.all_reduce(out)

    return g_optim, d_optim, epoch


def encode_batch(model: DesignModel, ds: Dataset,
                 idx: np.ndarray) -> Dict[str, np.ndarray]:
    net_idx = ds.net_idx[idx]
    return {
        "net_idx": net_idx.astype(np.int32),
        "net_enc": ds.net_encoded(model, net_idx),
        "cfg_onehot": model.space.onehot_from_indices(ds.cfg_idx[idx]),
        # sample objectives: the sample's own (L, P) are the objectives it
        # satisfies exactly (dataset rows double as (objective, witness)).
        "obj_enc": ds.obj_encoded(ds.latency[idx], ds.power[idx]),
        "lat_obj": ds.latency[idx].astype(np.float32),
        "pow_obj": ds.power[idx].astype(np.float32),
    }


def encode_dataset(model: DesignModel, ds: Dataset,
                   device) -> Dict[str, torch.Tensor]:
    """Encode every row once and upload it once (indices as int64, the
    type torch gathers with)."""
    full = encode_batch(model, ds, np.arange(ds.n))
    full["net_idx"] = full["net_idx"].astype(np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in full.items()}


def init_state(model: DesignModel, cfg: G.GANConfig, seed: int,
               device) -> TrainState:
    """A fresh train state on `device`, the reference's own: ``rng, g_key,
    d_key = split(PRNGKey(seed), 3)``, G's and D's weights drawn from
    g_key and d_key (bit for bit the reference's), zero Adam moments, and
    rng as the carry."""
    device = resolve_device(device)
    key = prng.prng_key(torch.tensor(seed, dtype=torch.int64))
    rng, g_key, d_key = prng.split(key, 3).to(device)
    g_params = G.init_generator(g_key, cfg, model.space, device)
    d_params = G.init_discriminator(d_key, cfg, model.space, device)
    return TrainState(g_params, d_params, adam(cfg.g_lr).init(g_params),
                      adam(cfg.d_lr).init(d_params), rng)


def _to_device(state: TrainState, device: torch.device) -> Tuple:
    move = lambda t: t.to(device)
    opt = lambda o: AdamState(move(o.step), tree_map(move, o.mu),
                              tree_map(move, o.nu))
    return (tree_map(move, state.g_params), tree_map(move, state.d_params),
            opt(state.g_opt), opt(state.d_opt), move(state.rng))


def train_gan(
    model: DesignModel,
    ds: Dataset,
    cfg: G.GANConfig,
    iters: int = 5,
    seed: int = 0,
    log_every: int = 0,
    use_torch_oracle: Optional[bool] = None,
    mesh=None,
    state: Optional[TrainState] = None,
    device=None,
) -> TrainState:
    """Mini-batch alternating training (Algorithm 1, lines 1-21), on
    `device` (None: the card, which must be present).

    ``state`` warm-starts from an earlier `TrainState` (params, optimizer
    moments and rng all resume; ``seed`` then drives only the epoch
    permutations, which come from ``np.random.default_rng(seed)`` as in the
    reference).  The history holds one record per step; its metrics are
    read from the device once per epoch.

    ``mesh=None`` picks up the active task mesh (``shard.set_task_mesh``);
    with one, each epoch runs data parallel over the mesh's batch axes
    (module docstring): every rank draws the same permutation and gathers
    its columns.  It falls back to the unsharded path, the same bits as no
    mesh, when the shard count does not divide ``min(batch_size, n)``.  A
    warm-start `state` is broadcast from the mesh's first rank; a fresh
    one is drawn from `seed` on every rank alike."""
    device = resolve_device(device)
    mesh = shard.get_task_mesh() if mesh is None else mesh
    k = shard.n_task_shards(mesh)
    if k <= 1 or min(cfg.batch_size, ds.n) % k != 0:
        mesh = None
    _, _, epoch = make_epoch_fn(model, cfg, use_torch_oracle, mesh)
    if state is None:
        carry = _to_device(init_state(model, cfg, seed, device), device)
    else:
        carry = shard.replicate(_to_device(state, device), mesh)

    np_rng = np.random.default_rng(seed)
    n = ds.n
    bs = min(cfg.batch_size, n)
    n_batches = n // bs
    data = encode_dataset(model, ds, device)
    history: List[Dict[str, float]] = []
    t0 = time.time()
    for it in range(iters):
        perm = np_rng.permutation(n)[: n_batches * bs].reshape(n_batches, bs)
        perm = torch.from_numpy(shard.put_sharded(perm, mesh, axis=1)
                                if mesh is not None else perm).to(device)
        carry, metrics = epoch(carry, data, perm)
        names = list(metrics)
        # the epoch's one read of the device
        values = torch.stack([metrics[k] for k in names], 1).cpu().numpy()
        for row in values:
            rec = {k: float(v) for k, v in zip(names, row)}
            rec["iter"] = it
            history.append(rec)
        if log_every and (it % log_every == 0):
            m = history[-1]
            print(f"[train_gan] iter={it} loss_g={m['loss_g']:.4f} "
                  f"loss_d={m['loss_d']:.4f} critic={m['loss_critic']:.4f} "
                  f"sat={m['sat_rate']:.3f} t={time.time()-t0:.1f}s")

    g_params, d_params, g_opt, d_opt, rng = carry
    return TrainState(g_params, d_params, g_opt, d_opt, rng, history)
