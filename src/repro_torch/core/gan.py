"""The conditional GAN of GANDSE (paper §4, §6.1, Table 4).

Generator  G(net_params, objectives, noise) -> per-config-group one-hot
           probability distributions (softmax per group).
Discriminator D(net_params, config_onehot, objectives) -> satisfaction
           logits (2-class one-hot, like other classification tasks).

Both are multilayer perceptrons with ReLU activations and Adam optimizers
(Table 4).  Params are plain dicts of tensors in the reference layout.  On
the card, G's inference runs through the whole-MLP kernel (``chained``)
and every training forward and backward through the dense kernels.

Initial weights come from a threefry key through ``core/prng.normal``:
the same key gives the reference's ``jax.random.normal`` weights, bit for
bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import prng
from repro_torch.core.encoding import ConfigSpace, device_tables
from repro_torch.nn import layers as L


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Hyperparameters (paper Table 4)."""

    n_net: int                    # encoded network-parameter width
    n_obj: int = 2                # latency + power objectives
    noise_dim: int = 8            # "small random numbers as noise"
    g_hidden_layers: int = 11
    g_neurons: int = 2048
    d_hidden_layers: int = 11
    d_neurons: int = 2048
    g_lr: float = 2e-5
    d_lr: float = 2e-5
    w_critic: float = 0.5
    batch_size: int = 1024
    #: None/True: the kernels on CUDA tensors (plain versions on CPU
    #: tensors); False: the plain versions everywhere (an explicit opt-out
    #: — see kernels/dispatch.py)
    use_fused: Optional[bool] = None

    def scaled(self, layers: int, neurons: int, lr: Optional[float] = None,
               batch_size: Optional[int] = None) -> "GANConfig":
        """Reduced-scale variant (CPU tests); same algorithm."""
        return dataclasses.replace(
            self,
            g_hidden_layers=layers, d_hidden_layers=layers,
            g_neurons=neurons, d_neurons=neurons,
            g_lr=lr or self.g_lr, d_lr=lr or self.d_lr,
            batch_size=batch_size or self.batch_size)


def init_generator(key: torch.Tensor, cfg: GANConfig, space: ConfigSpace,
                   device):
    """G's weights from a threefry key ((2,) int64), as the reference's
    ``init_generator`` draws them from the same key."""
    in_dim = cfg.n_net + cfg.n_obj + cfg.noise_dim
    hidden = [cfg.g_neurons] * cfg.g_hidden_layers
    return L.mlp_init(key, in_dim, hidden, space.onehot_width, device)


def init_discriminator(key: torch.Tensor, cfg: GANConfig,
                       space: ConfigSpace, device):
    """D's weights from a threefry key, as `init_generator`."""
    in_dim = cfg.n_net + space.onehot_width + cfg.n_obj
    hidden = [cfg.d_neurons] * cfg.d_hidden_layers
    return L.mlp_init(key, in_dim, hidden, 2, device)


def generator_apply(params, space: ConfigSpace, net_enc: torch.Tensor,
                    obj_enc: torch.Tensor, noise: torch.Tensor,
                    use_fused: Optional[bool] = None,
                    chained: bool = False) -> torch.Tensor:
    """Returns (B, onehot_width) per-group softmax probabilities.

    ``chained=True`` runs the MLP through the whole-MLP kernel, the
    inference path; training leaves it False so every layer runs through
    the dense kernels, whose backward it needs."""
    x = torch.cat([net_enc, obj_enc, noise], dim=-1)
    if chained:
        logits = L.mlp_apply_chained(params, x, use_fused=use_fused)
    else:
        logits = L.mlp_apply(params, x, use_fused=use_fused)
    return group_softmax(space, logits)


def group_softmax(space: ConfigSpace, logits: torch.Tensor) -> torch.Tensor:
    """(..., onehot_width) logits -> the softmax of each config group, in
    the flat one-hot layout (one padded softmax over every group)."""
    t = device_tables(space, logits.device)
    padded = torch.where(t.mask, logits[..., t.gidx], float("-inf"))
    probs = torch.softmax(padded, dim=-1)        # pad -inf -> exactly 0
    return probs.reshape(*probs.shape[:-2], -1)[..., t.flat2pad]


def discriminator_apply(params, net_enc: torch.Tensor,
                        cfg_onehot: torch.Tensor, obj_enc: torch.Tensor,
                        use_fused: Optional[bool] = None) -> torch.Tensor:
    """Returns (B, 2) satisfaction logits ([False, True] classes)."""
    x = torch.cat([net_enc, cfg_onehot, obj_enc], dim=-1)
    return L.mlp_apply(params, x, use_fused=use_fused)


def replicate_params(params, mesh=None):
    """Make a params tree the same on every rank of the task mesh (a
    broadcast from its first rank, in place): the data-parallel layout
    whose gradients are all-reduced.  The identity when no mesh is active,
    so one-rank callers are untouched."""
    from repro_torch.core import shard
    return shard.replicate(params, mesh)


def sample_noise_dim(key: torch.Tensor, batch: int,
                     noise_dim: int) -> torch.Tensor:
    """The canonical noise input ("small random numbers"), shared by G and
    the LargeMLP baseline, which §7.1.4 feeds the same noise:
    ``uniform(key, (batch, noise_dim), -0.1, 0.1)``, bit-identical to the
    reference's ``sample_noise_dim``.  Element i of the flattened draw
    hashes counter i, so row r of one key's batch is not the draw of any
    other key.  key (..., 2) -> (..., batch, noise_dim)."""
    flat = prng.uniform(key, batch * noise_dim, -0.1, 0.1)
    return flat.reshape(*flat.shape[:-1], batch, noise_dim)


def sample_noise(keys: torch.Tensor, cfg: GANConfig) -> torch.Tensor:
    """G's noise for inference: one ``sample_noise_dim(key, 1, noise_dim)``
    row per key.  keys (..., 2) -> (..., noise_dim)."""
    return sample_noise_dim(keys, 1, cfg.noise_dim)[..., 0, :]


def sample_train_noise(key: torch.Tensor, batch: int,
                       cfg: GANConfig) -> torch.Tensor:
    """Algorithm 1's noise: ``sample_noise_dim(key, batch, noise_dim)``
    from ONE key, the reference's ``sample_noise(rng, batch, cfg)``.
    key (2,) -> (batch, noise_dim)."""
    return sample_noise_dim(key, batch, cfg.noise_dim)


# ---------------------------------------------------------------------------
# losses (all cross-entropy, §6.1)
# ---------------------------------------------------------------------------
def grouped_cross_entropy(space: ConfigSpace, target_onehot: torch.Tensor,
                          probs: torch.Tensor) -> torch.Tensor:
    """E(Config_s, Config_g): summed per-group CE between the dataset
    config (one-hot) and G's per-group distributions, as one sum over the
    whole one-hot width (the target is one-hot within each group).  (B,)"""
    return -torch.sum(target_onehot * torch.log(probs + 1e-9), dim=-1)


# a training loss over dataset labels, not a feasibility judge: the oracle
# guarantees finite metrics before they reach here.
# lint: disable=nan-transparent-violation
def satisfaction_ce(logits: torch.Tensor,
                    sat_true: torch.Tensor) -> torch.Tensor:
    """E(Sat, label): 2-class CE; sat_true is float (B,) in {0, 1}.  (B,)"""
    labels = torch.stack([1.0 - sat_true, sat_true], dim=-1)  # [False, True]
    return -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)


def decode_hard(space: ConfigSpace, probs: torch.Tensor) -> torch.Tensor:
    """Per-group argmax -> (B, n_dims) int64 choice indices; a tie goes to
    the first index, as ``jnp.argmax``'s does."""
    padded, _ = space.split_groups_padded(probs, fill=float("-inf"))
    return torch.argmax(padded, dim=-1)


def indices_to_values(space: ConfigSpace, idx: torch.Tensor) -> torch.Tensor:
    """Torch version of ConfigSpace.values_from_indices (float32)."""
    return space.values_from_indices_torch(idx)
