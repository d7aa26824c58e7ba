"""The conditional GAN of GANDSE (paper §4, §6.1, Table 4) — inference half.

Generator  G(net_params, objectives, noise) -> per-config-group one-hot
           probability distributions (softmax per group).

G is a multilayer perceptron with ReLU activations (Table 4).  Params are
plain dicts of tensors in the reference layout; the forward runs through
the whole-MLP kernel on the card.  The discriminator and the training
losses belong to training, which is not ported yet.
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
    """Generator hyperparameters (paper Table 4).  The discriminator's and
    the training settings come with training, which is not ported yet."""

    n_net: int                    # encoded network-parameter width
    n_obj: int = 2                # latency + power objectives
    noise_dim: int = 8            # "small random numbers as noise"
    g_hidden_layers: int = 11
    g_neurons: int = 2048
    #: None/True: the whole-MLP kernel on CUDA tensors (plain version on
    #: CPU tensors); False: the plain version everywhere (an explicit
    #: opt-out — see kernels/fused_mlp.py)
    use_fused: Optional[bool] = None

    def scaled(self, layers: int, neurons: int) -> "GANConfig":
        """Reduced-scale variant (CPU tests); same algorithm."""
        return dataclasses.replace(self, g_hidden_layers=layers,
                                   g_neurons=neurons)


def init_generator(gen: torch.Generator, cfg: GANConfig, space: ConfigSpace,
                   device):
    in_dim = cfg.n_net + cfg.n_obj + cfg.noise_dim
    hidden = [cfg.g_neurons] * cfg.g_hidden_layers
    return L.mlp_init(gen, in_dim, hidden, space.onehot_width, device)


def generator_apply(params, space: ConfigSpace, net_enc: torch.Tensor,
                    obj_enc: torch.Tensor, noise: torch.Tensor,
                    use_fused: Optional[bool] = None) -> torch.Tensor:
    """Returns (B, onehot_width) per-group softmax probabilities; the MLP
    runs over the flattened row batch (the reference's chained route)."""
    x = torch.cat([net_enc, obj_enc, noise], dim=-1)
    logits = L.mlp_apply_chained(params, x, use_fused=use_fused)
    t = device_tables(space, logits.device)
    padded = torch.where(t.mask, logits[..., t.gidx], float("-inf"))
    probs = torch.softmax(padded, dim=-1)        # pad -inf -> exactly 0
    return probs.reshape(*probs.shape[:-2], -1)[..., t.flat2pad]


def sample_noise(keys: torch.Tensor, cfg: GANConfig) -> torch.Tensor:
    """The canonical noise input ("small random numbers"): one
    ``uniform(key, (1, noise_dim), -0.1, 0.1)`` row per key, bit-identical
    to the reference's draw.  keys (..., 2) -> (..., noise_dim)."""
    return prng.uniform(keys, cfg.noise_dim, -0.1, 0.1)


def decode_hard(space: ConfigSpace, probs: torch.Tensor) -> torch.Tensor:
    """Per-group argmax -> (B, n_dims) int64 choice indices."""
    padded, _ = space.split_groups_padded(probs, fill=float("-inf"))
    return torch.argmax(padded, dim=-1)


def indices_to_values(space: ConfigSpace, idx: torch.Tensor) -> torch.Tensor:
    """Torch version of ConfigSpace.values_from_indices (float32)."""
    return space.values_from_indices_torch(idx)
