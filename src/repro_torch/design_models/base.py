"""Design-model interface (paper §2.1, §5.1).

A design model maps (network parameters, configurations) -> objective
metrics (latency, power).  Implementations are vectorized over arbitrary
leading dims: ``evaluate`` in numpy float64 (the host oracle every
reported metric comes from) and ``evaluate_torch`` in torch float32 (the
device oracle that scores candidate tiles).  Both run one formula written
against an array namespace ``xp``: ``np``, or `TORCH_XP` below.
"""
from __future__ import annotations

import abc
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.encoding import ConfigDim, ConfigSpace


class _TorchXP:
    """The handful of numpy-namespace calls the oracle formulas use, on
    torch tensors.  torch's binary ops take no Python scalar where numpy's
    do (``maximum(x, 1.0)``), so the scalar forms go through ``clamp``,
    which returns the same value bit for bit.  ``log2`` is written as
    ``log(x) / log(2)``, the way the reference's f32 oracle computes it."""

    inf = float("inf")
    ceil = staticmethod(torch.ceil)
    floor = staticmethod(torch.floor)
    sqrt = staticmethod(torch.sqrt)
    isfinite = staticmethod(torch.isfinite)
    where = staticmethod(torch.where)
    power = staticmethod(torch.pow)

    @staticmethod
    def minimum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, max=b)
        if not torch.is_tensor(a):
            return torch.clamp(b, max=a)
        return torch.minimum(a, b)

    @staticmethod
    def maximum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, min=b)
        if not torch.is_tensor(a):
            return torch.clamp(b, min=a)
        return torch.maximum(a, b)

    @staticmethod
    def log2(x):
        ln2 = torch.log(torch.full((), 2.0, dtype=x.dtype, device=x.device))
        return torch.log(x) / ln2


TORCH_XP = _TorchXP()


class DesignModel(abc.ABC):
    """Analytic model of the metrics in the objectives."""

    name: str = "base"

    #: the configuration design space (one-hot groups)
    space: ConfigSpace
    #: the network-parameter space (dims sampled for the dataset)
    net_space: ConfigSpace

    @abc.abstractmethod
    def evaluate(self, net: np.ndarray, config: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(..., n_net_dims) values, (..., n_cfg_dims) values -> (latency, power).

        Latency in seconds, power in watts, float64; both shaped like the
        broadcast leading dims.  Infeasible configs return latency = +inf.
        """

    def evaluate_torch(self, net: torch.Tensor, config: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Torch float32 twin of `evaluate`, on the tensors' device: same
        contract (broadcast leading dims, infeasible -> +inf).  Models
        without one leave this unimplemented and check `has_torch_oracle`."""
        raise NotImplementedError(f"{self.name} has no torch oracle")

    @property
    def has_torch_oracle(self) -> bool:
        """True when this model overrides `evaluate_torch`."""
        return type(self).evaluate_torch is not DesignModel.evaluate_torch

    # convenience -----------------------------------------------------------
    def evaluate_indices(self, net_idx, cfg_idx):
        """Index-space entry point; leading dims broadcast like `evaluate`."""
        net = self.net_space.values_from_indices(net_idx)
        cfg = self.space.values_from_indices(cfg_idx)
        return self.evaluate(net, cfg)

    def evaluate_torch_indices(self, net_idx: torch.Tensor,
                               cfg_idx: torch.Tensor):
        """Index-space entry point of the torch oracle (choice tables are
        device constants); leading dims broadcast like `evaluate_torch`."""
        net = self.net_space.values_from_indices_torch(net_idx)
        cfg = self.space.values_from_indices_torch(cfg_idx)
        return self.evaluate_torch(net, cfg)


def pow2_choices(lo: int, hi: int) -> Tuple[float, ...]:
    out = []
    v = lo
    while v <= hi:
        out.append(float(v))
        v *= 2
    return tuple(out)


def make_dim(name: str, choices) -> ConfigDim:
    return ConfigDim(name=name, choices=tuple(float(c) for c in choices))
