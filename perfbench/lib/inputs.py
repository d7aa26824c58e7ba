"""Every input of a run, made from ``--seed``: the training dataset and its
normalizers, DSE task batches with achievable objectives, and G's and D's
weights.  Both sides of the comparison get these same inputs; nothing here
comes from the program.

The dataset and the tasks follow GANDSE's generator (§5.1, §7.1.2): net
parameters and configurations drawn evenly from the spaces, the float64
oracle's metrics, log2 encodings normalized by their standard deviation.
A task is a net and a witness configuration's metrics relaxed by a slack
factor, so some configuration meets it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: salts that keep the streams drawn from one seed apart
DATASET, TASKS, WEIGHTS_G, WEIGHTS_D, ORDER, ROWS = range(6)


def rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), salt])


@dataclasses.dataclass
class Norm:
    mean: np.ndarray
    std: np.ndarray

    @staticmethod
    def fit(x: np.ndarray) -> "Norm":
        x = np.asarray(x, np.float64)
        std = x.std(axis=0)
        return Norm(x.mean(axis=0), np.where(std < 1e-12, 1.0, std))

    def __call__(self, x):
        return (x - self.mean) / self.std


def log2(v) -> np.ndarray:
    return np.log2(np.maximum(np.asarray(v, np.float64), 1e-9))


@dataclasses.dataclass
class DatasetRows:
    net_idx: np.ndarray
    cfg_idx: np.ndarray
    latency: np.ndarray
    power: np.ndarray
    lat_norm: Norm
    pow_norm: Norm
    net_norm: Norm

    def net_enc(self, oracle, net_idx) -> np.ndarray:
        return self.net_norm(log2(oracle.net.values(net_idx))).astype(np.float32)

    def obj_enc(self, lat, pw) -> np.ndarray:
        lo = self.lat_norm(log2(np.asarray(lat)[..., None]))
        po = self.pow_norm(log2(np.asarray(pw)[..., None]))
        return np.concatenate([lo, po], -1).astype(np.float32)

    def encoded(self, oracle, rows) -> Dict[str, np.ndarray]:
        """Algorithm 1's batch of `rows`: a row's own metrics double as the
        objectives it meets."""
        return dict(net_idx=self.net_idx[rows].astype(np.int64),
                    net_enc=self.net_enc(oracle, self.net_idx[rows]),
                    cfg_onehot=oracle.cfg.onehot(self.cfg_idx[rows]),
                    obj_enc=self.obj_enc(self.latency[rows], self.power[rows]),
                    lat_obj=self.latency[rows].astype(np.float32),
                    pow_obj=self.power[rows].astype(np.float32))


def dataset(oracle, n: int, seed: int) -> DatasetRows:
    """n feasible rows drawn evenly from the spaces."""
    r = rng(seed, DATASET)
    parts: List[Tuple[np.ndarray, ...]] = []
    got = 0
    while got < n:
        m = max(3 * n, 1024)
        net, cfg = oracle.net.sample(r, m), oracle.cfg.sample(r, m)
        lat, pw = oracle.host(net, cfg)
        ok = np.isfinite(lat) & np.isfinite(pw)
        parts.append((net[ok], cfg[ok], lat[ok], pw[ok]))
        got += int(ok.sum())
    net, cfg, lat, pw = (np.concatenate(p)[:n] for p in zip(*parts))
    return DatasetRows(net, cfg, lat, pw, Norm.fit(log2(lat[:, None])),
                       Norm.fit(log2(pw[:, None])),
                       Norm.fit(log2(oracle.net.values(net))))


@dataclasses.dataclass
class Tasks:
    net_idx: np.ndarray
    lat_obj: np.ndarray
    pow_obj: np.ndarray


def tasks(oracle, n: int, seed: int, batch: int, slack: Sequence[float]
          ) -> List[Tasks]:
    """n // batch task batches whose objectives some configuration meets."""
    r = rng(seed, TASKS)
    nets, los, pos = [], [], []
    got = 0
    while got < n:
        m = max(2 * n, 512)
        net, cfg = oracle.net.sample(r, m), oracle.cfg.sample(r, m)
        lat, pw = oracle.host(net, cfg)
        ok = np.isfinite(lat) & np.isfinite(pw)
        s_l = r.uniform(slack[0], slack[1], size=m)
        s_p = r.uniform(slack[0], slack[1], size=m)
        nets.append(net[ok])
        los.append((lat * s_l)[ok])
        pos.append((pw * s_p)[ok])
        got += int(ok.sum())
    net, lo, po = (np.concatenate(p)[:n] for p in (nets, los, pos))
    return [Tasks(net[i:i + batch], lo[i:i + batch], po[i:i + batch])
            for i in range(0, n, batch)]


def mlp_dims(in_dim: int, layers: int, neurons: int, out_dim: int) -> List[int]:
    return [in_dim] + [neurons] * layers + [out_dim]


def weights(dims: Sequence[int], seed: int, salt: int, device,
            dtype=torch.float32) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """An MLP's weights from the seed in one draw on `device`: normal times
    the He scale (ReLU layers) or 1/sqrt(fan-in) (the linear head), zero
    biases."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + salt) & (2**63 - 1))
    sizes = [i * o for i, o in zip(dims[:-1], dims[1:])]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, off = [], 0
    for li, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        s = (1.0 / i) ** 0.5 if li == len(sizes) - 1 else (2.0 / i) ** 0.5
        w = (flat[off:off + i * o].view(i, o) * s).to(dtype)
        out.append((w, torch.zeros(o, dtype=dtype, device=device)))
        off += i * o
    return out


def row_seeds(seed: int, call: int, n: int) -> np.ndarray:
    """Call `call`'s per-task noise seeds: every call draws other noise."""
    base = int(rng(seed, ROWS).integers(0, 2**31))
    return base + call * n + np.arange(n, dtype=np.int64)
