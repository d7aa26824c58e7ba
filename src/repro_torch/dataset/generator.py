"""Dataset Generator (paper §5.1, §7.1.2).

Evenly samples network parameters, architecture parameters, and mapping
strategies across the design space, evaluates the design model for the
objectives, and assembles the training dataset.  Latency and power are
normalized by the standard deviation (Tables 2-3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.encoding import Normalizer, binary_log2_encode
from repro_torch.design_models.base import DesignModel


@dataclasses.dataclass
class Dataset:
    """Training dataset: one row = (net params, config, latency, power)."""

    model_name: str
    net_idx: np.ndarray        # (N, n_net_dims) int
    cfg_idx: np.ndarray        # (N, n_cfg_dims) int
    latency: np.ndarray        # (N,) seconds (raw)
    power: np.ndarray          # (N,) watts   (raw)
    lat_norm: Normalizer       # std normalizer for log2(latency)
    pow_norm: Normalizer       # std normalizer for log2(power)
    net_norm: Normalizer       # std normalizer for log2(net params)

    @property
    def n(self) -> int:
        return int(self.net_idx.shape[0])

    # encoded views ---------------------------------------------------------
    def net_encoded(self, model: DesignModel, net_idx: Optional[np.ndarray] = None):
        idx = self.net_idx if net_idx is None else net_idx
        vals = model.net_space.values_from_indices(idx)
        return self.net_norm(binary_log2_encode(vals)).astype(np.float32)

    def obj_encoded(self, lat: np.ndarray, pow_: np.ndarray):
        """Objectives on the same scale-free log2 ("binary number") encoding
        as the net params (§6.1 encodes both identically).  Raw metrics span
        5-7 decades on every design model, so std-normalizing them directly
        collapses almost all objectives to ~0 and the conditional G loses
        its conditioning signal."""
        lo = self.lat_norm(binary_log2_encode(np.asarray(lat)[..., None]))
        po = self.pow_norm(binary_log2_encode(np.asarray(pow_)[..., None]))
        return np.concatenate([lo, po], axis=-1).astype(np.float32)


@dataclasses.dataclass
class DSETask:
    """One DSE task batch: networks + the user's objectives `metric <= x`
    (§5).  Row-wise slicing (`take`) and `concat` are what the serve
    micro-batcher uses to coalesce independent in-flight requests into one
    dispatchable batch and to pad it to a pow2 bucket."""

    net_idx: np.ndarray        # (T, n_net_dims)
    lat_obj: np.ndarray        # (T,) seconds
    pow_obj: np.ndarray        # (T,) watts

    def __len__(self) -> int:
        return int(np.asarray(self.net_idx).shape[0])

    def take(self, idx) -> "DSETask":
        """Row gather: idx is any numpy fancy index (ints, slice, bool
        mask).  Repeated indices are allowed — the batcher pads a
        micro-batch to its pow2 bucket by repeating the last row."""
        idx = np.asarray(idx)
        return DSETask(net_idx=np.atleast_2d(self.net_idx[idx]),
                       lat_obj=np.atleast_1d(self.lat_obj[idx]),
                       pow_obj=np.atleast_1d(self.pow_obj[idx]))

    @staticmethod
    def concat(tasks: "Sequence[DSETask]") -> "DSETask":
        """Row-wise concatenation of task batches (coalescing)."""
        assert len(tasks) > 0, "concat of zero task batches"
        return DSETask(
            net_idx=np.concatenate([np.atleast_2d(t.net_idx) for t in tasks]),
            lat_obj=np.concatenate([np.atleast_1d(t.lat_obj) for t in tasks]),
            pow_obj=np.concatenate([np.atleast_1d(t.pow_obj) for t in tasks]),
        )

    @staticmethod
    def single(net_idx: np.ndarray, lat_obj: float, pow_obj: float) -> "DSETask":
        """One request -> a 1-row task batch."""
        return DSETask(net_idx=np.atleast_2d(np.asarray(net_idx)),
                       lat_obj=np.atleast_1d(np.asarray(lat_obj, np.float64)),
                       pow_obj=np.atleast_1d(np.asarray(pow_obj, np.float64)))


def generate_dataset(
    model: DesignModel, n: int, seed: int = 0, oversample: float = 3.0
) -> Dataset:
    """Evenly sample the design space; keep `n` feasible rows."""
    rng = np.random.default_rng(seed)
    net_rows, cfg_rows, lats, pows = [], [], [], []
    got = 0
    while got < n:
        m = int(max(n * oversample, 1024))
        net_idx = model.net_space.sample_indices(rng, m)
        cfg_idx = model.space.sample_indices(rng, m)
        lat, pw = model.evaluate_indices(net_idx, cfg_idx)
        ok = np.isfinite(lat) & np.isfinite(pw)
        net_rows.append(net_idx[ok])
        cfg_rows.append(cfg_idx[ok])
        lats.append(lat[ok])
        pows.append(pw[ok])
        got += int(ok.sum())
    net_idx = np.concatenate(net_rows)[:n]
    cfg_idx = np.concatenate(cfg_rows)[:n]
    lat = np.concatenate(lats)[:n]
    pw = np.concatenate(pows)[:n]

    net_vals = model.net_space.values_from_indices(net_idx)
    return Dataset(
        model_name=model.name,
        net_idx=net_idx,
        cfg_idx=cfg_idx,
        latency=lat,
        power=pw,
        lat_norm=Normalizer.fit(binary_log2_encode(lat[:, None]), center=True),
        pow_norm=Normalizer.fit(binary_log2_encode(pw[:, None]), center=True),
        net_norm=Normalizer.fit(binary_log2_encode(net_vals), center=True),
    )


def generate_tasks(
    model: DesignModel,
    n_tasks: int,
    seed: int = 1,
    slack: tuple = (1.0, 2.5),
) -> DSETask:
    """Sample DSE tasks whose objectives are achievable (there exists at
    least one config meeting them): draw a net + a witness config, evaluate
    it, and relax the witness metrics by a random slack factor in `slack`.
    slack=(1.0, 1.0) yields Pareto-adjacent (hard) objectives (§7.4).
    """
    rng = np.random.default_rng(seed)
    net_rows, lo_rows, po_rows = [], [], []
    got = 0
    while got < n_tasks:
        m = max(n_tasks * 2, 512)
        net_idx = model.net_space.sample_indices(rng, m)
        cfg_idx = model.space.sample_indices(rng, m)
        lat, pw = model.evaluate_indices(net_idx, cfg_idx)
        ok = np.isfinite(lat) & np.isfinite(pw)
        s_l = rng.uniform(slack[0], slack[1], size=m)
        s_p = rng.uniform(slack[0], slack[1], size=m)
        net_rows.append(net_idx[ok])
        lo_rows.append((lat * s_l)[ok])
        po_rows.append((pw * s_p)[ok])
        got += int(ok.sum())
    return DSETask(
        net_idx=np.concatenate(net_rows)[:n_tasks],
        lat_obj=np.concatenate(lo_rows)[:n_tasks],
        pow_obj=np.concatenate(po_rows)[:n_tasks],
    )
