"""Feature encoding for GAN-based DSE (paper §6.1).

Configurations are one-hot encoded: "most of the configurations of the
architectures and mapping strategies are not successive and only some
specific numbers are meaningful".  The user's objectives and the network
parameters are encoded as (binary) numbers normalized by the standard
deviation.

The numpy methods are the reference package's own; the torch twins
(``split_groups_padded``, ``values_from_indices_torch``) are what the
device-side oracles and the per-group softmax build on.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ConfigDim:
    """One configuration dimension with its discrete legal choices."""

    name: str
    choices: Tuple[float, ...]

    @property
    def n(self) -> int:
        return len(self.choices)


@dataclasses.dataclass(frozen=True)
class ConfigSpace:
    """The discrete design space: a product of one-hot `ConfigDim`s."""

    dims: Tuple[ConfigDim, ...]

    @property
    def n_dims(self) -> int:
        return len(self.dims)

    @property
    def onehot_width(self) -> int:
        return sum(d.n for d in self.dims)

    @property
    def group_sizes(self) -> Tuple[int, ...]:
        return tuple(d.n for d in self.dims)

    @property
    def size(self) -> int:
        out = 1
        for d in self.dims:
            out *= d.n
        return out

    @property
    def max_group_size(self) -> int:
        return max(d.n for d in self.dims)

    # ---- index <-> value -------------------------------------------------
    def values_from_indices(self, idx: np.ndarray) -> np.ndarray:
        """idx: (..., n_dims) integer choice indices -> (..., n_dims) values."""
        idx = np.asarray(idx)
        cols = [np.asarray(d.choices)[idx[..., i]] for i, d in enumerate(self.dims)]
        return np.stack(cols, axis=-1)

    def indices_from_values(self, vals: np.ndarray) -> np.ndarray:
        vals = np.asarray(vals)
        cols = []
        for i, d in enumerate(self.dims):
            table = np.asarray(d.choices)
            # nearest legal choice (values are expected to be exact members)
            cols.append(np.argmin(np.abs(vals[..., i, None] - table[None, :]), axis=-1))
        return np.stack(cols, axis=-1)

    # ---- one-hot ---------------------------------------------------------
    def onehot_from_indices(self, idx: np.ndarray) -> np.ndarray:
        """(..., n_dims) -> (..., onehot_width) float32 one-hot."""
        idx = np.asarray(idx)
        parts = []
        for i, d in enumerate(self.dims):
            parts.append(np.eye(d.n, dtype=np.float32)[idx[..., i]])
        return np.concatenate(parts, axis=-1)

    def indices_from_onehot(self, oh: np.ndarray) -> np.ndarray:
        """(..., onehot_width) (soft ok) -> argmax per group -> (..., n_dims)."""
        oh = np.asarray(oh)
        out, off = [], 0
        for d in self.dims:
            out.append(np.argmax(oh[..., off : off + d.n], axis=-1))
            off += d.n
        return np.stack(out, axis=-1)

    def split_groups(self, flat):
        """Split a (..., onehot_width) array into per-dim groups."""
        out, off = [], 0
        for d in self.dims:
            out.append(flat[..., off : off + d.n])
            off += d.n
        return out

    def sample_indices(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Evenly sample the design space (paper §5.1 dataset generator)."""
        return np.stack(
            [rng.integers(0, d.n, size=n) for d in self.dims], axis=-1
        )

    # ---- torch twins -----------------------------------------------------
    def split_groups_padded(self, flat: torch.Tensor, fill: float = 0.0
                            ) -> Tuple[torch.Tensor, np.ndarray]:
        """Batched padded per-group view: (..., onehot_width) -> (...,
        n_dims, max_group_size) with `fill` in the padding slots, plus the
        (n_dims, max_group_size) numpy validity mask.  One wide gather
        instead of a ragged slice chain."""
        t = device_tables(self, flat.device)
        return torch.where(t.mask, flat[..., t.gidx], fill), t.mask_np

    def values_from_indices_torch(self, idx: torch.Tensor) -> torch.Tensor:
        """Torch twin of `values_from_indices`: (..., n_dims) integer choice
        indices -> (..., n_dims) float32 values, one gather from the padded
        (n_dims, max_group_size) choice table."""
        t = device_tables(self, idx.device)
        return t.values[t.dim_ar, idx]


@functools.lru_cache(maxsize=None)
def padded_group_layout(space: ConfigSpace):
    """Constant index maps for vectorized per-group ops.

    Groups have ragged sizes; padding them to (n_dims, max_n) lets per-group
    softmax/threshold/argmax run as ONE wide op.  Returns (gather_idx
    (n_dims, max_n), mask, flat_scatter (onehot_width,)):
    ``flat[..., gather_idx]`` -> padded view; ``padded.reshape(..., -1)
    [..., flat_scatter]`` -> flat view.  Plain numpy outputs.
    """
    sizes = space.group_sizes
    mx = max(sizes)
    gidx = np.zeros((len(sizes), mx), np.int32)
    mask = np.zeros((len(sizes), mx), bool)
    flat2pad = np.zeros(space.onehot_width, np.int32)
    off = 0
    for g, n in enumerate(sizes):
        for j in range(n):
            gidx[g, j] = off + j
            mask[g, j] = True
            flat2pad[off + j] = g * mx + j
        off += n
    return gidx, mask, flat2pad


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """`padded_group_layout` and the float32 choice table, resident on one
    device (built once per (space, device), so hot paths never re-upload
    constants)."""

    gidx: torch.Tensor        # (n_dims, max_n) int64
    mask: torch.Tensor        # (n_dims, max_n) bool
    mask_np: np.ndarray
    flat2pad: torch.Tensor    # (onehot_width,) int64
    values: torch.Tensor      # (n_dims, max_n) float32 choice values
    dim_ar: torch.Tensor      # (n_dims,) int64


@functools.lru_cache(maxsize=None)
def _device_tables(space: ConfigSpace, device: str) -> DeviceTables:
    gidx, mask, flat2pad = padded_group_layout(space)
    vals = np.zeros(mask.shape, np.float32)
    for g, d in enumerate(space.dims):
        vals[g, : d.n] = np.asarray(d.choices, np.float32)
    return DeviceTables(
        gidx=torch.as_tensor(gidx, dtype=torch.int64, device=device),
        mask=torch.as_tensor(mask, device=device),
        mask_np=mask,
        flat2pad=torch.as_tensor(flat2pad, dtype=torch.int64, device=device),
        values=torch.as_tensor(vals, device=device),
        dim_ar=torch.arange(space.n_dims, device=device),
    )


def device_tables(space: ConfigSpace, device) -> DeviceTables:
    return _device_tables(space, str(torch.device(device)))


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Standard-deviation normalization for objectives / net params (§6.1)."""

    mean: np.ndarray
    std: np.ndarray

    @staticmethod
    def fit(x: np.ndarray, center: bool = False) -> "Normalizer":
        x = np.asarray(x, np.float64)
        std = x.std(axis=0)
        std = np.where(std < 1e-12, 1.0, std)
        mean = x.mean(axis=0) if center else np.zeros(x.shape[-1])
        return Normalizer(mean=mean, std=std)

    def __call__(self, x):
        return (x - self.mean) / self.std

    def inverse(self, x):
        return x * self.std + self.mean

    def to_dict(self) -> Dict[str, List[float]]:
        return {"mean": self.mean.tolist(), "std": self.std.tolist()}

    @staticmethod
    def from_dict(d) -> "Normalizer":
        return Normalizer(np.asarray(d["mean"]), np.asarray(d["std"]))


def binary_log2_encode(vals: np.ndarray) -> np.ndarray:
    """Encode positive integer-ish parameters on a log2 scale (the paper's
    'binary numbers'), then std-normalized by the caller."""
    return np.log2(np.maximum(np.asarray(vals, np.float64), 1e-9))
