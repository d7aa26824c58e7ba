"""Frozen copies of the design models' oracles, one module a design model,
found by the name a configuration file gives (``design_model``).

Each module exports ``NET_CHOICES`` and ``CFG_CHOICES`` (the legal values
of each dimension, in the program's order) and ``formula(net, cfg, xp)``,
the latency and power of configuration values ``cfg`` for network values
``net``.  ``xp`` is `NP` (float64, the host oracle every reported metric
comes from) or `TORCH32` (float32 on the tensors' device, the oracle that
steers Algorithm 2 and labels Algorithm 1's samples).  The formulas are
written op for op as the paper's reproduction states them, so the float32
values match the program's bit for bit where the program keeps to them.
"""
from __future__ import annotations

import importlib
from types import ModuleType

import numpy as np
import torch


class _NP:
    """numpy in float64."""

    inf = np.inf
    ceil = staticmethod(np.ceil)
    floor = staticmethod(np.floor)
    sqrt = staticmethod(np.sqrt)
    isfinite = staticmethod(np.isfinite)
    where = staticmethod(np.where)
    power = staticmethod(np.power)
    minimum = staticmethod(np.minimum)
    maximum = staticmethod(np.maximum)
    log2 = staticmethod(np.log2)

    @staticmethod
    def cast(a):
        return np.asarray(a, np.float64)


class _Torch32:
    """torch in float32.  A binary op with a Python scalar goes through
    ``clamp``; ``log2`` is ``log(x) / log(2)`` with a float32 ``log(2)``."""

    inf = float("inf")
    ceil = staticmethod(torch.ceil)
    floor = staticmethod(torch.floor)
    sqrt = staticmethod(torch.sqrt)
    isfinite = staticmethod(torch.isfinite)
    where = staticmethod(torch.where)
    power = staticmethod(torch.pow)

    @staticmethod
    def cast(a):
        return a.to(torch.float32)

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


NP = _NP()
TORCH32 = _Torch32()


def load(design_model: str) -> ModuleType:
    """The oracle module of a design model, by its name."""
    if not design_model.replace("_", "").isalnum():
        raise ValueError(f"bad design model name {design_model!r}")
    return importlib.import_module(f"{__name__}.{design_model}")


def pow2(lo: int, hi: int) -> tuple:
    out, v = [], lo
    while v <= hi:
        out.append(float(v))
        v *= 2
    return tuple(out)


#: the network-parameter space both design models share: IC, OC, OW, OH,
#: KW, KH
NET_CHOICES = (pow2(16, 256), pow2(16, 256), pow2(8, 64), pow2(8, 64),
               (1.0, 3.0, 5.0), (1.0, 3.0, 5.0))


class Space:
    """Index <-> value tables of a list of choice tuples."""

    def __init__(self, choices):
        self.choices = tuple(tuple(float(v) for v in c) for c in choices)
        self.sizes = tuple(len(c) for c in self.choices)
        self.n_dims = len(self.choices)
        self.width = sum(self.sizes)
        self.offsets = tuple(int(v) for v in np.cumsum((0,) + self.sizes[:-1]))
        mx = max(self.sizes)
        self.table = np.zeros((self.n_dims, mx), np.float64)
        for i, c in enumerate(self.choices):
            self.table[i, :len(c)] = c

    def values(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        return self.table[np.arange(self.n_dims), idx]

    def values_torch(self, idx: torch.Tensor) -> torch.Tensor:
        """float32 values of integer indices, on the indices' device."""
        tab = torch.as_tensor(self.table.astype(np.float32), device=idx.device)
        return tab[torch.arange(self.n_dims, device=idx.device), idx]

    def onehot(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        out = np.zeros(idx.shape[:-1] + (self.width,), np.float32)
        for i, off in enumerate(self.offsets):
            np.put_along_axis(out, off + idx[..., i:i + 1], 1.0, axis=-1)
        return out

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return np.stack([rng.integers(0, s, size=n) for s in self.sizes], -1)


class Oracle:
    """A design model's two oracles over index arrays."""

    def __init__(self, design_model: str):
        mod = load(design_model)
        self.name = design_model
        self.net = Space(NET_CHOICES)
        self.cfg = Space(mod.CFG_CHOICES)
        self._formula = mod.formula

    def host(self, net_idx, cfg_idx):
        """float64 (latency s, power W) on the host; +inf where infeasible."""
        net = self.net.values(net_idx)
        cfg = self.cfg.values(cfg_idx)
        return self._formula(net, cfg, NP)

    def device(self, net_idx: torch.Tensor, cfg_idx: torch.Tensor):
        """float32 (latency, power) on the indices' device."""
        return self._formula(self.net.values_torch(net_idx),
                             self.cfg.values_torch(cfg_idx), TORCH32)


def roofline_latency_power(net, pen, dsb, sdb, iss, wss, oss, tic, toc, tow,
                           toh, tkw, tkh, xp):
    """The im2col template's three-phase pipelined roofline (load, compute,
    write-back) and its static plus dynamic power; infeasible tiles give
    +inf.  Shared by both design models."""
    clock_hz = 2.0e8
    e_mac, e_sram, e_dram = 2.0e-12, 4.0e-12, 80.0e-12
    p_base, p_pe, p_sram, p_bw = 0.40, 2.0e-4, 4.0e-6, 1.5e-3
    ic, oc, ow, oh, kw, kh = (xp.cast(net[..., i]) for i in range(6))

    def cdiv(a, b):
        return xp.ceil(a / b)

    tic = xp.minimum(tic, ic)
    toc = xp.minimum(toc, oc)
    tow = xp.minimum(tow, ow)
    toh = xp.minimum(toh, oh)
    tkw = xp.minimum(tkw, kw)
    tkh = xp.minimum(tkh, kh)
    n_tiles = (cdiv(ic, tic) * cdiv(oc, toc) * cdiv(ow, tow) * cdiv(oh, toh)
               * cdiv(kw, tkw) * cdiv(kh, tkh))
    n_out_tiles = cdiv(oc, toc) * cdiv(ow, tow) * cdiv(oh, toh)
    tile_macs = tic * toc * tow * toh * tkw * tkh
    t_comp = cdiv(tile_macs, pen)
    in_words = tic * tkw * tkh * tow * toh
    w_words = tic * toc * tkw * tkh
    t_load = cdiv(in_words + w_words, dsb)
    out_words = toc * tow * toh
    t_store = cdiv(out_words, sdb)
    store_amort = t_store * (n_out_tiles / n_tiles)
    bottleneck = xp.maximum(xp.maximum(t_load, t_comp), store_amort)
    cycles = (bottleneck * xp.maximum(n_tiles - 1.0, 0.0) + t_load + t_comp
              + t_store)
    feasible = (in_words <= iss) & (w_words <= wss) & (out_words <= oss)
    cycles = xp.where(feasible, cycles, xp.inf)
    total_macs = ic * oc * ow * oh * kw * kh
    dram_words = n_tiles * (in_words + w_words) + n_out_tiles * out_words
    sram_words = 2.0 * total_macs + n_out_tiles * out_words
    energy = e_mac * total_macs + e_sram * sram_words + e_dram * dram_words
    lat_s = cycles / clock_hz
    p_static = p_base + p_pe * pen + p_sram * (iss + wss + oss) + p_bw * (
        sdb + dsb)
    with np.errstate(invalid="ignore"):
        p_dyn = xp.where(xp.isfinite(lat_s),
                         energy / xp.maximum(lat_s, 1e-12), 0.0)
    power = xp.where(feasible, p_static + p_dyn, xp.inf)
    return lat_s, power
