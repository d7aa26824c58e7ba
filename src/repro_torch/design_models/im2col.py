"""The `im2col` design model (paper §7.1.1).

Output-stationary accelerator executing CNN layers as im2col GEMMs.  The
latency model is a roofline over three pipelined per-tile phases (load,
compute, write-back); the power model combines a static model (resource
dependent) and a dynamic model (activity dependent).  This is the paper's
high-dimension design space (Table 1, 12 configuration dims here).

The constants and the formula are the reference package's, unchanged: the
paper does not publish its calibration constants, and these are chosen to
be physically plausible for a ~200 MHz FPGA implementation.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.encoding import ConfigSpace
from repro_torch.design_models.base import (TORCH_XP, DesignModel, make_dim,
                                            pow2_choices)

CLOCK_HZ = 2.0e8           # 200 MHz
E_MAC_J = 2.0e-12          # energy per MAC
E_SRAM_J = 4.0e-12         # energy per SRAM word access
E_DRAM_J = 80.0e-12        # energy per DRAM word transferred
P_STATIC_BASE_W = 0.40     # board + logic leakage
P_STATIC_PE_W = 2.0e-4     # per PE
P_STATIC_SRAM_W = 4.0e-6   # per SRAM word of capacity
P_STATIC_BW_W = 1.5e-3     # per word/cycle of DRAM<->SRAM bandwidth

NET_DIMS = ("IC", "OC", "OW", "OH", "KW", "KH")


def make_net_space() -> ConfigSpace:
    return ConfigSpace(
        dims=(
            make_dim("IC", pow2_choices(16, 256)),
            make_dim("OC", pow2_choices(16, 256)),
            make_dim("OW", pow2_choices(8, 64)),
            make_dim("OH", pow2_choices(8, 64)),
            make_dim("KW", (1, 3, 5)),
            make_dim("KH", (1, 3, 5)),
        )
    )


def make_im2col_space() -> ConfigSpace:
    return ConfigSpace(
        dims=(
            make_dim("PEN", pow2_choices(64, 4096)),       # PE number
            make_dim("SDB", pow2_choices(16, 512)),        # SRAM->DRAM words/cyc
            make_dim("DSB", pow2_choices(16, 512)),        # DRAM->SRAM words/cyc
            make_dim("ISS", pow2_choices(256, 8192)),      # input SRAM words
            make_dim("WSS", pow2_choices(256, 8192)),      # weight SRAM words
            make_dim("OSS", pow2_choices(256, 8192)),      # output SRAM words
            make_dim("TIC", pow2_choices(4, 128)),         # tiling
            make_dim("TOC", pow2_choices(4, 128)),
            make_dim("TOW", pow2_choices(4, 256)),
            make_dim("TOH", pow2_choices(4, 256)),
            make_dim("TKW", (1, 2, 3, 4, 5)),
            make_dim("TKH", (1, 2, 3, 4, 5)),
        )
    )


def as_float(a, xp):
    """float64 on the numpy side, float32 on the torch side."""
    return a.astype(np.float64) if xp is np else a.to(torch.float32)


def _ceil_div(a, b, xp=np):
    return xp.ceil(a / b)


def roofline_latency_power(
    net,
    pen, dsb, sdb, iss, wss, oss, tic, toc, tow, toh, tkw, tkh,
    xp=np,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized 3-phase pipelined roofline.  All inputs broadcast over
    arbitrary leading dims (flat (B,) batches or (T, C) grids).

    Returns (latency_seconds, power_watts); infeasible -> latency = +inf.
    `xp` selects the array namespace: `np` (float64, host) or `TORCH_XP`
    (float32, device) — one formula, two backends.
    """
    ic, oc, ow, oh, kw, kh = (as_float(net[..., i], xp) for i in range(6))

    # effective tile sizes never exceed the real dims
    tic = xp.minimum(tic, ic)
    toc = xp.minimum(toc, oc)
    tow = xp.minimum(tow, ow)
    toh = xp.minimum(toh, oh)
    tkw = xp.minimum(tkw, kw)
    tkh = xp.minimum(tkh, kh)

    n_tiles = (
        _ceil_div(ic, tic, xp) * _ceil_div(oc, toc, xp) * _ceil_div(ow, tow, xp)
        * _ceil_div(oh, toh, xp) * _ceil_div(kw, tkw, xp) * _ceil_div(kh, tkh, xp)
    )
    n_out_tiles = _ceil_div(oc, toc, xp) * _ceil_div(ow, tow, xp) * _ceil_div(oh, toh, xp)

    tile_macs = tic * toc * tow * toh * tkw * tkh
    # --- per-tile phase cycle counts --------------------------------------
    t_comp = _ceil_div(tile_macs, pen, xp)
    in_words = tic * tkw * tkh * tow * toh        # im2col patch matrix tile
    w_words = tic * toc * tkw * tkh
    t_load = _ceil_div(in_words + w_words, dsb, xp)
    out_words = toc * tow * toh                   # written once per out tile
    t_store = _ceil_div(out_words, sdb, xp)

    # 3-stage pipeline: steady state bound by the slowest phase; store only
    # fires on output-tile boundaries so its steady-state weight is scaled.
    store_amort = t_store * (n_out_tiles / n_tiles)
    bottleneck = xp.maximum(xp.maximum(t_load, t_comp), store_amort)
    cycles = bottleneck * xp.maximum(n_tiles - 1.0, 0.0) + t_load + t_comp + t_store

    # --- feasibility -------------------------------------------------------
    feasible = (in_words <= iss) & (w_words <= wss) & (out_words <= oss)
    cycles = xp.where(feasible, cycles, xp.inf)

    # --- power -------------------------------------------------------------
    total_macs = ic * oc * ow * oh * kw * kh
    dram_words = n_tiles * (in_words + w_words) + n_out_tiles * out_words
    sram_words = 2.0 * total_macs + n_out_tiles * out_words
    energy = E_MAC_J * total_macs + E_SRAM_J * sram_words + E_DRAM_J * dram_words
    lat_s = cycles / CLOCK_HZ
    p_static = (
        P_STATIC_BASE_W
        + P_STATIC_PE_W * pen
        + P_STATIC_SRAM_W * (iss + wss + oss)
        + P_STATIC_BW_W * (sdb + dsb)
    )
    ctx = np.errstate(invalid="ignore") if xp is np else contextlib.nullcontext()
    with ctx:
        p_dyn = xp.where(xp.isfinite(lat_s), energy / xp.maximum(lat_s, 1e-12), 0.0)
    power = p_static + p_dyn
    power = xp.where(feasible, power, xp.inf)
    return lat_s, power


class Im2colModel(DesignModel):
    """High-dimension design space (12 config dims, |space| ~ 3.3e9)."""

    name = "im2col"

    def __init__(self) -> None:
        self.space = make_im2col_space()
        self.net_space = make_net_space()

    def evaluate(self, net: np.ndarray, config: np.ndarray):
        net = np.asarray(net, np.float64)
        c = np.asarray(config, np.float64)
        (pen, sdb, dsb, iss, wss, oss, tic, toc, tow, toh, tkw, tkh) = (
            c[..., i] for i in range(12)
        )
        return roofline_latency_power(
            net, pen, dsb, sdb, iss, wss, oss, tic, toc, tow, toh, tkw, tkh
        )

    def evaluate_torch(self, net, config):
        net = net.to(torch.float32)
        c = config.to(torch.float32)
        (pen, sdb, dsb, iss, wss, oss, tic, toc, tow, toh, tkw, tkh) = (
            c[..., i] for i in range(12)
        )
        return roofline_latency_power(
            net, pen, dsb, sdb, iss, wss, oss, tic, toc, tow, toh, tkw, tkh,
            xp=TORCH_XP,
        )
