"""The DnnWeaver design model (paper §7.1.1).

Systolic-array template in the style of the open-source DnnWeaver v2 code.
Low-dimension design space (Table 1: configurations without '*'): PE number
and the three SRAM sizes.  The mapping (tiling) is derived internally by
the template's own greedy schedule, and the DRAM bandwidths are fixed board
properties.  The model reuses the im2col pipelined roofline core with
internally chosen tiles.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import ConfigSpace
from repro_torch.design_models.base import (TORCH_XP, DesignModel, make_dim,
                                            pow2_choices)
from repro_torch.design_models.im2col import (as_float, make_net_space,
                                              roofline_latency_power)

FIXED_DSB = 64.0   # DRAM->SRAM words/cycle (board property)
FIXED_SDB = 32.0   # SRAM->DRAM words/cycle


def make_dnnweaver_space() -> ConfigSpace:
    return ConfigSpace(
        dims=(
            make_dim("PEN", pow2_choices(4, 512)),
            make_dim("ISS", pow2_choices(128, 8192)),
            make_dim("WSS", pow2_choices(128, 8192)),
            make_dim("OSS", pow2_choices(128, 8192)),
        )
    )


class DnnWeaverModel(DesignModel):
    """Low-dimension design space (4 config dims, |space| = 8*7^3 = 2744)."""

    name = "dnnweaver"

    def __init__(self) -> None:
        self.space = make_dnnweaver_space()
        self.net_space = make_net_space()

    def _derive_tiles(self, net, iss, wss, oss, xp=np):
        ic, oc, ow, oh, kw, kh = (as_float(net[..., i], xp) for i in range(6))
        # template schedule: keep full kernel window; tile channels to fit
        # the weight SRAM, tile the output plane to fit the output SRAM.
        tkw, tkh = kw, kh

        def pow2floor(x):
            return xp.power(2.0, xp.floor(xp.log2(xp.maximum(x, 1.0))))

        tic = xp.maximum(pow2floor(xp.minimum(ic, wss / xp.maximum(kw * kh, 1.0))), 1.0)
        toc = xp.maximum(pow2floor(xp.minimum(
            xp.minimum(oc, oss),
            wss / xp.maximum(tic * kw * kh, 1.0))), 1.0)
        # output tile: square-ish plane tile fitting OSS alongside toc
        plane_cap = xp.maximum(oss / xp.maximum(toc, 1.0), 1.0)
        tow = xp.maximum(xp.minimum(pow2floor(xp.sqrt(plane_cap)), ow), 1.0)
        toh = xp.maximum(xp.minimum(pow2floor(plane_cap / tow), oh), 1.0)
        # input SRAM bounds the im2col patch tile: shrink (toh, tow, tic)
        # in turn (power-of-two halvings) until the patch fits.
        tiles = [toh, tow, tic]
        for j in range(3):
            patch = tiles[2] * tkw * tkh * tiles[1] * tiles[0]
            excess = xp.power(2.0, xp.ceil(xp.log2(
                xp.maximum(patch / xp.maximum(iss, 1.0), 1.0))))
            f = xp.minimum(tiles[j], excess)
            tiles[j] = xp.maximum(tiles[j] / f, 1.0)
        toh, tow, tic = tiles
        return tic, toc, tow, toh, tkw, tkh

    def evaluate(self, net: np.ndarray, config: np.ndarray):
        net = np.asarray(net, np.float64)
        c = np.asarray(config, np.float64)
        pen, iss, wss, oss = (c[..., i] for i in range(4))
        tic, toc, tow, toh, tkw, tkh = self._derive_tiles(net, iss, wss, oss)
        return roofline_latency_power(
            net, pen, FIXED_DSB, FIXED_SDB, iss, wss, oss,
            tic, toc, tow, toh, tkw, tkh,
        )

    def evaluate_torch(self, net, config):
        net = net.to(torch.float32)
        c = config.to(torch.float32)
        pen, iss, wss, oss = (c[..., i] for i in range(4))
        tic, toc, tow, toh, tkw, tkh = self._derive_tiles(
            net, iss, wss, oss, xp=TORCH_XP)
        return roofline_latency_power(
            net, pen, FIXED_DSB, FIXED_SDB, iss, wss, oss,
            tic, toc, tow, toh, tkw, tkh,
            xp=TORCH_XP,
        )
