"""DnnWeaver (GANDSE §7.1.1): the low-dimension space, 4 configuration
dimensions (PEN, ISS, WSS, OSS, 2744 points); the tiles come from the
template's own greedy schedule and the DRAM bandwidths are fixed."""
from __future__ import annotations

from perfbench.reference.oracles import pow2, roofline_latency_power

CFG_CHOICES = (pow2(4, 512), pow2(128, 8192), pow2(128, 8192),
               pow2(128, 8192))
DSB, SDB = 64.0, 32.0


def _tiles(net, iss, wss, oss, xp):
    ic, oc, ow, oh, kw, kh = (xp.cast(net[..., i]) for i in range(6))
    tkw, tkh = kw, kh

    def pow2floor(x):
        return xp.power(2.0, xp.floor(xp.log2(xp.maximum(x, 1.0))))

    tic = xp.maximum(pow2floor(xp.minimum(ic, wss / xp.maximum(kw * kh, 1.0))),
                     1.0)
    toc = xp.maximum(pow2floor(xp.minimum(
        xp.minimum(oc, oss), wss / xp.maximum(tic * kw * kh, 1.0))), 1.0)
    plane_cap = xp.maximum(oss / xp.maximum(toc, 1.0), 1.0)
    tow = xp.maximum(xp.minimum(pow2floor(xp.sqrt(plane_cap)), ow), 1.0)
    toh = xp.maximum(xp.minimum(pow2floor(plane_cap / tow), oh), 1.0)
    tiles = [toh, tow, tic]
    for j in range(3):
        patch = tiles[2] * tkw * tkh * tiles[1] * tiles[0]
        excess = xp.power(2.0, xp.ceil(xp.log2(
            xp.maximum(patch / xp.maximum(iss, 1.0), 1.0))))
        f = xp.minimum(tiles[j], excess)
        tiles[j] = xp.maximum(tiles[j] / f, 1.0)
    toh, tow, tic = tiles
    return tic, toc, tow, toh, tkw, tkh


def formula(net, cfg, xp):
    c = xp.cast(cfg)
    pen, iss, wss, oss = (c[..., i] for i in range(4))
    tic, toc, tow, toh, tkw, tkh = _tiles(net, iss, wss, oss, xp)
    return roofline_latency_power(net, pen, DSB, SDB, iss, wss, oss, tic,
                                  toc, tow, toh, tkw, tkh, xp)
