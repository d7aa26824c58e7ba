"""im2col (GANDSE §7.1.1): the high-dimension space, 12 configuration
dimensions.  ``cfg`` columns: PEN, SDB, DSB, ISS, WSS, OSS, TIC, TOC,
TOW, TOH, TKW, TKH."""
from __future__ import annotations

from perfbench.reference.oracles import pow2, roofline_latency_power

CFG_CHOICES = (pow2(64, 4096), pow2(16, 512), pow2(16, 512),
               pow2(256, 8192), pow2(256, 8192), pow2(256, 8192),
               pow2(4, 128), pow2(4, 128), pow2(4, 256), pow2(4, 256),
               (1.0, 2.0, 3.0, 4.0, 5.0), (1.0, 2.0, 3.0, 4.0, 5.0))


def formula(net, cfg, xp):
    c = xp.cast(cfg)
    pen, sdb, dsb, iss, wss, oss, tic, toc, tow, toh, tkw, tkh = (
        c[..., i] for i in range(12))
    return roofline_latency_power(net, pen, dsb, sdb, iss, wss, oss, tic,
                                  toc, tow, toh, tkw, tkh, xp)
