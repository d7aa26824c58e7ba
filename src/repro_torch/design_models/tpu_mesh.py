"""TPU-mesh design model — the beyond-paper GANDSE application.

The GAN-DSE engine pointed at a distributed-training design space: the
"network parameters" are a transformer workload descriptor and the
"configurations" are parallelism knobs (pods, data-parallel degree,
tensor-parallel degree, microbatch, remat, dtype, gradient compression).
The design model is a three-term roofline of a TPU training step.

Objectives (the paper's "latency <= x, power <= y" format):
  latency = roofline-bounded training step time (s)
  power   = cluster board power (W): chips * (idle + dynamic * utilization)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import ConfigSpace
from repro_torch.design_models.base import (TORCH_XP, DesignModel, make_dim,
                                            pow2_choices)

# Hardware constants of the TPU v5e-class chip being *designed for* — a
# property of the modelled cluster, not of the machine running this code.
PEAK_FLOPS_BF16 = 197e12          # FLOP/s
HBM_BW = 819e9                    # B/s
ICI_LINK_BW = 50e9                # B/s per link

DCN_BW = 25e9            # B/s cross-pod per chip
HBM_CAP = 16e9           # bytes per chip (v5e-class)
CHIP_IDLE_W = 150.0
CHIP_DYN_W = 250.0
CHIPS_PER_POD = 256


def make_workload_space() -> ConfigSpace:
    """Net-parameter space: the LM workload descriptor."""
    return ConfigSpace(dims=(
        make_dim("LAYERS", (12, 24, 32, 40, 48, 64)),
        make_dim("DMODEL", (768, 1152, 1600, 2048, 3584, 4096, 5120, 7168)),
        make_dim("DFF_MULT", (2, 3, 4, 5)),          # d_ff = mult * d_model
        make_dim("SEQ", (2048, 4096, 8192, 16384, 32768)),
        make_dim("GBATCH", (32, 64, 128, 256, 512)),
        make_dim("VOCAB", (32768, 65536, 131072, 262144)),
    ))


def make_mesh_space() -> ConfigSpace:
    """Configuration space: the parallelism knobs."""
    return ConfigSpace(dims=(
        make_dim("PODS", (1, 2, 4, 8)),
        make_dim("DP", pow2_choices(1, 64)),          # per-pod data axis
        make_dim("TP", pow2_choices(1, 64)),          # per-pod model axis
        make_dim("MICRO", pow2_choices(1, 16)),       # grad-accum microbatches
        make_dim("REMAT", (0, 1)),
        make_dim("BYTES_P", (2, 4)),                  # param dtype
        make_dim("COMPRESS", (1, 4)),                 # DCN grad compression x
    ))


class TpuMeshModel(DesignModel):
    """Analytic 3-term roofline over (workload, mesh config)."""

    name = "tpu_mesh"

    def __init__(self) -> None:
        self.space = make_mesh_space()
        self.net_space = make_workload_space()

    def evaluate(self, net: np.ndarray, config: np.ndarray):
        net = np.asarray(net, np.float64)
        c = np.asarray(config, np.float64)
        return self._evaluate(net, c, xp=np)

    def evaluate_torch(self, net, config):
        return self._evaluate(net.to(torch.float32),
                              config.to(torch.float32), xp=TORCH_XP)

    def _evaluate(self, net, c, xp):
        layers, dm, ffm, seq, gb, vocab = (net[..., i] for i in range(6))
        pods, dp, tp, micro, remat, bytes_p, comp = (c[..., i] for i in range(7))

        dff = ffm * dm
        n_params = layers * (4 * dm * dm + 3 * dm * dff) + vocab * dm
        chips_per_pod = dp * tp
        chips = pods * chips_per_pod
        tokens = gb * seq

        # --- feasibility ----------------------------------------------------
        feasible = (chips_per_pod <= CHIPS_PER_POD) & (gb % (pods * dp * micro) == 0) \
            & (dm % tp == 0)

        # --- compute term ---------------------------------------------------
        flops = 6.0 * n_params * tokens * (1.0 + 0.33 * remat)
        t_comp = flops / (chips * PEAK_FLOPS_BF16)

        # --- memory term ----------------------------------------------------
        # params+opt per chip (FSDP over dp*tp within a pod)
        state_bytes = n_params * (bytes_p + 8.0) / chips_per_pod
        act_rows = gb / (pods * dp * micro)               # rows resident
        act_bytes = act_rows * seq * dm * 2.0 * layers / tp
        act_bytes = xp.where(remat > 0, act_bytes, act_bytes * 6.0)
        hbm = state_bytes + act_bytes
        feasible &= hbm <= HBM_CAP
        # traffic: weights streamed once per microbatch (+bwd), acts 3x
        traffic = (micro * 3.0 * n_params * bytes_p / chips_per_pod
                   + 6.0 * act_bytes)
        t_mem = traffic / HBM_BW

        # --- collective term --------------------------------------------------
        # per-chip bytes (ring collectives move ~2x the local shard per chip
        # regardless of group size)
        rows_per_chip = gb / xp.maximum(pods * dp * micro, 1.0)
        act_bytes_chip = rows_per_chip * seq * dm * 2.0
        # 4 TP all-reduces per layer, fwd+bwd, every microbatch
        tp_bytes = xp.where(tp > 1,
                            layers * 4.0 * 2.0 * 2.0 * act_bytes_chip * micro,
                            0.0)
        # FSDP all-gather of params each microbatch (fwd+bwd) over dp
        ag_bytes = xp.where(dp > 1, micro * 2.0 * n_params * bytes_p / tp, 0.0)
        # gradient reduce-scatter/all-gather over dp (ICI)
        gr_bytes = xp.where(dp > 1, 2.0 * n_params * bytes_p / tp, 0.0)
        t_ici = (tp_bytes + ag_bytes + gr_bytes) / ICI_LINK_BW
        # cross-pod gradient all-reduce over DCN (compressed)
        dcn_bytes = xp.where(pods > 1,
                             2.0 * n_params * bytes_p / comp / chips_per_pod, 0.0)
        t_dcn = dcn_bytes / DCN_BW
        t_coll = t_ici + t_dcn

        # --- objectives -------------------------------------------------------
        latency = xp.maximum(xp.maximum(t_comp, t_mem), t_coll)
        util = xp.where(latency > 0, t_comp / xp.maximum(latency, 1e-12), 0.0)
        power = chips * (CHIP_IDLE_W + CHIP_DYN_W * util)

        latency = xp.where(feasible, latency, xp.inf)
        power = xp.where(feasible, power, xp.inf)
        return latency, power
