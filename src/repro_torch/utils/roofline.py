"""Three-term roofline of a counted step on one NVIDIA H100 SXM (80 GB
HBM3): the reference's ``Roofline`` with the card's constants.

  compute term    = sum over execution units of flops_u / peak_u
  memory term     = hbm_bytes / HBM rate
  collective term = coll_bytes / NVLink rate

The counts come from ``utils/op_cost`` (``from_counted``), in place of the
reference's compiled HLO (``from_compiled``).  The compute term is a sum
over units because a step's products do not share one peak: cuBLAS runs
float32 products on the SIMT cores with TF32 off (67 TFLOP/s), the
port's 3xTF32 kernels make three TF32 products of each (494.7 / 3
TFLOP/s), and bf16 runs on the tensor cores at 989.4 TFLOP/s.  Each
unit's term is its least time; the step takes at least their sum.

``mfu_bound`` and any later share of peak divide by the card's dense
tensor-core peak for the step's dtype: 494.7 TFLOP/s for float32 (TF32,
the fastest way the card multiplies float32 operands) and 989.4 for bf16.
No unit runs faster than that peak, so a step whose model flops are at
most its counted flops cannot read over 1; dividing by the 67 TFLOP/s the
float32 products actually run at would let an honest step read over 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

#: H100 SXM HBM3, bytes a second
HBM_BW = 3.35e12
#: NVLink 4, bytes a second each way: the collective term's rate
NVLINK_BW = 450e9
#: dense peaks a second of each execution unit, in the flops it is
#: charged with: SIMT float32; the 3xTF32 tile (three TF32 products of
#: each product flop); bf16 on the tensor cores; float64 on the tensor
#: cores (DGEMM)
PEAK_FLOPS: Dict[str, float] = {
    "fp32_simt": 67e12,
    "tf32x3": 494.7e12 / 3,
    "bf16": 989.4e12,
    "fp64": 67e12,
}
#: the card's dense tensor-core peak for a step's dtype: the denominator
#: of ``mfu_bound``
PEAK_DENSE: Dict[str, float] = {"float32": 494.7e12, "bfloat16": 989.4e12}


@dataclasses.dataclass
class Roofline:
    name: str
    flops: float                  # counted product flops (per device)
    hbm_bytes: float              # counted HBM bytes (per device)
    coll_bytes: float             # collective bytes (per device)
    chips: int
    model_flops: float = 0.0      # 6*N*D useful FLOPs (whole step, global)
    flops_by_unit: Optional[Mapping[str, float]] = None
    dtype: str = "float32"        # the step's dtype: mfu_bound's peak

    @property
    def t_compute(self) -> float:
        by_unit = self.flops_by_unit or {"fp32_simt": self.flops}
        return sum(f / PEAK_FLOPS[u] for u, f in by_unit.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time (s): overlapped model -> max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / (chips * counted flops): how much counted compute
        is useful (catches remat / redundancy waste)."""
        if not self.model_flops:
            return None
        return self.model_flops / max(self.flops * self.chips, 1.0)

    @property
    def mfu_bound(self) -> Optional[float]:
        """Upper bound on MFU at the roofline step time, against the
        card's dense tensor-core peak for the step's dtype."""
        if not self.model_flops:
            return None
        return self.model_flops / (self.t_bound * self.chips
                                   * PEAK_DENSE[self.dtype])

    def row(self) -> Dict[str, object]:
        return {
            "case": self.name,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "bottleneck": self.bottleneck,
            "useful_ratio": (round(self.useful_ratio, 4)
                             if self.useful_ratio is not None else None),
            "mfu_bound": (round(self.mfu_bound, 4)
                          if self.mfu_bound is not None else None),
        }


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6*N*D for one training step."""
    return 6.0 * n_params_active * tokens


def model_flops_forward(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens


def from_counted(name: str, counted: Mapping[str, object], chips: int = 1,
                 model_flops: float = 0.0,
                 dtype: str = "float32") -> Roofline:
    """Roofline terms from ``op_cost``'s totals of one call of the step
    (``op_cost.analyze``)."""
    return Roofline(name=name, flops=float(counted["flops"]),
                    hbm_bytes=float(counted["hbm_bytes"]),
                    coll_bytes=float(counted["coll_bytes"]), chips=chips,
                    model_flops=model_flops,
                    flops_by_unit=dict(counted["flops_by_unit"]),
                    dtype=dtype)
