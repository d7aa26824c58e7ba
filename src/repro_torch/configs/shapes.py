"""The assigned input shapes (one set, shared by all LM archs)."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def applicable(arch, shape: Shape) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM/hybrid/sliding);
    every assigned arch has a decoder, so decode shapes always apply."""
    if shape.name == "long_500k":
        return bool(arch.sub_quadratic)
    return True
