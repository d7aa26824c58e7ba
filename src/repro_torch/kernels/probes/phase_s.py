"""Phase s of ``chip_smoke.py`` alone, on one H100.  A probe, not part of
the package:

    python3 src/repro_torch/kernels/probes/phase_s.py

Builds the kernels, starts s2's counts on meta in a process of their own
(``chip_smoke.count_paths``: every path the script times, at its own
shapes), then runs ``chip_smoke.phase_s`` with no measured times: s1 (each
kernel's meta route against its launch on the card), the check of
``CARD_BYTES`` against the card's memory, and s3 (``launch/perf``'s sweep
of stablelm-1.6b's train step, timed).  It prints the counted bounds; the
measured times they stand beside come from the whole script.  Needs the
card.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[4]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_s: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.smi()}", flush=True)
    counting = cs.start_counting()
    try:
        for late in cs.build_all():
            late.result()
        cs.print_builds(["flash_attention.cu", "slstm_scan.cu"])
        out = cs.phase_s(counting, {}, {})
    finally:
        if counting[0].poll() is None:
            counting[0].kill()
            counting[0].wait()
    print("total_memory: " + json.dumps(out["bounds"]["card_bytes"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
