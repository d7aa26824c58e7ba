"""Run one cell of the benchmark of GANDSE's PyTorch and CUDA port once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with an NVIDIA card.  The run
sets up (builds or loads the kernels, makes its inputs and weights from
the seed, warms up the cell's shapes), measures for ``--seconds``, checks
what the measured window produced against the plain reference under
``perfbench/reference/``, and prints one JSON line last on standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``).  BENCHMARK.json names the cells, metrics and
bounds; PERF.md says why.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        print("BENCHMARK.json is not beside perfbench/", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from perfbench.lib import harness
    return harness.run(ROOT, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
