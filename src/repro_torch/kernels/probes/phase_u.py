"""Phases u and s4 of ``chip_smoke.py`` alone, on one H100.  A probe, not
part of the package:

    python3 src/repro_torch/kernels/probes/phase_u.py [--out JSON]

Builds the whole-MLP, dense, flash, selective-scan and sLSTM kernels
(one nvcc a source, in parallel), takes phase 3's 64-task Selections on
im2col (t1's, which phase u holds its ranks to) with no mesh, then runs
``chip_smoke.phase_u``: two ranks on the one card over a (1, 2) ('data',
'model') mesh, rank 0 first running the world of one (the prefills of
stablelm-1.6b, the cut mixtral-8x7b, hymba-1.5b, the cut xlstm-1.3b and
whisper-small, the Engine, whisper's decode steps, train_gan's step)
that both are held to, then each model's train step on the blocks
against the world of one's gradient; then ``chip_smoke.phase_s4``:
``launch/perf --mesh-shape 1x2`` counts stablelm's prefill and train
step on meta, their collectives held to what phase u measured.  Prints
both phases' JSON and writes it to ``--out`` where it is given.  Needs
the card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[4]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_u: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    s4 = cs.start_s4()
    try:
        return run(args, t0, s4)
    finally:
        cs.stop_s4(s4)


def run(args, t0: float, s4: tuple) -> int:
    loads = (cs.fm.load_library, cs.fd.load_library, cs.fa.load_library,
             cs.ss.load_library, cs.sl.load_library)
    with concurrent.futures.ThreadPoolExecutor(len(loads)) as pool:
        for f in [pool.submit(load) for load in loads]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    engine = cs.t_engine("cuda")
    tasks = cs.gen_mod.generate_tasks(engine.model, cs.N_TASKS, seed=1)
    sels = [cs._sel_row(r.selection)
            for r in engine.explore_batch(tasks, seed=0)]
    del engine
    out = cs.phase_u({"sels": {cs.N_TASKS: sels}})
    out["phase_s4"] = cs.phase_s4(out, s4)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"phase_u probe: {time.perf_counter() - t0:.1f} s", flush=True)
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
