"""Times ``GANDSE.train`` on one H100 as ``chip_smoke.py``'s training phase
runs it (im2col, G and D at 11 x 2048, 4096 rows, 2 epochs of 4 steps of
1024, seed 0), and ``init_state(seed 0)`` alone, with the package of one
checkout.  A probe, not part of the package:

    python3 src/repro_torch/kernels/probes/train_pair.py [--root DIR]

``--root`` names an unpacked checkout (``git archive``) whose package is
timed in place of this tree's; run it once a checkout in turns (old, new,
new, old) in one call to compare two revisions on one card.  Each of
``--reps`` rounds trains a fresh engine and then draws the initial state
once more; the first round also loads the kernels.  Host clock, ended by
a synchronize.  Prints one JSON line.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose package "
                    "is timed (default: this tree)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_pair: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import dse_api as dse
    from repro_torch.core import gan as G
    from repro_torch.core import train as T
    from repro_torch.dataset import generator as gen_mod
    from repro_torch.design_models import Im2colModel

    model = Im2colModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims)          # 11 x 2048
    ds = gen_mod.generate_dataset(model, 4096, seed=0)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    train_s, init_s = [], []
    for _ in range(args.reps):
        engine = dse.GANDSE(model, cfg)
        train_s.append(timed(lambda: engine.train(n_data=4096, iters=2,
                                                  seed=0, ds=ds)))
        init_s.append(timed(lambda: T.init_state(model, cfg, 0, "cuda")))
    print(json.dumps({"root": args.root,
                      "device": torch.cuda.get_device_name(0),
                      "train_s": train_s, "init_s": init_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
