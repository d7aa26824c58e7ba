"""Serving example on the PyTorch/CUDA port: the continuous-batching
engine over a reduced gemma3 (5:1 local:global attention) with
mixed-length requests, the twin of ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Runs on the card unless given ``--device cpu``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.explorer import resolve_device
from repro_torch.launch.serve import Engine, Request
from repro_torch.models import base as MB


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    m = configs.get_reduced("gemma3-1b")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, device)
    eng = Engine(m, params, batch_slots=4, cache_len=128, device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for r in range(12):
        plen = int(rng.integers(4, 24))
        eng.submit(Request(rid=r, prompt=rng.integers(0, m.vocab, plen).tolist(),
                           max_new=int(rng.integers(8, 24))))
    iters = eng.run()
    toks = sum(len(r.out) for r in eng.finished)
    dt = time.time() - t0
    print(f"served {len(eng.finished)} requests, {toks} tokens, "
          f"{iters} engine iterations, {toks/dt:.1f} tok/s on {device}")
    for r in eng.finished[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} out[:8]={r.out[:8]}")
    return eng


if __name__ == "__main__":
    main()
