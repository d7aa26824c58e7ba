"""Two readings of LM training on one H100 that ``chip_smoke.py`` does not
take.  A probe, not part of the package:

    python3 src/repro_torch/kernels/probes/lm_train_probe.py [--reps 2]

1. Peak memory and host ms of one ``train/step.loss_and_grads`` (forward
   and backward, no remat) of stablelm-1.6b at full width, float32 from
   seed 0, batch 2 x 2048 of ``SyntheticStream``, with the segments'
   layers taken as ``models/base`` takes them (one ``unbind(0)`` a stack
   leaf) and taken by indexing (``a[r]`` a layer, whose backward
   allocates a zero stack a layer), in turns (unbind, index, index,
   unbind, ...).
2. The flash Function's backward alone (``nn/attention.flash_backward``)
   at chip_smoke's three layer shapes, 3 x ``--reps`` CUDA-event medians
   of 20 calls each in one process, to show its spread.

Prints the card's name and power limit and one JSON line.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.abspath(os.path.join(
    os.path.dirname(__file__), *[".."] * 3))))

#: (B, H, Hkv, S, D, window), as chip_smoke.py's FLASH_GRAD_SHAPES
SHAPES = {"stablelm-1.6b 2x32x2048x64": (2, 32, 32, 2048, 64, None),
          "gemma3 global 1x4x4096x256 kv1": (1, 4, 1, 4096, 256, None),
          "gemma3 local 1x4x4096x256 kv1 w1024": (1, 4, 1, 4096, 256, 1024)}


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def grad_memory(reps: int) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.data.synthetic import DataConfig, SyntheticStream
    from repro_torch.models import base as MB
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train import step as TS
    m = configs.get_arch("stablelm-1.6b")
    from repro_torch.core import prng
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cuda")
    toks, labels = SyntheticStream(DataConfig(
        vocab=m.vocab, seq_len=2048, global_batch=2, seed=0)).batch(0)
    batch = {"tokens": torch.from_numpy(toks).to("cuda", torch.long),
             "labels": torch.from_numpy(labels).to("cuda", torch.long)}
    unbind = MB._unstacked

    def index(tree):
        n = tree_leaves(tree)[0].shape[0]
        return [tree_map(lambda a, r=r: a[r], tree) for r in range(n)]

    out = {"unbind": [], "index": []}
    TS.loss_and_grads(m, params, batch)                   # warm
    for i in range(2 * reps):
        mode = ("unbind", "index", "index", "unbind")[i % 4]
        MB._unstacked = unbind if mode == "unbind" else index
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, grads = TS.loss_and_grads(m, params, batch)
        torch.cuda.synchronize()
        out[mode].append(dict(
            ms=1e3 * (time.perf_counter() - t0),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        del grads
    MB._unstacked = unbind
    out["params_gb"] = 4 * MB.param_count(params) / 1e9
    return out


def backward_spread(reps: int) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn import attention as A
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for label, (b, h, hkv, s, d, window) in SHAPES.items():
        q, k, v, do = (torch.randn(b, s, n, d, generator=gen, device="cuda")
                       .transpose(1, 2) for n in (h, hkv, hkv, h))
        kw = dict(causal=True, window=window)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        out[label] = [cuda_ms(lambda: A.flash_backward(q, k, v, o, lse, do,
                                                       **kw))
                      for _ in range(reps)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_train_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    res = {"card": card, "backward_ms": backward_spread(3 * args.reps),
           "grads": grad_memory(args.reps)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
