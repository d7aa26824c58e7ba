"""The sLSTM across a 'model' axis: the replicated design the port runs
beside the floor of a head-a-rank design, with two ranks on one card.  A
probe, not part of the package:

    python3 src/repro_torch/kernels/probes/slstm_model_axis.py [--out JSON]

Starts two ranks of itself (``--rank R --dir DIR``), both on ``cuda:0``,
joined by gloo over a ``FileStore`` on a (1, 2) ('data', 'model') mesh.
On xlstm-1.3b's sLSTM layer at full width (D 2048, 4 heads of 512; seed
0) and a 1 x 2048 input (``normal · 0.1``, seed 1) each rank times, the
median of 3 after a warm call, host clock between synchronizes:

- ``replicated``: ``nn/xlstm.slstm_apply`` on the rank's blocks under the
  mesh, the design the port runs (``wx`` and ``rh`` gathered, the whole
  recurrence in one ``slstm_scan_f32`` launch on every rank, ``wo`` row
  parallel), its forward and its forward + backward, held to the world
  of one's output (``slstm_apply`` on the whole layer, no mesh), also
  timed;
- ``head_a_rank_floor``: what a rank holding 2 of the 4 heads would pay
  before any arithmetic: the reference's recurrent product sends head j
  to gate j of every channel, so every step needs every rank's h_{t-1}:
  S = 2048 all-gathers of a rank's (1, 1024) block of h, one a step (and
  a launch a step, since a grid barrier does not span processes).

Prints one JSON object and the card's name and power limit, and writes
the JSON to ``--out`` where it is given.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

RANKS = 2
S = 2048


def _timed(fn, reps: int = 3) -> float:
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def rank_main(rank: int, tmp: str) -> int:
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.launch import mesh as LM
    from repro_torch.nn import xlstm as X
    from repro_torch.train import shardings as SH

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    LM.init_process_group("gloo", dist.FileStore(os.path.join(tmp, "store"),
                                                 RANKS), rank, RANKS)
    mesh = LM.make_host_mesh((1, RANKS), device="cuda:0")
    cfg = configs.get_arch("xlstm-1.3b").segments[0].pattern[-1].cfg
    d, h = cfg.d_model, cfg.n_heads
    full = X.slstm_init(prng.prng_key(torch.tensor(0)), d, h, "cuda")
    local = SH.shard_params(full, mesh)
    x = 0.1 * torch.randn((1, S, d), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
    res = {"rank": rank, "shape": [1, S, d], "heads": h,
           "local_shapes": {k: list(v.shape) for k, v in local.items()
                            if k != "gn"}}

    def sharded(grad: bool):
        with SH.use_mesh(mesh), torch.set_grad_enabled(grad):
            xi = x.detach().requires_grad_(grad)
            p = {k: (v.detach().requires_grad_(grad)
                     if isinstance(v, torch.Tensor) else v)
                 for k, v in local.items()}
            y, _ = X.slstm_apply(p, xi, h)
            if grad:
                y.square().sum().backward()
            return y

    with torch.no_grad():
        want, _ = X.slstm_apply(full, x, h)
        got = sharded(False)
    res["max_abs_err"] = float((got - want).abs().max())
    res["scale"] = float(want.abs().max())
    sl.slstm_scan.launches = sl.slstm_scan_bwd.launches = 0
    sharded(True)
    res["launches"] = {"slstm_scan_f32": sl.slstm_scan.launches,
                       "slstm_scan_bwd_f32": sl.slstm_scan_bwd.launches}
    dist.barrier()
    if rank == 0:
        with torch.no_grad():
            res["world_of_one_ms"] = _timed(lambda: X.slstm_apply(full, x, h))
    dist.barrier()
    res["replicated_ms"] = _timed(lambda: sharded(False))
    res["replicated_fwd_bwd_ms"] = _timed(lambda: sharded(True))
    group = mesh.get_group("model")
    blk = torch.ones((1, d // RANKS), device="cuda")
    parts = [torch.empty_like(blk) for _ in range(RANKS)]

    def exchange():
        for _ in range(S):
            dist.all_gather(parts, blk, group=group)

    res["head_a_rank_floor_ms"] = _timed(exchange, reps=1)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int)
    ap.add_argument("--dir")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.dir)
    if not torch.cuda.is_available():
        print("slstm_model_axis: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="slstm_axis_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--dir", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(RANKS)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                print(log[-4000:])
                return 1
        out = {"card": card}
        for r in range(RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                out[f"rank {r}"] = json.load(fh)
    print(json.dumps(out, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
