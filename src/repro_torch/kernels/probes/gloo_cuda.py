"""Which c10d collectives gloo takes on CUDA tensors, with two ranks on
one card.  A probe, not part of the package:

    python3 src/repro_torch/kernels/probes/gloo_cuda.py [--out JSON]

Starts two ranks of itself (``--rank R --dir DIR``), both on ``cuda:0``,
joined by gloo over a ``FileStore``, on a (1, 2) ('data', 'model')
``DeviceMesh``; each tries ``all_reduce`` (SUM and MAX), ``all_gather``,
``all_gather_into_tensor``, ``broadcast`` and ``all_gather_object`` on the
'model' subgroup with CUDA tensors, checks each result, and times the
ones that work at 4 MiB and 64 MiB (host clock around a synchronised
call, the median of 5).  Prints one JSON object a rank and the card's
name and power limit, and writes them to ``--out`` where it is given.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

RANKS = 2


def _timed(fn, reps: int = 5) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def rank_main(rank: int, tmp: str) -> int:
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), RANKS), rank=rank, world_size=RANKS)
    mesh = DeviceMesh("cuda", torch.arange(RANKS).reshape(1, RANKS),
                      mesh_dim_names=("data", "model"))
    group = mesh.get_group("model")
    dev = torch.device("cuda:0")
    res = {"rank": rank, "local_rank_model": mesh.get_local_rank("model"),
           "torch": torch.__version__, "cuda": torch.version.cuda}

    def attempt(name, fn, check):
        try:
            got = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if check(got) else "wrong"
        except Exception as e:  # noqa: BLE001 - the probe records it
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"

    x = torch.full((4,), float(rank + 1), device=dev)

    def ar(op):
        t = x.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    attempt("all_reduce_sum", lambda: ar(dist.ReduceOp.SUM),
            lambda t: bool((t == 3.0).all()))
    attempt("all_reduce_max", lambda: ar(dist.ReduceOp.MAX),
            lambda t: bool((t == 2.0).all()))

    def ag():
        out = [torch.empty_like(x) for _ in range(RANKS)]
        dist.all_gather(out, x, group=group)
        return torch.cat(out)

    attempt("all_gather", ag, lambda t: t.tolist() == [1.0] * 4 + [2.0] * 4)

    def agt():
        out = torch.empty(RANKS * 4, device=dev)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    attempt("all_gather_into_tensor", agt,
            lambda t: t.tolist() == [1.0] * 4 + [2.0] * 4)

    def bc():
        t = x.clone()
        dist.broadcast(t, src=0, group=group)
        return t

    attempt("broadcast", bc, lambda t: bool((t == 1.0).all()))

    def ago():
        out = [None] * RANKS
        dist.all_gather_object(out, {"r": rank}, group=group)
        return out

    attempt("all_gather_object", ago, lambda o: [d["r"] for d in o] == [0, 1])

    times = {}
    for mib in (4, 64):
        n = mib * (1 << 20) // 4
        t = torch.ones(n, device=dev)
        if res["all_reduce_sum"] == "ok":
            times[f"all_reduce {mib} MiB ms"] = _timed(
                lambda: dist.all_reduce(t, group=group))
        if res["all_gather"] == "ok":
            outs = [torch.empty_like(t) for _ in range(RANKS)]
            times[f"all_gather {mib} MiB ms"] = _timed(
                lambda: dist.all_gather(outs, t, group=group))
    res["times"] = times
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
        print("gloo_cuda: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="gloo_cuda_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--dir", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(RANKS)]
        logs = [p.communicate(timeout=300)[0] for p in procs]
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
