"""The perf sweep of one (arch x shape) cell on one H100 or on a mesh of
them: each variant of the step's knobs counted on the ``meta`` device
(``utils/op_cost``) and put on the card's roofline (``utils/roofline``),
one JSONL row a variant.

The port's counterpart of the reference's ``launch/perf.py``, with its
knobs: ``micro`` (gradient accumulation), ``fsdp`` (the params' 'data'
blocks), ``act`` (the residual stream's layout at the remat save points)
and ``remat``, swept in the reference's order.  ``--mesh card`` (the
default) counts the one-card step, where ``fsdp`` and ``act`` change
nothing; ``single`` and ``multi`` count rank 0 of the production meshes
and ``--mesh-shape DxM`` of a (data D, model M) mesh, each inside
``launch/mesh.counting_world`` (``dryrun.counted_mesh``).  No card is
needed.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch stablelm-1.6b \\
      [--shape train_4k] [--batch B] [--seq S] [--reduced] \\
      [--mesh card|single|multi] [--mesh-shape DxM] [--micro 1,2,4] \\
      [--fsdp 0,1] [--act model,seq,none] [--remat 0,1] \\
      [--dtype bf16|float32] [--out results/perf_torch_<arch>.jsonl]

``--batch`` and ``--seq`` override the named shape's, ``--reduced``
takes the arch's reduced config; ``--dtype`` defaults to bf16, as the
reference counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import DTYPES, MESHES, count_case, counted_mesh


def run_variant(m, shape, mesh=None, *, micro: int, remat, fsdp=1,
                act: str = "model", dtype: str = "bf16") -> dict:
    """One variant's row: the reference's fields from the counted case
    (``bytes_per_device`` the peak of live bytes), ``trace_s`` in place of
    ``compile_s``, the collectives' calls and bytes by kind; on a `mesh`,
    ``bytes_by_part`` (``build_case``); `dtype` a key of
    ``dryrun.DTYPES``."""
    rec = dict(micro=micro, fsdp=fsdp, act=act, remat=remat, dtype=dtype)
    try:
        c = count_case(m, shape, mesh, microbatches=micro, remat=bool(remat),
                       dtype=DTYPES[dtype], fsdp=bool(fsdp), act_shard=act)
        rl, t = c["roofline"], c["counted"]
        rec.update(
            status="ok",
            bytes_per_device=int(t["peak_bytes"]),
            t_compute_s=rl.t_compute, t_memory_s=rl.t_memory,
            t_collective_s=rl.t_collective, t_bound=rl.t_bound,
            bottleneck=rl.bottleneck, mfu_bound=rl.mfu_bound,
            coll_bytes=rl.coll_bytes, flops=rl.flops, hbm_bytes=rl.hbm_bytes,
            flops_by_unit=t["flops_by_unit"], n_coll=int(t["n_coll"]),
            collectives={k: v for k, v in t.items() if k.startswith("coll_")},
            trace_s=round(c["t_trace_s"], 1),
        )
        if mesh is not None:
            rec.update(rank=c["case"].rank,
                       bytes_by_part=c["case"].bytes_by_part)
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {str(e)[:300]}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", choices=["card", *MESHES], default="card")
    ap.add_argument("--mesh-shape", default=None,
                    help="a (data, model) mesh, e.g. 32x8; overrides --mesh")
    ap.add_argument("--micro", default="1")
    ap.add_argument("--fsdp", default="1")
    ap.add_argument("--act", default="model")
    ap.add_argument("--remat", default="1")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", choices=list(DTYPES), default="bf16",
                    help="the structs' dtype (bf16 as the reference "
                         "counts; float32 as the card's LM paths run)")
    args = ap.parse_args(argv)

    m = (configs.get_reduced if args.reduced else configs.get_arch)(args.arch)
    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        b, s = args.batch or shape.global_batch, args.seq or shape.seq_len
        shape = dataclasses.replace(shape, name=f"{shape.kind}_{b}x{s}",
                                    global_batch=b, seq_len=s)
    out = args.out or (f"results/perf_torch_{configs.canonical(args.arch)}_"
                       f"{shape.name}.jsonl")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    grid = itertools.product([int(x) for x in args.micro.split(",")],
                             [int(x) for x in args.fsdp.split(",")],
                             args.act.split(","),
                             [int(x) for x in args.remat.split(",")])
    n_fail = 0
    with open(out, "a") as f, counted_mesh(args.mesh,
                                           args.mesh_shape) as (name, mesh):
        for micro, fsdp, act, remat in grid:
            rec = run_variant(m, shape, mesh, micro=micro, remat=remat,
                              fsdp=fsdp, act=act, dtype=args.dtype)
            rec.update(arch=args.arch, shape=shape.name, mesh=name)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            knobs = f"micro={micro} remat={remat} fsdp={fsdp} act={act}"
            if rec["status"] == "ok":
                print(f"[perf] {knobs}: "
                      f"t_bound={rec['t_bound']:.4f}s ({rec['bottleneck']}) "
                      f"mfu<={rec['mfu_bound']:.3f} "
                      f"mem={rec['bytes_per_device'] / 1e9:.1f}GB "
                      f"coll={rec['coll_bytes'] / 1e9:.2f}GB "
                      f"n_coll={rec['n_coll']}", flush=True)
            else:
                n_fail += 1
                print(f"[perf] {knobs}: FAIL {rec['error']}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
