"""Dry-run of every (architecture x input shape) cell on one H100 or on
the production meshes of them: each cell's step run once on the ``meta``
device under ``utils/op_cost``'s counter, its roofline on the card
(``utils/roofline``), and whether its peak of live bytes fits the card.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell on TPU meshes.  ``--mesh card`` (the
default) counts the one-card step (``chips = 1``).  ``single`` counts
one rank of the (data 16, model 16) mesh, ``multi`` one of the (pod 2,
data 16, model 16) mesh and ``both`` the two, as the reference's
default: each cell inside ``launch/mesh.counting_world``, a fake process
group of 256 or 512 ranks in this process, rank 0's sharded step on its
blocks (``train/step.build_case(mesh=)``) with its collectives counted
by kind, and each input's per-device bytes from its specs
(``bytes_by_part``).  The collective term reads NVLink's rate, though a
256-card mesh spans 32 nodes: it is a floor.  No card is needed: meta
tensors carry shapes and no memory, so every cell runs on any host, the
33B-param archs included.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch mixtral-8x7b ...] [--shape train_4k ...] [--micro N] \\
      [--mesh card|single|multi|both] [--dtype bf16|float32] \\
      [--out results/dryrun_torch.jsonl]

``--dtype`` is the params', batches' and KV caches' dtype: bf16 by
default, the reference's (its structs' default); float32 is the dtype
the card's LM paths run.  The recurrent states stay float32 either way.

It exits 1 when a cell fails: a failure here is a bug in the port.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import time
import traceback
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, Shape, applicable
from repro_torch.configs.whisper_small import DECODER_TRAIN_LEN
from repro_torch.launch import mesh as LM
from repro_torch.models import base as MB
from repro_torch.optim import tree_leaves
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS
from repro_torch.utils import op_cost
from repro_torch.utils import roofline as RL

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3 (81,079 MiB; ``chip_smoke.py`` checks it on the card)
CARD_BYTES = 85_017_493_504


def _named_leaves(tree, name: str = ""):
    """(the key of the dict holding it, leaf) over a param tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, name)
    else:
        yield name, tree


def active_param_fraction_flops(m, p_struct) -> float:
    """Active (per-token) params: MoE expert tensors count top_k/E.  The
    reference's rule, copied: any ``w_gate`` / ``w_up`` / ``w_down`` of 3
    or more dims takes its dim -3 for E, which for a dense FFN stacked
    over repeats is the repeats."""
    total = 0.0
    for name, leaf in _named_leaves(p_struct):
        n = float(leaf.numel())
        if name in ("w_gate", "w_up", "w_down") and leaf.dim() >= 3:
            e = leaf.shape[-3]
            # find top_k from the arch (uniform across segments)
            top_k = 2
            for seg in m.segments:
                for spec in seg.pattern:
                    if spec.cfg.n_experts:
                        top_k = spec.cfg.top_k
            n *= top_k / e
        total += n
    # embedding lookup is not a matmul; subtract the embed table once
    embed = float(p_struct["embed"]["table"].numel())
    return max(total - embed, 1.0)


def model_flops_for(m, shape: Shape, p_struct) -> float:
    n_active = active_param_fraction_flops(m, p_struct)
    if m.enc_segments is not None:
        # enc-dec: encoder params see seq_len frames, decoder params see
        # the decoder context
        n_enc = float(sum(leaf.numel()
                          for leaf in tree_leaves(p_struct["encoder"])))
        n_dec = max(n_active - n_enc, 1.0)
        dec_toks = shape.global_batch * min(DECODER_TRAIN_LEN, shape.seq_len)
        enc_toks = shape.global_batch * shape.seq_len
        if shape.kind == "train":
            return (RL.model_flops_train(n_enc, enc_toks)
                    + RL.model_flops_train(n_dec, dec_toks))
        if shape.kind == "prefill":
            return (RL.model_flops_forward(n_enc, enc_toks)
                    + RL.model_flops_forward(n_dec, dec_toks))
        return RL.model_flops_forward(n_dec, shape.global_batch)
    if shape.kind == "train":
        return RL.model_flops_train(n_active, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return RL.model_flops_forward(n_active, shape.global_batch * shape.seq_len)
    return RL.model_flops_forward(n_active, shape.global_batch)  # decode: 1 tok


# grad-accumulation defaults for the train_4k cells, the reference's
TRAIN_MICROBATCHES = {
    "mixtral-8x7b": 8, "phi3.5-moe-42b-a6.6b": 8, "deepseek-coder-33b": 4,
    "qwen3-14b": 2, "qwen2-vl-7b": 2, "gemma3-1b": 2,
    "xlstm-1.3b": 4, "hymba-1.5b": 8, "stablelm-1.6b": 1,
}


#: ``--dtype``'s choices: bf16, the reference's dry-run's (its structs'
#: default), and float32, the dtype the card's LM paths run
DTYPES = {"bf16": torch.bfloat16, "float32": torch.float32}


#: ``--mesh``'s production meshes: (the record's name, multi_pod)
MESHES = {"single": ("single_pod_16x16", False),
          "multi": ("multi_pod_2x16x16", True)}


def count_case(m, shape: Shape, mesh=None, *, microbatches: int = 1,
               remat: bool = True, dtype=torch.bfloat16, fsdp: bool = True,
               act_shard: str = "model") -> dict:
    """Build the cell's case in `dtype` (on `mesh`: this rank's, see
    ``build_case``), run it once under the counter: the case, its totals,
    its roofline terms over the mesh's chips and the trace's seconds."""
    t0 = time.perf_counter()
    case = TS.build_case(m, shape, mesh, dtype=dtype,
                         microbatches=microbatches, remat=remat, fsdp=fsdp,
                         act_shard=act_shard)
    counted = op_cost.analyze(case.fn, *case.args)
    full = case.args[0] if case.mesh is None else TS.param_structs(m, dtype)
    chips = int(np.prod(list((case.mesh or {}).values())))
    rl = RL.from_counted(case.name, counted, chips,
                         model_flops=model_flops_for(m, shape, full))
    return dict(case=case, counted=counted, roofline=rl,
                n_params=MB.param_count(full),
                t_trace_s=time.perf_counter() - t0)


def run_cell(arch: Union[str, MB.ModelCfg], shape: Union[str, Shape],
             verbose: bool = True, microbatches: int = 0,
             dtype: str = "bf16", mesh=None, mesh_name: str = "") -> dict:
    """One cell's record, the reference's fields: ``status``, ``flops``,
    ``hbm_bytes``, ``coll_bytes``, ``model_flops``, the ``row()`` terms;
    ``bytes_per_device`` the peak of live bytes, ``arg_bytes`` the
    step's inputs, ``fits`` whether the peak is at most ``CARD_BYTES``;
    ``dtype`` the structs' (a key of ``DTYPES``).  `arch` and `shape` are
    names or a ModelCfg and a Shape.  On `mesh` (named `mesh_name`, a
    mesh of a running world) the record is the counted rank's, with
    ``mesh``, ``chips`` the world's size, ``rank`` and ``bytes_by_part``
    (each input's per-device bytes from its specs, ``build_case``)."""
    m = configs.get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": m.name, "shape": shape.name, "chips": 1, "dtype": dtype}
    if mesh is not None:
        rec.update(mesh=mesh_name, chips=int(np.prod(
            list(SH.mesh_sizes(mesh).values()))))
    if not applicable(m, shape):
        rec["status"] = "skipped"
        rec["reason"] = m.notes
        return rec
    if not microbatches:
        microbatches = (TRAIN_MICROBATCHES.get(m.name, 1)
                        if shape.kind == "train" else 1)
    rec["microbatches"] = microbatches
    try:
        c = count_case(m, shape, mesh, microbatches=microbatches,
                       dtype=DTYPES[dtype])
        t, rl = c["counted"], c["roofline"]
        rec.update(
            status="ok",
            t_trace_s=round(c["t_trace_s"], 1),
            bytes_per_device=int(t["peak_bytes"]),
            temp_bytes=int(t["peak_bytes"] - t["arg_bytes"]),
            arg_bytes=int(t["arg_bytes"]),
            fits=t["peak_bytes"] <= CARD_BYTES,
            n_params=c["n_params"],
            flops=rl.flops, hbm_bytes=rl.hbm_bytes, coll_bytes=rl.coll_bytes,
            flops_by_unit=t["flops_by_unit"], model_flops=rl.model_flops,
            **{k: v for k, v in rl.row().items() if k != "case"},
        )
        rec["collectives"] = {k: v for k, v in t.items()
                              if k.startswith("coll")}
        if mesh is not None:
            rec.update(rank=c["case"].rank,
                       bytes_by_part=c["case"].bytes_by_part,
                       n_coll=int(t["n_coll"]))
    except Exception as e:  # a failure here is a bug in the port
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            traceback.print_exc()
    return rec


@contextlib.contextmanager
def counted_mesh(key: str = "card", mesh_shape: Optional[str] = None):
    """(the records' mesh name, the mesh): one card ("card", None), the
    production mesh ``MESHES[key]``, or a (data D, model M) mesh of
    `mesh_shape` "DxM" (named so), the last two inside a
    ``counting_world`` of their size, whose rank 0 this process is."""
    if mesh_shape:
        d, mm = (int(x) for x in mesh_shape.split("x"))
        shape, axes, name = (d, mm), ("data", "model"), mesh_shape
    elif key == "card":
        yield "card", None
        return
    else:
        name, multi = MESHES[key]
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
    with LM.counting_world(int(np.prod(shape))):
        yield name, LM.make_mesh(shape, axes, device="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=configs.list_archs())
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--micro", type=int, default=0,
                    help="override grad-accum microbatches (train cells)")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bf16",
                    help="the params' and batches' dtype (bf16, as the "
                         "reference counts; float32, as the card's LM "
                         "paths run)")
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card",
                    help="one H100 (card), or rank 0 of the (16, 16) "
                         "(single) or (2, 16, 16) (multi) mesh of them, "
                         "or both meshes")
    args = ap.parse_args(argv)
    meshes = ["card"] if args.mesh == "card" else [
        k for k in MESHES if args.mesh in (k, "both")]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    t_all = time.perf_counter()
    with open(args.out, "a") as f:
        for arch in args.arch:
            for shape, key in itertools.product(args.shape, meshes):
                with counted_mesh(key) as (name, mesh):
                    rec = run_cell(arch, shape, microbatches=args.micro,
                                   dtype=args.dtype, mesh=mesh,
                                   mesh_name=name)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                status = rec["status"]
                n_fail += status == "fail"
                if status == "ok":
                    extra = (f" t_compute={rec['t_compute_s']:.4f}s"
                             f" t_memory={rec['t_memory_s']:.4f}s"
                             f" bottleneck={rec['bottleneck']}"
                             f" mfu_bound={rec['mfu_bound']}"
                             f" GB={rec['bytes_per_device'] / 1e9:.1f}"
                             f" fits={rec['fits']}"
                             f" trace={rec['t_trace_s']}s")
                    if key != "card":
                        extra += (f" coll={rec['coll_bytes'] / 1e9:.2f}GB"
                                  f" n_coll={rec['n_coll']}")
                else:
                    extra = " " + rec.get("error", rec.get("reason", ""))
                where = "" if key == "card" else f" {rec['mesh']:18s}"
                print(f"[dryrun] {arch:22s} {shape:12s}{where} {status:7s}"
                      f"{extra}", flush=True)
    print(f"[dryrun] {time.perf_counter() - t_all:.1f} s in all", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
