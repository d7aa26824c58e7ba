"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version at the serving path's shapes (both
models' G at 64 rows, im2col's also at 1024), then drives
``GANDSE.attach`` + ``explore_batch`` (64 tasks, generator at the paper's
11 x 2048 width, random weights from a fixed seed) on dnnweaver and im2col
through the kernel, checks the Selections, and breaks one more warm call
down (G against the select, the device's busy share, the top kernels).
Exits non-zero on any
failure, and when no CUDA device is present.  The last line of output is
``{"ok": true, "device": {...}}``; the lines before it are the kernel
table (JSON) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.core import dse_api as dse  # noqa: E402
from repro_torch.core import fused_select as fs  # noqa: E402
from repro_torch.core import gan as G  # noqa: E402
from repro_torch.dataset import generator as gen_mod  # noqa: E402
from repro_torch.design_models import DnnWeaverModel, Im2colModel  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# H100 SXM data-sheet peaks (dense, no sparsity)
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # HBM3
N_TASKS = 64
TOL = 1e-4                  # max|y_k - y_ref| <= TOL * max(1, max|y_ref|)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` single-call times with CUDA events, after warm-up."""
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


def mlp_bound_ms(m: int, ws, bs) -> tuple:
    """Least time for the whole-MLP forward on this card: each input read
    once and the output written once over HBM, against 2*M*K*N float32
    FMA flops (+ the bias adds) at the non-tensor peak."""
    d_in, d_out = ws[0].shape[0], ws[-1].shape[1]
    n_bytes = 4 * (m * d_in + sum(w.numel() for w in ws)
                   + sum(b.numel() for b in bs) + m * d_out)
    flops = sum(2 * m * w.shape[0] * w.shape[1] + m * w.shape[1] for w in ws)
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_kernel() -> dict:
    """Phase 2: the kernel against its plain version at the serving
    path's shapes: each model's G at full width with M = 64 (the main
    path's rows), and im2col's also at M = 1024."""
    rows = {}
    for model, ms in ((Im2colModel(), (N_TASKS, 1024)),
                      (DnnWeaverModel(), (N_TASKS,))):
        cfg = G.GANConfig(n_net=model.net_space.n_dims)
        gen = torch.Generator(device="cuda").manual_seed(11)
        params = G.init_generator(gen, cfg, model.space, "cuda")
        ws = [p["w"] for p in params["layers"]]
        # nonzero biases so the epilogue is exercised
        bs = [torch.randn(p["b"].shape, generator=gen, device="cuda") * 0.1
              for p in params["layers"]]
        for m in ms:
            x = torch.randn(m, ws[0].shape[0], generator=gen, device="cuda")
            rows[model.name, m] = _check_one(f"{model.name} M={m}", x, ws, bs)
    return rows


def _check_one(label: str, x, ws, bs) -> dict:
    m = x.shape[0]
    y_k = fm.fused_mlp(x, ws, bs)
    y_r = ref.fused_mlp(x, ws, bs)
    torch.cuda.synchronize()
    assert y_k.shape == y_r.shape == (m, ws[-1].shape[1]), y_k.shape
    assert bool(torch.isfinite(y_k).all()), "kernel output not finite"
    err = float((y_k - y_r).abs().max())
    scale = max(1.0, float(y_r.abs().max()))
    print(f"kernel check {label}: max_abs_err={err:.3e} "
          f"(limit {TOL * scale:.3e})", flush=True)
    assert err <= TOL * scale, f"kernel disagrees at {label}: {err}"
    # a row's result does not depend on the rows that share the call
    assert torch.equal(fm.fused_mlp(x[5:8].contiguous(), ws, bs), y_k[5:8])

    def library():
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = torch.addmm(b, h, w)
            if i < len(ws) - 1:
                h = torch.relu_(h)
        return h

    bound, bound_by = mlp_bound_ms(m, ws, bs)
    row = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fm.fused_mlp(x, ws, bs)),
        plain_ms=cuda_ms(lambda: ref.fused_mlp(x, ws, bs)),
        library_ms=cuda_ms(library),
        bound_ms=bound, bound_by=bound_by)
    print(f"kernel times {label}: " + json.dumps(row), flush=True)
    return row


def drive_path(model) -> dict:
    """Phase 3: GANDSE.attach + explore_batch on the card, cold then warm."""
    cfg = G.GANConfig(n_net=model.net_space.n_dims)     # 11 x 2048
    ds = gen_mod.generate_dataset(model, 4096, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = G.init_generator(gen, cfg, model.space, "cuda")
    engine = dse.GANDSE(model, cfg)                     # device=None: the card
    assert engine.device.type == "cuda", engine.device
    engine.attach(ds, params)
    tasks = gen_mod.generate_tasks(model, N_TASKS, seed=1)
    t0 = time.perf_counter()
    cold = engine.explore_batch(tasks, seed=0)
    t1 = time.perf_counter()
    warm = engine.explore_batch(tasks, seed=0)
    t2 = time.perf_counter()
    return dict(engine=engine, tasks=tasks, cold=cold, warm=warm,
                cold_s=t1 - t0, warm_s=t2 - t1)


def check_path(name: str, run: dict) -> dict:
    """The serving path's results: finite probs of the right shape, the
    Selections' metrics from the float64 oracle, the candidate cap, and
    the same Selections from the CPU route given the same probs."""
    engine, tasks = run["engine"], run["tasks"]
    model, xcfg = engine.model, engine.explorer_cfg
    cold, warm = run["cold"], run["warm"]
    assert len(warm) == N_TASKS
    for a, b in zip(cold, warm):
        assert _same(a.selection, b.selection), "cold and warm runs differ"
    for i, r in enumerate(warm):
        sel = r.selection
        assert sel.n_candidates <= xcfg.max_candidates, sel.n_candidates
        if sel.cfg_idx is None:
            continue
        lat, pw = model.evaluate_indices(tasks.net_idx[i][None],
                                         sel.cfg_idx[None])
        assert float(lat[0]) == sel.latency and float(pw[0]) == sel.power
    probs = engine._explorer.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj,
        seed=dse.row_seeds(0, N_TASKS))
    assert probs.shape == (N_TASKS, model.space.onehot_width), probs.shape
    assert bool(torch.isfinite(probs).all()), "G probs not finite"
    sums = [float(g.sum(-1).sub(1).abs().max())
            for g in model.space.split_groups(probs)]
    assert max(sums) < 1e-5, f"per-group probs do not sum to 1: {sums}"

    def select(p):
        return fs.fused_select_batch(
            model, tasks.net_idx, p, xcfg.prob_threshold,
            xcfg.max_candidates, tasks.lat_obj, tasks.pow_obj,
            tile=xcfg.select_tile)

    on_card, on_cpu = select(probs), select(probs.cpu())
    for a, b, r in zip(on_card, on_cpu, warm):
        assert _same(a, b), "card and CPU select differ on the same probs"
        assert _same(a, r.selection), "explore_batch differs from its probs"
    n_sat = sum(r.satisfied for r in warm)
    out = dict(cold_ms_per_task=1e3 * run["cold_s"] / N_TASKS,
               warm_ms_per_task=1e3 * run["warm_s"] / N_TASKS,
               n_satisfied=n_sat,
               mean_candidates=float(np.mean([r.selection.n_candidates
                                              for r in warm])))
    print(f"explore_batch {name}: " + json.dumps(out), flush=True)
    return out


def profile_path(name: str, run: dict) -> dict:
    """Where a warm ``explore_batch`` spends its time: G and the select
    timed apart on the host clock (each ended by a synchronize), and one
    more call under ``torch.profiler`` for the device's busy time, its
    kernel launches, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine, tasks = run["engine"], run["tasks"]
    xcfg, seeds = engine.explorer_cfg, dse.row_seeds(0, N_TASKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = engine._explorer.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj, seed=seeds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fs.fused_select_batch(engine.model, tasks.net_idx, probs,
                          xcfg.prob_threshold, xcfg.max_candidates,
                          tasks.lat_obj, tasks.pow_obj, tile=xcfg.select_tile)
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        engine.explore_batch(tasks, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(g_ms=1e3 * (t1 - t0), select_ms=1e3 * (t2 - t1),
               profiled_wall_ms=1e3 * wall, device_busy_ms=busy_us / 1e3,
               device_idle_share=1.0 - busy_us / 1e3 / (1e3 * wall),
               device_launches=sum(e.count for e in dev),
               top_kernels=[[e.key[:60], e.count,
                             e.self_device_time_total / 1e3] for e in top])
    print(f"profile {name}: " + json.dumps(out), flush=True)
    return out


def _same(a, b) -> bool:
    if (a.cfg_idx is None) != (b.cfg_idx is None):
        return False
    if a.cfg_idx is not None and not np.array_equal(a.cfg_idx, b.cfg_idx):
        return False
    return (a.latency, a.power, a.satisfied, a.n_candidates) == \
        (b.latency, b.power, b.satisfied, b.n_candidates)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the measurements to this JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # phase 1: build
    fm.load_library()
    print(f"built {fm.build_info['path']} in "
          f"{fm.build_info['seconds']:.1f} s", flush=True)
    print(fm.build_info["log"].strip(), flush=True)

    # phase 2: kernel against its plain version
    kern = check_kernel()

    # phase 3: the serving path, counts zeroed just before it
    fm.fused_mlp.launches = 0
    runs = {"dnnweaver": drive_path(DnnWeaverModel()),
            "im2col": drive_path(Im2colModel())}
    launches = fm.fused_mlp.launches
    print(f"fused_mlp launches on the serving path: {launches}", flush=True)
    assert launches > 0, "the serving path never launched the kernel"
    paths = {name: check_path(name, run) for name, run in runs.items()}
    for name, run in runs.items():
        paths[name]["profile"] = profile_path(name, run)

    row = kern["im2col", N_TASKS]
    table = {"kernels": [{
        "name": "mlp_forward_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlp_forward.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:273",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "im2col_m1024": kern["im2col", 1024],
        "dnnweaver_m64": kern["dnnweaver", N_TASKS],
    }]}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": table["kernels"],
                       "paths": paths, "build_s": fm.build_info["seconds"]},
                      fh, indent=1)
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
