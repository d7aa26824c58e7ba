"""Times the forward pair on one H100: the dense forward kernel at a hidden
layer of Algorithm 1 (1024 x 2048 -> 2048), the whole-MLP kernel on
im2col's G (11 x 2048) at 64 and 1024 rows, each beside its library call,
and one Algorithm 1 step (11 x 2048, batch 1024) on the kernels.  A probe,
not part of the package:

    python3 src/repro_torch/kernels/probes/forward_pair.py [--root DIR]
    python3 src/repro_torch/kernels/probes/forward_pair.py --variants

Each time is the median of single calls on CUDA events (the host's work
in the call included) and, as ``*_device_ms``, the kernels' device time
under torch.profiler.  ``--root`` times the package of another checkout (an older revision's, to
compare two revisions in one run on one card: old, new, new, old).
``--variants`` builds variants of ``csrc/mlp_forward.cu`` by substituting
its constants (the K slices: 4, 8 or 16; the 128-row tile at 64 rows; the
split across the grid at 1024 rows in place of the fold) and times each
against the source as it stands, with a row's bits compared where the
slices are the same.  Prints one JSON line per measurement.  Needs the
card; no CPU route.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4))
#: (name, old text, new text) applied to csrc/mlp_forward.cu
VARIANTS = (
    ("slices 16", ("SPLIT_K = 256", "SPLIT_K = 128"),
     ("MAX_SPLITS = 8", "MAX_SPLITS = 16")),
    ("slices 4", ("SPLIT_K = 256", "SPLIT_K = 512"),
     ("MAX_SPLITS = 8", "MAX_SPLITS = 4")),
    ("128-row tile at 64 rows", ("if (g.p <= gemm3::Block<1>::BM)",
                                  "if (g.p <= 0)")),
    ("grid split at 1024 rows", ("if (2 * tiles <= gemm3::NUM_SMS)",
                                 "if (true)")),
)


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of single-call CUDA-event times, after warm-up."""
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


def device_ms(fn, reps: int = 5) -> float:
    """Device time of one call: the kernels' time under torch.profiler
    over `reps` calls, divided by `reps` (no host time in it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / reps


def g_params():
    from repro_torch.core import gan as G
    from repro_torch.core import prng
    from repro_torch.design_models import Im2colModel
    model = Im2colModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = G.init_generator(prng.prng_key(torch.tensor(11)), cfg,
                              model.space, "cuda")
    ws = [p["w"] for p in params["layers"]]
    bs = [torch.randn(p["b"].shape, generator=gen, device="cuda") * 0.1
          for p in params["layers"]]
    x = torch.randn(1024, ws[0].shape[0], generator=gen, device="cuda")
    return x, ws, bs


def chain(x, ws, bs):
    """The library's whole MLP: addmm and relu_ per layer."""
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = torch.addmm(b, h, w)
        if i < len(ws) - 1:
            h = torch.relu_(h)
    return h


def step_ms(reps: int = 5) -> float:
    """Median host time of warm Algorithm 1 steps on the kernels, each
    ended by a synchronize."""
    from repro_torch.core import gan as G
    from repro_torch.core import train as T
    from repro_torch.dataset import generator as gen_mod
    from repro_torch.design_models import Im2colModel
    model = Im2colModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims)
    batch = T.encode_dataset(model, gen_mod.generate_dataset(model, 1024,
                                                             seed=0), "cuda")
    st = T.init_state(model, cfg, 0, "cuda")
    step = T.make_train_step(model, cfg)[2]
    args = (st.g_params, st.d_params, st.g_opt, st.d_opt, batch, st.rng)
    step(*args)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def time_pair(label: str) -> None:
    from repro_torch.kernels import fused_dense as fd
    from repro_torch.kernels import fused_mlp as fm
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(1024, 2048, generator=gen, device="cuda")
    w = torch.randn(2048, 2048, generator=gen, device="cuda") * (1 / 1024) ** .5
    b = torch.randn(2048, generator=gen, device="cuda") * 0.1
    calls = {"dense": lambda: fd.dense_forward(x, w, b, True),
             "dense_library": lambda: torch.relu_(torch.addmm(b, x, w))}
    xg, ws, bs = g_params()
    for m in (64, 1024):
        calls[f"mlp_m{m}"] = lambda m=m: fm.fused_mlp(xg[:m], ws, bs)
        calls[f"mlp_m{m}_library"] = lambda m=m: chain(xg[:m], ws, bs)
    out = {}
    for name, fn in calls.items():
        out[f"{name}_ms"] = cuda_ms(fn)
        out[f"{name}_device_ms"] = device_ms(fn)
    out["step_ms"] = step_ms()
    print(json.dumps({"label": label, **out}), flush=True)


def time_variants() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_mlp as fm
    xg, ws, bs = g_params()
    source = fm.SOURCE.read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"as it stands": fm.load_library()}
    for name, *subs in VARIANTS:
        text = source
        for old, new in subs:
            assert old in text, f"{name}: {old!r} not in {fm.SOURCE.name}"
            text = text.replace(old, new)
        path = build.BUILD_DIR / f"probe_mlp_{len(libs)}.cu"
        path.write_text(text)
        libs[name] = build.load(path, fm._bind)
    base = {}
    for name, lib in libs.items():
        fm.load_library = lambda lib=lib: lib
        row = {}
        for m in (64, 1024):
            y = fm.fused_mlp(xg[:m], ws, bs)
            base.setdefault(m, y)
            row[f"m{m}_ms"] = cuda_ms(lambda: fm.fused_mlp(xg[:m], ws, bs))
            row[f"m{m}_device_ms"] = device_ms(
                lambda: fm.fused_mlp(xg[:m], ws, bs))
            row[f"m{m}_same_bits"] = bool(torch.equal(y, base[m]))
        print(json.dumps({"variant": name, **row}), flush=True)
    row = {}
    for m in (64, 1024):
        row[f"m{m}_ms"] = cuda_ms(lambda: chain(xg[:m], ws, bs))
        row[f"m{m}_device_ms"] = device_ms(lambda: chain(xg[:m], ws, bs))
    print(json.dumps({"variant": "library (addmm chain)", **row}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--variants", action="store_true",
                    help="time variants of the whole-MLP kernel instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("forward_pair: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    if args.variants:
        time_variants()
    else:
        time_pair(os.path.abspath(args.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
