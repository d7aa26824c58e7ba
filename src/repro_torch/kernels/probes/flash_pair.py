"""Times the flash-attention kernel of this tree beside another revision's,
in one process on one H100: gemma3-1b's global and local layers (2 x 4
heads, kv 1, 4096 tokens, D = 256, causal; the local layer with window
1024) in float32 and bf16, and one gemma3-1b prefill of 2 x 4096 tokens
(float32, full width, random weights from seed 0).  A probe, not part of
the package:

    python3 src/repro_torch/kernels/probes/flash_pair.py --parent DIR

``--parent`` names an unpacked checkout of the other revision (``git
archive``); its ``csrc/flash_attention.cu`` is built beside this tree's
and both are called through this tree's wrapper (the C interface is the
same), in turns: parent, tree, tree, parent.  Each time is the median of
single calls on CUDA events and, as ``*_device_ms``, the kernel's device
time under torch.profiler; the prefill is timed on the host clock ended
by a synchronize and profiled once with each kernel.  Each layer's
outputs are also held to each other and to the plain version.  Prints
one JSON line per measurement.  Needs the card; no CPU route.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from forward_pair import cuda_ms, device_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

#: (B, H, Hkv, S, D, window): gemma3-1b's layers at the prefill's length
LAYERS = {"global": (2, 4, 1, 4096, 256, None),
          "local w1024": (2, 4, 1, 4096, 256, 1024)}
def layer_inputs(name: str, dtype: torch.dtype, seed: int = 13):
    b, h, hkv, s, d, window = LAYERS[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device="cuda")
               .to(dtype) for n in (h, hkv, hkv))
    return q, k, v, window


def use(lib) -> None:
    """Route FA.flash_attention through `lib` (a loaded flash library)."""
    FA.load_library = lambda: lib


def time_layers(libs: dict, order: list) -> None:
    """Each layer in each dtype through each library, in `order`."""
    for name in LAYERS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, window = layer_inputs(name, dtype)
            call = lambda: FA.flash_attention(q, k, v, window=window)
            want = ref.flash_attention(q, k, v, window=window)
            outs, rows = {}, {label: [] for label in libs}
            for label in order:
                use(libs[label])
                outs.setdefault(label, call())
                rows[label].append((cuda_ms(call), device_ms(call)))
            base = outs[order[0]].float()
            for label, ts in rows.items():
                got = outs[label].float()
                print(json.dumps({
                    "layer": name, "dtype": str(dtype).split(".")[-1],
                    "kernel": label,
                    "ms": [t[0] for t in ts], "device_ms": [t[1] for t in ts],
                    "max_abs_err_vs_plain": float(
                        (got - want.float()).abs().max()),
                    "max_abs_diff_vs_first": float((got - base).abs().max()),
                }), flush=True)


def time_prefill(libs: dict, order: list) -> None:
    """One gemma3-1b prefill (2 x 4096, float32) through each library, in
    `order`; host ms of each call, then one profile per library."""
    from repro_torch import configs
    from repro_torch.models import base as MB
    from repro_torch.train import step as TS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m = configs.get_arch("gemma3-1b")
    from repro_torch.core import prng
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cuda")
    toks = torch.randint(0, m.vocab, (2, 4096), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    step = TS.make_prefill_step(m)
    times = {label: [] for label in libs}
    for label in order:
        use(libs[label])
        step(params, {"tokens": toks})                      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
        times[label].append(1e3 * (time.perf_counter() - t0))
    for label, lib in libs.items():
        use(lib)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(params, {"tokens": toks})
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        flash = [e for e in dev if "flash_fwd_kernel" in e.key]
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        print(json.dumps({
            "prefill": "gemma3-1b 2x4096 float32", "kernel": label,
            "ms": times[label],
            "device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "flash_device_ms": sum(e.self_device_time_total
                                   for e in flash) / 1e3,
            "flash_launches": sum(e.count for e in flash),
            "top_kernels": [[e.key[:90], e.count,
                             e.self_device_time_total / 1e3] for e in top],
        }), flush=True)


def load_copy(text: str, stem: str):
    """Build `text` as kernels/build/<stem>.cu and load it."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"{stem}.cu"
    path.write_text(text)
    return build.load(path, FA._bind)


def pair(parent: Path) -> None:
    old = (parent / "src/repro_torch/kernels/csrc/flash_attention.cu")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f_old = pool.submit(load_copy, old.read_text(), "flash_parent")
        f_new = pool.submit(FA.load_library)
        libs = {"parent": f_old.result(), "tree": f_new.result()}
    order = ["parent", "tree", "tree", "parent"]
    time_layers(libs, order)
    time_prefill(libs, order)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="unpacked checkout of "
                    "the revision to time beside this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_pair: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    pair(Path(args.parent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
