"""Times the sLSTM kernel of this tree beside another source of it, in one
process on one H100, at xlstm-1.3b's layer shapes: the prefill's (2, 4096,
2048, H 4) and the Engine's decode step (4, 1, 2048, H 4).  A probe, not
part of the package:

    python3 src/repro_torch/kernels/probes/slstm_pair.py --other FILE

``--other`` names another revision's ``slstm_scan.cu`` (for example from
``git show REV:src/repro_torch/kernels/csrc/slstm_scan.cu``, or an
unpacked checkout's); it is built beside this tree's and both are called
through this tree's wrapper (the C interface is the same), in turns:
other, tree, tree, other.  Each time is the median of single calls on
CUDA events and, as ``device_ms``, the kernel's device time under
torch.profiler.  The inputs are random at a layer's magnitudes (wx
N(0, 1), rh at the init's (1/dh)^0.5, the init's bias; the prefill from
the initial state, the decode step from a random one), from a fixed
seed.  Each kernel's outputs are held to the plain loop and to each
other's (bits).  Prints one JSON line per shape.  Needs the card; no CPU
route.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from forward_pair import cuda_ms, device_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import slstm_scan as SL  # noqa: E402

#: (B, S, D, H): xlstm-1.3b's prefill layer and its Engine's decode step
SHAPES = {"prefill": (2, 4096, 2048, 4), "engine": (4, 1, 2048, 4)}


def inputs(b: int, s: int, d: int, h: int, seed: int = 31):
    dh = d // h
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                       device="cuda")
    bias = torch.zeros(4 * d, device="cuda")
    bias[2 * d:3 * d] = 3.0
    if s == 1:
        state = (randn(b, d), randn(b, d).abs() + 1e-6, randn(b, d),
                 0.1 * randn(b, d))
    else:
        state = (torch.zeros(b, d, device="cuda"),
                 torch.full((b, d), 1e-6, device="cuda"),
                 torch.full((b, d), -1e30, device="cuda"),
                 torch.zeros(b, d, device="cuda"))
    return randn(b, s, 4 * d), randn(h, dh, 4 * dh) * dh ** -0.5, bias, state


def load_copy(text: str, stem: str):
    """Build `text` as kernels/build/<stem>.cu and load it."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"{stem}.cu"
    path.write_text(text)
    return build.load(path, SL._bind)


def pair(other: Path) -> None:
    libs = {"other": load_copy(other.read_text(), "slstm_scan_other"),
            "tree": SL.load_library()}
    order = ["other", "tree", "tree", "other"]
    for label, shape in SHAPES.items():
        args = inputs(*shape)
        want = ref.slstm_scan(*args)
        outs, rows = {}, {k: [] for k in libs}
        for k in order:
            SL.load_library = lambda lib=libs[k]: lib
            call = lambda: SL.slstm_scan(*args)  # noqa: E731
            outs.setdefault(k, call())
            rows[k].append((cuda_ms(call, reps=10), device_ms(call, reps=3)))
        flat = {k: (o[0], *o[1]) for k, o in outs.items()}
        for k, ts in rows.items():
            print(json.dumps({
                "shape": label, "b_s_d_h": list(shape), "kernel": k,
                "ms": [t[0] for t in ts], "device_ms": [t[1] for t in ts],
                "max_abs_err_vs_plain": max(
                    float((g - w).abs().max())
                    for g, w in zip(flat[k], (want[0], *want[1]))),
                "same_bits_as_other": all(
                    torch.equal(a, b) for a, b in zip(flat[k],
                                                      flat["other"])),
            }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another revision's "
                    "slstm_scan.cu to time beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("slstm_pair: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    pair(Path(args.other))
    return 0


if __name__ == "__main__":
    sys.exit(main())
