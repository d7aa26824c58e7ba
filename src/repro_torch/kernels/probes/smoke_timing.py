"""Where ``chip_smoke.py``'s time goes, on one H100.  A probe, not part of
the package:

    python3 src/repro_torch/kernels/probes/smoke_timing.py [--out FILE]

Runs ``chip_smoke.main()`` as it stands, with every function of
``chip_smoke`` (and ``forward``, ``decode_step``, ``loss_and_grads``, the
plain sLSTM loops) timed inclusive of its callees on the host clock, by
call path, and writes the paths that took a second or more to FILE
(default ``chiprun_out/smoke_timing.txt``), longest first.  Before it,
``profile_step``'s raw-event count of a small workload is printed beside
``key_averages``'s count of the same workload.  The script's own output,
and its exit code, are as without the probe; the wrappers add a few
microseconds a call.  Needs the card.
"""
from __future__ import annotations

import argparse
import functools
import os
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[4]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

STACK: list = []
SPENT: dict = {}                     # call path: [calls, seconds]


def timed(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        STACK.append(name)
        path = " > ".join(STACK)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            row = SPENT.setdefault(path, [0, 0.0])
            row[0] += 1
            row[1] += time.perf_counter() - t0
            STACK.pop()
    return wrapper


def wrap_all() -> None:
    for name, obj in list(vars(cs).items()):
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == cs.__name__ and name != "main":
            setattr(cs, name, timed(name, obj))
    for mod, names in ((cs.MB, ("forward", "decode_step")),
                       (cs.TS, ("loss_and_grads",)),
                       (cs.ref, ("slstm_scan", "slstm_scan_bwd"))):
        for n in names:
            short = mod.__name__.rsplit(".", 1)[-1]
            setattr(mod, n, timed(f"{short}.{n}", getattr(mod, n)))


def profile_agrees() -> None:
    """``profile_step``'s launches by name against ``key_averages``'s on
    50 matmuls, relus and adds of 512 x 512."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch = cs.torch
    x = torch.randn(512, 512, device="cuda")

    def work():
        y = x
        for _ in range(50):
            y = torch.relu(y @ x) + 1
        return y

    work()
    raw = cs.profile_step(work, ())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    averaged = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
    print(f"profile_step: {raw['device_launches']} launches "
          f"{[k[:2] for k in raw['top_kernels']]}; key_averages: "
          f"{sum(averaged.values())} {sorted(averaged.items())}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/smoke_timing.txt")
    args = ap.parse_args()
    sys.argv = [str(ROOT / "chip_smoke.py")]
    if cs.torch.cuda.is_available():
        profile_agrees()
    wrap_all()
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = cs.main()
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(f"chip_smoke.main() returned {rc} after "
                    f"{time.perf_counter() - t0:.1f} s\n")
            for path, (n, s) in sorted(SPENT.items(), key=lambda kv:
                                       -kv[1][1]):
                if s >= 1.0:
                    f.write(f"{s:8.1f} s {n:6d}x  {path}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
