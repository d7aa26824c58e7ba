"""One run of one cell: find the cell's configuration, traffic mix, driver
and metric readers by the names in ``BENCHMARK.json``, set up, measure,
check, and print the result line.

A driver module (``perfbench/drivers/<traffic["driver"]>.py``) has
``setup(run) -> state`` (everything up to the window, warm-up included),
``window(state, seconds, tracer) -> Window`` and ``check(state, window)
-> [Check]``, which frees the program's state before the reference runs;
each check is printed with its limit on standard error.
A per-layer metric's reader (``perfbench/metrics/<name>.py``) has
``read(tracer, window) -> float or None``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

#: top-level module names that may not be loaded when a run ends
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BENCH = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a measured window gave: end-to-end values by metric name, what
    was attempted and failed, and what the readers need (counts and the
    work the shapes need)."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """A cell's inputs to its driver."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    root: Path


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cache_dirs(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    cache = root / "perfbench" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def import_reference() -> None:
    """Load the whole reference first: it must not bring in the program."""
    for mod in ("perfbench.reference.gan", "perfbench.reference.select",
                "perfbench.reference.oracles"):
        importlib.import_module(mod)
    if any(m.split(".")[0] == "repro_torch" for m in sys.modules):
        raise RuntimeError("the reference loaded the program (repro_torch)")


def report_builds() -> None:
    """The program's kernel libraries this run built or loaded, and the
    seconds each took (the first run of a checkout builds them)."""
    build = sys.modules.get("repro_torch.kernels.build")
    for name, info in sorted(getattr(build, "build_info", {}).items()):
        how = "built" if info.get("log") else "loaded"
        print(f"kernel library {name}: {how} in {info['seconds']:.2f} s",
              file=sys.stderr)


def run(root: Path, args, t_start: float) -> int:
    """One run of the cell ``args.workload``; the process's exit code."""
    bench = load_json(root / "BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")
    config = load_json(root / find(bench["configs"], cell["config"],
                                   "config")["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        print(f"the program is not here: {src / 'repro_torch'}",
              file=sys.stderr)
        return 2
    cache_dirs(root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import_reference()
    sys.path.insert(0, str(src))
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    device = torch.device("cuda", 0)
    r = Run(cell, config, traffic, int(args.seed), device, root)
    state = driver.setup(r)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    report_builds()

    tracer, seconds = None, float(args.seconds)
    if args.trace:
        from perfbench.lib.trace import Tracer
        tracer = Tracer(device)
        # reading the trace takes longer than tracing it: a traced run
        # traces the first `trace_seconds` of its window
        seconds = min(seconds, float(traffic["trace_seconds"]))
    win = driver.window(state, seconds, tracer)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    peak = torch.cuda.max_memory_allocated(device)
    checks = driver.check(state, win)
    del state
    correct = bool(checks) and all(c.ok for c in checks)

    e2e = [m for m in bench["end_to_end"] if applies(m, cell["name"], [])]
    reported = [m["name"] for m in e2e]
    metrics: Dict[str, dict] = {}
    if not args.trace:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else win.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not applies(m, cell["name"], reported):
                continue
            value: Optional[float] = load_reader(m["name"])(tracer, win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if tracer is not None:
        device_info["busy_s"] = tracer.busy_s
        device_info["window_s"] = tracer.window_s
    line = {"correct": correct, "attempted": win.attempted,
            "failed": win.failed, "metrics": metrics, "device": device_info}
    if tracer is not None:
        line["breakdown"] = tracer.breakdown()
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
