"""A cell's driver at a size a CPU test holds: the cell's own files with
narrower and shallower G and D and fewer rows, on the CPU (the port's
plain versions stand in for its kernels there)."""
from __future__ import annotations

import copy
import importlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from perfbench.lib import harness  # noqa: E402


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def make(workload: str, seed: int = 5, layers: int = 2, neurons: int = 64,
         batch: int = 64, tasks: int = 32):
    """(driver module, Run) of a cell cut to a CPU test's size."""
    b = bench()
    cell = harness.find(b["workloads"], workload, "workload")
    config = copy.deepcopy(harness.load_json(
        ROOT / harness.find(b["configs"], cell["config"], "config")["file"]))
    config["gan"].update(g_hidden_layers=layers, d_hidden_layers=layers,
                         g_neurons=neurons, d_neurons=neurons,
                         batch_size=batch)
    traffic = harness.load_json(harness.BENCH / "traffic"
                                / f"{cell['traffic']}.json")
    traffic.update(dataset_rows=16 * batch, tasks_per_call=tasks,
                   pool_batches=4, warmup_calls=1, check_calls=3)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    return driver, harness.Run(cell, config, traffic, seed,
                               torch.device("cpu"), ROOT)


def correct(checks) -> bool:
    return bool(checks) and all(c.ok for c in checks)
