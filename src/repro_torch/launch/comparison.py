"""Table 5 on one device: every DSE method in one shared experiment, the
port's twin of the reference's ``experiments/run_comparison.py``.

GANDSE and the learned baselines train on ONE shared dataset per design
model; the same DSE task set runs through every method via the
``DSEMethod`` protocol; the rows report satisfied counts, improvement
ratio, DSE time and candidate counts side by side (paper Table 5, Fig. 5).

Fairness rules, as the reference's:

- every method explores the same tasks with the same seed;
- RandomSearch (the sanity floor, not in the paper's table) is
  budget-matched to GANDSE: its sample count is GANDSE's mean candidate
  count, so "GANDSE beats random search" is an equal-budget claim;
- every method serves the batch through its batched ``explore_tasks``
  route, after one warm-up pass.

  PYTHONPATH=src python -m repro_torch.launch.comparison [--quick]
      [--models dnnweaver im2col tpu_mesh] [--seed 0] [--device cpu]

The device defaults to the card; ``--device cpu`` runs the plain versions
of the kernels.  Writes ``comparison_<model>.json`` per design model and
the combined ``comparison.json`` into ``$REPRO_RESULTS`` (default
``results/``).  Exits 1 unless GANDSE satisfies at least as many tasks as
RandomSearch on every model.  Reduced scale by default (3 x 256 GAN, the
baselines at their class defaults but LargeMLP at 6 x 256).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.baselines import (LargeMLP, PolicyGradientDRL, RandomSearch,
                                   SimulatedAnnealing)
from repro_torch.core.dse_api import GANDSE, DSEMethod, summarize
from repro_torch.core.explorer import ExplorerConfig, resolve_device
from repro_torch.core.gan import GANConfig
from repro_torch.dataset.generator import (Dataset, DSETask, generate_dataset,
                                           generate_tasks)
from repro_torch.design_models import DnnWeaverModel, Im2colModel, TpuMeshModel

MODELS = {
    "dnnweaver": DnnWeaverModel,
    "im2col": Im2colModel,
    "tpu_mesh": TpuMeshModel,
}

#: per-design-model exploration threshold (higher-entropy spaces need a
#: sharper cut or the candidate budget explodes) and training length
MODEL_PRESETS = {
    "dnnweaver": dict(threshold=0.2, iters_mult=1, data_mult=1),
    "im2col": dict(threshold=0.3, iters_mult=1, data_mult=1),
    "tpu_mesh": dict(threshold=0.4, iters_mult=6, data_mult=2),
}

RESULTS_DIR = os.environ.get("REPRO_RESULTS", "results")


@dataclasses.dataclass(frozen=True)
class Scale:
    """Experiment scale (env-overridable, as the reference's)."""

    n_data: int = int(os.environ.get("REPRO_GAN_DATA", 8000))
    n_tasks: int = int(os.environ.get("REPRO_GAN_TASKS", 200))
    iters: int = int(os.environ.get("REPRO_GAN_ITERS", 8))
    layers: int = int(os.environ.get("REPRO_GAN_LAYERS", 3))
    neurons: int = int(os.environ.get("REPRO_GAN_NEURONS", 256))
    lr: float = float(os.environ.get("REPRO_GAN_LR", 1e-4))
    w_critic: float = 0.5
    #: Pareto-adjacent objectives (§7.4 "hard" setting), the training
    #: distribution itself
    slack: Tuple[float, float] = (1.0, 1.0)

    @staticmethod
    def quick() -> "Scale":
        """Smoke scale: fewer tasks; the nets and the dataset stay at the
        reduced scale."""
        return Scale(n_tasks=50)


def gan_config(model, scale: Scale) -> GANConfig:
    """The comparison's GAN: scale.layers x scale.neurons, batch 512."""
    return GANConfig(n_net=model.net_space.n_dims,
                     w_critic=scale.w_critic).scaled(
        layers=scale.layers, neurons=scale.neurons, lr=scale.lr,
        batch_size=512)


def build_methods(model, scale: Scale, device=None) -> List[DSEMethod]:
    """Every method of the comparison, untrained, on `device` (None: the
    card).  RandomSearch comes last so its budget can be matched to
    GANDSE's measured candidate count."""
    xcfg = ExplorerConfig(
        prob_threshold=MODEL_PRESETS[model.name]["threshold"])
    return [
        GANDSE(model, gan_config(model, scale), xcfg, device=device),
        # parameter-matched to the GAN's G + D: twice the layers at the
        # same width, and G's exploration threshold
        LargeMLP(model, hidden_layers=2 * scale.layers,
                 neurons=scale.neurons, lr=scale.lr, explorer_cfg=xcfg,
                 device=device),
        PolicyGradientDRL(model, device=device),
        SimulatedAnnealing(model, device=device),
        RandomSearch(model, device=device),
    ]


def shared_data(model, scale: Scale, seed: int) -> Tuple[Dataset, DSETask]:
    """The one dataset every method trains on and the one task set every
    method explores."""
    preset = MODEL_PRESETS[model.name]
    ds = generate_dataset(model, scale.n_data * preset["data_mult"],
                          seed=seed)
    tasks = generate_tasks(model, scale.n_tasks, seed=seed + 1,
                           slack=scale.slack)
    return ds, tasks


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def method_row(method: DSEMethod, ds: Dataset, tasks: DSETask, scale: Scale,
               seed: int) -> Dict:
    """Train one method on the shared dataset, explore the shared tasks
    twice (the first pass warm-up), and summarize the second pass."""
    iters = scale.iters * MODEL_PRESETS[method.model.name]["iters_mult"]
    # one DRL iteration is one rollout batch, not one dataset epoch
    if method.method_name == "DRL":
        iters *= 4
    _sync(method.device)
    t0 = time.time()
    method.train(n_data=scale.n_data, iters=iters, seed=seed, ds=ds)
    _sync(method.device)
    train_s = time.time() - t0
    method.explore_tasks(tasks, seed=seed + 2)
    row = summarize(method.explore_tasks(tasks, seed=seed + 2))
    row.update(method=method.method_name, train_time_s=round(train_s, 2),
               satisfied_rate=row["n_satisfied"] / max(row["n_tasks"], 1))
    return row


def run_comparison(model_name: str, scale: Optional[Scale] = None,
                   seed: int = 0, results_dir: str = RESULTS_DIR,
                   device=None, done: Optional[Dict[str, Dict]] = None
                   ) -> Dict:
    """Train every method on one shared dataset, explore one shared task
    set, and write Table 5's rows for `model_name`.  `done` maps a method
    name to a row already computed at this scale and seed (it is not run
    again)."""
    scale = scale or Scale()
    device = resolve_device(device)
    model = MODELS[model_name]()
    ds, tasks = shared_data(model, scale, seed)
    rows = []
    gandse_budget = None
    for method in build_methods(model, scale, device):
        if method.method_name == "RandomSearch" and gandse_budget:
            method.n_samples = gandse_budget        # equal candidate budget
        row = (done or {}).get(method.method_name)
        if row is None:
            row = method_row(method, ds, tasks, scale, seed)
        rows.append(row)
        if method.method_name == "GANDSE":
            gandse_budget = max(1, int(round(row["n_candidates"])))
        print(f"[comparison:{model_name}] {row['method']:12s} "
              f"sat={row['n_satisfied']}/{row['n_tasks']} "
              f"impr={row['improvement_ratio']:.4f} "
              f"dse={row['dse_time_s'] * 1e3:.2f}ms "
              f"cand={row['n_candidates']:.1f} "
              f"train={row['train_time_s']:.1f}s", flush=True)
    report = {"model": model_name, "scale": dataclasses.asdict(scale),
              "seed": seed, "device": str(device), "rows": rows}
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, f"comparison_{model_name}.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    return report


def gandse_beats_random_search(report: Dict) -> bool:
    """The reproduction's acceptance bar: GANDSE satisfies at least as
    many tasks as budget-matched random search."""
    by = {r["method"]: r for r in report["rows"]}
    return by["GANDSE"]["satisfied_rate"] >= by["RandomSearch"]["satisfied_rate"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=sorted(MODELS),
                    choices=sorted(MODELS))
    ap.add_argument("--quick", action="store_true",
                    help="smoke scale: fewer tasks (see Scale.quick)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    scale = Scale.quick() if args.quick else Scale()

    combined = {name: run_comparison(name, scale, seed=args.seed,
                                     results_dir=RESULTS_DIR,
                                     device=args.device)
                for name in args.models}
    with open(os.path.join(RESULTS_DIR, "comparison.json"), "w") as f:
        json.dump(combined, f, indent=1)
    ok = True
    for name, report in combined.items():
        by = {r["method"]: r for r in report["rows"]}
        g, r = by["GANDSE"], by["RandomSearch"]
        good = gandse_beats_random_search(report)
        ok = ok and good
        print(f"[comparison:{name}] GANDSE {g['satisfied_rate']:.2f} vs "
              f"RandomSearch {r['satisfied_rate']:.2f} "
              f"(budget {r['n_candidates']:.0f}) -> "
              f"{'ok' if good else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
