"""GANDSE's quality at the reference's reduced comparison scale, on one
device: the GANDSE row of ``experiments/run_comparison.py``'s dnnweaver
comparison (8000 rows from seed 0, 8 epochs of batch 512, 3 x 256, lr
1e-4, w_critic 0.5, threshold 0.2, 200 tasks from seed 1 with slack (1,
1), explored from seed 2).  Training starts from ``init_state(0)``, the
reference's own weights for seed 0.

  PYTHONPATH=src python -m repro_torch.launch.quality [--device cpu]

Prints one JSON line: satisfied of 200, mean candidates, the mean loss_g
of each epoch and the training time.  The device defaults to the card;
``--device cpu`` runs the plain versions of the kernels.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import dse_api as dse
from repro_torch.core import explorer as ex
from repro_torch.core import gan as G
from repro_torch.dataset import generator as gen_mod
from repro_torch.design_models import DnnWeaverModel

N_DATA, ITERS, N_TASKS, SEED = 8000, 8, 200, 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gan_config(model) -> G.GANConfig:
    """The comparison's reduced GAN: 3 x 256, lr 1e-4, batch 512."""
    return G.GANConfig(n_net=model.net_space.n_dims, w_critic=0.5).scaled(
        layers=3, neurons=256, lr=1e-4, batch_size=512)


def quality_run(device=None) -> Dict[str, object]:
    """Train GANDSE on dnnweaver at the comparison's scale on `device`
    (None: the card) and explore its 200 hard tasks."""
    model = DnnWeaverModel()
    cfg = gan_config(model)
    engine = dse.GANDSE(model, cfg, ex.ExplorerConfig(prob_threshold=0.2),
                        device=device)
    ds = gen_mod.generate_dataset(model, N_DATA, seed=SEED)
    tasks = gen_mod.generate_tasks(model, N_TASKS, seed=SEED + 1,
                                   slack=(1.0, 1.0))
    _sync(engine.device)
    t0 = time.perf_counter()
    st = engine.train(n_data=N_DATA, iters=ITERS, seed=SEED, ds=ds)
    _sync(engine.device)
    train_s = time.perf_counter() - t0
    engine.explore_tasks(tasks, seed=SEED + 2)                 # warm
    summary = dse.summarize(engine.explore_tasks(tasks, seed=SEED + 2))
    by_epoch = [float(np.mean([r["loss_g"] for r in st.history
                               if r["iter"] == i])) for i in range(ITERS)]
    return dict(device=str(engine.device), train_s=train_s,
                steps=len(st.history), loss_g_by_epoch=by_epoch,
                n_satisfied=summary["n_satisfied"], n_tasks=N_TASKS,
                mean_candidates=summary["n_candidates"])


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(quality_run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
