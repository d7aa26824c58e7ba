"""GANDSE's quality on one device: GANDSE's row of the dnnweaver Table 5
(``launch/comparison.py`` at its default reduced scale, seed 0: 8000
rows, 8 epochs of batch 512, 3 x 256, lr 1e-4, threshold 0.2, 200 hard
tasks).  Training starts from ``init_state(0)``, the reference's own
weights for seed 0.

  PYTHONPATH=src python -m repro_torch.launch.quality [--device cpu]

Prints one JSON line: satisfied of 200, mean candidates, the mean loss_g
of each epoch, the training time and the comparison row.  The device
defaults to the card; ``--device cpu`` runs the plain versions of the
kernels.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np

from repro_torch.design_models import DnnWeaverModel
from repro_torch.launch import comparison as C

SEED = 0


def quality_run(device=None) -> Dict[str, object]:
    """GANDSE's comparison row on dnnweaver on `device` (None: the card),
    with its training history by epoch."""
    model, scale = DnnWeaverModel(), C.Scale()
    engine = C.build_methods(model, scale, device)[0]
    ds, tasks = C.shared_data(model, scale, SEED)
    row = C.method_row(engine, ds, tasks, scale, SEED)
    hist = engine.state.history
    iters = 1 + max(r["iter"] for r in hist)
    by_epoch = [float(np.mean([r["loss_g"] for r in hist if r["iter"] == i]))
                for i in range(iters)]
    return dict(device=str(engine.device), train_s=row["train_time_s"],
                steps=len(hist), loss_g_by_epoch=by_epoch,
                n_satisfied=row["n_satisfied"], n_tasks=row["n_tasks"],
                mean_candidates=row["n_candidates"], row=row)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(quality_run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
