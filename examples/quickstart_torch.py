"""Quickstart on the PyTorch/CUDA port: the four GANDSE phases end to end
on the DnnWeaver template, the twin of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Trains the GAN-based design explorer (reduced scale), then runs a DSE
task — "accelerator for this conv layer with latency <= LO and power
<= PO" — and emits the selected configuration artifact (the stand-in for
the paper's RTL generation phase).  Runs on the card unless given
``--device cpu``.
"""
import argparse
import json

import numpy as np

from repro_torch.core.dse_api import GANDSE, parse_network, summarize
from repro_torch.core.gan import GANConfig
from repro_torch.dataset.generator import generate_tasks
from repro_torch.design_models.dnnweaver import DnnWeaverModel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    # ---- training phase (once per design template) -------------------------
    model = DnnWeaverModel()
    gan_cfg = GANConfig(n_net=model.net_space.n_dims, w_critic=1.0).scaled(
        layers=3, neurons=256, batch_size=512, lr=1e-4)
    gandse = GANDSE(model, gan_cfg, device=args.device)
    print(f"training the design explorer (reduced scale) on "
          f"{gandse.device}...")
    gandse.train(n_data=6000, iters=6, log_every=2)

    # ---- parsing phase ------------------------------------------------------
    net = parse_network(
        {"IC": 64, "OC": 128, "OW": 32, "OH": 32, "KW": 3, "KH": 3}, model)

    # pick achievable objectives: evaluate a random config and relax 1.2x
    rng = np.random.default_rng(0)
    probe = model.space.sample_indices(rng, 64)
    lat, pw = model.evaluate_indices(np.repeat(net[None], 64, 0), probe)
    ok = np.isfinite(lat)
    lo, po = float(np.median(lat[ok]) * 1.2), float(np.median(pw[ok]) * 1.2)
    print(f"objectives: latency <= {lo:.4g}s, power <= {po:.4g}W")

    # ---- exploration phase ---------------------------------------------------
    result = gandse.explore(net, lo, po)
    print(f"satisfied={result.satisfied} "
          f"latency={result.selection.latency:.4g}s "
          f"power={result.selection.power:.4g}W "
          f"improvement_ratio={result.improvement_ratio} "
          f"dse_time={result.dse_seconds*1e3:.0f}ms "
          f"candidates={result.selection.n_candidates}")

    # ---- implementation phase ------------------------------------------------
    if result.satisfied:
        artifact = gandse.emit_config(result)
        print(json.dumps(artifact, indent=1))

    # batch evaluation across random tasks: the first batch is cold (the
    # kernels' first launches), the second warm
    tasks = generate_tasks(model, 50, seed=1)
    print("batch (cold):", summarize(gandse.explore_tasks(tasks)))
    print("batch (warm):", summarize(gandse.explore_tasks(tasks)))


if __name__ == "__main__":
    main()
