"""Beyond-paper example on the PyTorch/CUDA port: GAN-DSE searching the
parallelism design space (pods x dp x tp x microbatch x remat x dtype x
compression) for a target workload, with the reference's TPU-mesh
roofline as the design model; the twin of ``examples/mesh_dse.py``.

  PYTHONPATH=src python examples/mesh_dse_torch.py [--device cpu]

Runs on the card unless given ``--device cpu``.
"""
import argparse
import json

import numpy as np

from repro_torch.core.dse_api import GANDSE
from repro_torch.core.gan import GANConfig
from repro_torch.design_models.tpu_mesh import TpuMeshModel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)

    model = TpuMeshModel()
    cfg = GANConfig(n_net=model.net_space.n_dims, w_critic=0.5).scaled(
        layers=3, neurons=256, batch_size=512, lr=1e-4)
    gandse = GANDSE(model, cfg, device=args.device)
    print(f"training mesh-DSE explorer on {gandse.device}...")
    gandse.train(n_data=8000, iters=8, log_every=4)

    # workload: qwen3-14b-like training job (40L x 5120, seq 4096, batch 256)
    net = model.net_space.indices_from_values(
        np.array([[40., 5120., 3., 4096., 256., 131072.]]))[0]

    # objectives: step_time <= 5 s at <= 150 kW cluster power
    result = gandse.explore(net, 5.0, 150e3)
    print(f"satisfied={result.satisfied} "
          f"step_time={result.selection.latency:.3f}s "
          f"power={result.selection.power/1e3:.1f}kW "
          f"dse_time={result.dse_seconds*1e3:.0f}ms")
    if result.satisfied:
        art = gandse.emit_config(result)
        print(json.dumps(art, indent=1))
        c = art["config"]
        chips = int(c["PODS"] * c["DP"] * c["TP"])
        print(f"-> launch config: {int(c['PODS'])} pod(s) x "
              f"(data={int(c['DP'])}, model={int(c['TP'])}) = {chips} chips, "
              f"microbatch={int(c['MICRO'])}, remat={bool(c['REMAT'])}, "
              f"param_bytes={int(c['BYTES_P'])}, "
              f"dcn_compression={int(c['COMPRESS'])}x")


if __name__ == "__main__":
    main()
