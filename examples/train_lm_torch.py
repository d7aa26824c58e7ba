"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-param LM for a
few hundred steps on the synthetic pipeline with checkpointing, under the
host mesh, the twin of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--small]
      [--device cpu]

--small shrinks to the reduced config for a fast demo; the default builds
a ~100M-param qwen3-family model (12L x 768).  Runs on the card unless
given ``--device cpu``; every attention layer's forward and backward runs
the flash kernel there.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import prng
from repro_torch.core.explorer import resolve_device
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import base as MB
from repro_torch.models.builders import decoder_arch
from repro_torch.train import step as TS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.small:
        m = decoder_arch("demo-lm", "dense", 2, 128, 4, 2, 256, 2048,
                         qk_norm=True, tied=True)
    else:
        # ~100M params: 12L x d768 (GQA kv=4) x ff2048, 32k vocab
        m = decoder_arch("demo-lm-100m", "dense", 12, 768, 12, 4, 2048,
                         32768, qk_norm=True, tied=True)

    mesh = make_host_mesh(device=device)
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, device)
    print(f"model {m.name}: {MB.param_count(params)/1e6:.1f}M params on "
          f"{device}")
    step_fn, optim = TS.make_train_step(m, lr=3e-4, remat=False, mesh=mesh)
    opt = optim.init(params)

    stream = SyntheticStream(DataConfig(vocab=m.vocab, seq_len=args.seq,
                                        global_batch=args.batch))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last_n=2)

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        toks, labels = stream.batch(step)
        batch = {"tokens": torch.from_numpy(toks).to(device, torch.long),
                 "labels": torch.from_numpy(labels).to(device, torch.long)}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 20 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            tput = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step={step:4d} loss={loss:.4f} tok/s={tput:,.0f}",
                  flush=True)
        if (step + 1) % 100 == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt})
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"in {time.time()-t0:.0f}s; checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
