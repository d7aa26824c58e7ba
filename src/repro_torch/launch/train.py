"""Fault-tolerant LM training launcher, the counterpart of the reference's
``launch/train.py``, flag for flag, plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir DIR \
      --max-restarts 3 [--simulate-failure-at 57] [--device cpu]

  * checkpoint/restart: auto-resume from the latest valid checkpoint
    (``checkpoint/manager``, the tree ``{"params", "opt"}`` in the
    reference's format, so either package resumes the other's steps);
  * retry loop: an in-run failure (simulated preemption included) restarts
    the run up to --max-restarts times, resuming from the checkpoint, or
    from the seed's initial state when none was written yet;
  * deterministic data: the synthetic stream is keyed by step, so a
    restarted run replays exactly the batches it would have seen;
  * straggler watchdog: steps slower than ``factor x`` the running median
    are flagged.

An encoder-decoder (whisper-small) raises ``ValueError`` at once: the
synthetic stream makes no audio frames, so the reference's launcher
cannot train it either (it fails inside its step).

``--device`` defaults to the card and raises where there is none; the CPU
runs only when named.  The step runs under ``make_host_mesh()``, as the
reference's does: (data=n, model=1) over the process group's ranks (a
world of one when none is running), so an MoE arch takes the reference's
``e_par`` combine and its groups.  The params come from ``models/base.init_params`` on ``prng_key(--seed)``,
the reference's initial weights for the same seed, bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import prng
from repro_torch.core.explorer import resolve_device
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import base as MB
from repro_torch.train import step as TS


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0):
        self.factor = factor
        self.times = []
        self.flagged = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < 8:
            return False
        med = float(np.median(self.times[-64:]))
        if dt > self.factor * med:
            self.flagged += 1
            return True
        return False


def run_once(args, start_step: int, params, opt_state, ckpt: CheckpointManager,
             stream: SyntheticStream, train_step, history: list,
             device) -> int:
    """Train from start_step; returns the step reached.  Raises to trigger
    the launcher's restart path."""
    watchdog = StragglerWatchdog()
    step = start_step
    while step < args.steps:
        toks, labels = stream.batch(step)
        batch = {"tokens": torch.from_numpy(toks).to(device, torch.long),
                 "labels": torch.from_numpy(labels).to(device, torch.long)}
        t0 = time.time()
        if args.simulate_failure_at is not None and step == args.simulate_failure_at:
            args.simulate_failure_at = None       # fail only once
            raise RuntimeError("simulated node failure (preemption)")
        params, opt_state, metrics = train_step(params, opt_state, batch)
        dt = time.time() - t0
        slow = watchdog.record(dt)
        step += 1
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss, "dt": dt})
            print(f"[train] step={step} loss={loss:.4f} dt={dt*1e3:.0f}ms"
                  + (" STRAGGLER" if slow else ""), flush=True)
        if step % args.ckpt_every == 0 or step == args.steps:
            ckpt.save(step, {"params": params, "opt": opt_state},
                      extra={"step": step})
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    m = configs.get_reduced(args.arch) if args.reduced else configs.get_arch(args.arch)
    if m.enc_segments is not None:
        raise ValueError(
            f"{args.arch} is an encoder-decoder: its train step needs "
            f"batch['frames'], which SyntheticStream does not make (the "
            f"reference's launcher cannot train it either)")
    device = resolve_device(args.device)
    mesh = make_host_mesh(device=device)
    train_step_fn, optim = TS.make_train_step(m, lr=args.lr, remat=False,
                                              mesh=mesh)

    def initial_state():
        params = MB.init_params(prng.prng_key(torch.tensor(args.seed)), m,
                                device)
        return params, optim.init(params)

    params, opt_state = initial_state()
    ckpt = CheckpointManager(args.ckpt_dir)
    stream = SyntheticStream(DataConfig(vocab=m.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))

    history: list = []
    restarts = 0
    while True:
        start = ckpt.latest_step() or 0
        if start:
            state = ckpt.restore(start, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"[launcher] resumed from checkpoint step={start}", flush=True)
        elif restarts:
            # the failed run updated the params in place: start over
            params, opt_state = initial_state()
        try:
            step = run_once(args, start, params, opt_state, ckpt, stream,
                            train_step_fn, history, device)
            break
        except Exception as e:
            restarts += 1
            print(f"[launcher] run failed ({e}); restart {restarts}/"
                  f"{args.max_restarts}", flush=True)
            if restarts > args.max_restarts:
                raise
    print(f"[launcher] done at step={step} after {restarts} restart(s)")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
