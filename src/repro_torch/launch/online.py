"""Train-while-serve launcher: the online improvement loop on a live server.

  PYTHONPATH=src python -m repro_torch.launch.online --model dnnweaver \
      --waves 6 --wave-size 16 [--generations 3] [--corrupt-step N] \
      [--device cpu]

Hosts one engine behind the production front end (`ServeFrontend`), wires
the `OnlineLoop` trainer onto it (harvest unsatisfied requests -> mine
hard examples -> incremental train -> checkpoint -> lock-disciplined hot
swap), and pushes waves of deliberately hard requests (tight objective
slack) while the trainer improves the generator between waves.  Each wave
uses fresh seeds, so nothing is answered from the cache and the reported
satisfied counts track the *current* generation's quality.  Serving and
training share the device (the card unless ``--device cpu``): G's
forward runs through the whole-MLP kernel, every training step through
the dense kernels.

``--corrupt-step N`` flips payload bytes in generation N's checkpoint
right after it is written (`repro_torch.serve.faults.corrupt_checkpoint`):
the swap's read-back detects the damage and serving falls back to the
previous good generation.  Checkpoints go to --checkpoint-dir, else a new
temporary directory.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core.dse_api import GANDSE
from repro_torch.core.explorer import ExplorerConfig
from repro_torch.dataset.generator import generate_dataset, generate_tasks
from repro_torch.design_models import DnnWeaverModel, Im2colModel, TpuMeshModel
from repro_torch.serve import (DSEServer, FrontendConfig, OnlineConfig,
                               OnlineLoop, ServeConfig, ServeFrontend,
                               corrupt_checkpoint)

MODELS = {m.name: m for m in (DnnWeaverModel, Im2colModel, TpuMeshModel)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="dnnweaver", choices=sorted(MODELS))
    ap.add_argument("--waves", type=int, default=6,
                    help="request waves pushed through the front end")
    ap.add_argument("--wave-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--data", type=int, default=512)
    ap.add_argument("--slack", type=float, default=1.05,
                    help="objective slack upper bound; close to 1.0 makes "
                         "requests hard (Pareto-adjacent objectives)")
    ap.add_argument("--generations", type=int, default=0,
                    help="stop training after N generations (0 = no cap)")
    ap.add_argument("--min-hard", type=int, default=8,
                    help="buffered hard tasks that trigger a generation")
    ap.add_argument("--train-iters", type=int, default=4)
    ap.add_argument("--replay", type=int, default=64)
    ap.add_argument("--keep-last-n", type=int, default=3)
    ap.add_argument("--checkpoint-dir", default="",
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--corrupt-step", type=int, default=-1,
                    help="inject corruption into generation N's checkpoint "
                         "after saving (-1 = never): exercises the "
                         "fall-back-to-previous-generation swap path")
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--max-candidates", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def run(argv=None) -> Dict:
    """Run the launcher; returns its report: per-wave records (satisfied,
    generation, serving step, swaps, fallbacks), the loop's final metrics
    and per-generation timings, the server's summary, wall seconds and
    the checkpoint directory."""
    args = parser().parse_args(argv)
    model = MODELS[args.model]()
    gan_cfg = G.GANConfig(n_net=model.net_space.n_dims).scaled(
        layers=args.layers, neurons=args.neurons, batch_size=64)
    engine = GANDSE(model, gan_cfg,
                    ExplorerConfig(prob_threshold=args.threshold,
                                   max_candidates=args.max_candidates),
                    device=args.device)
    ds = generate_dataset(model, args.data, seed=args.seed)
    key = prng.fold_in(prng.prng_key(torch.tensor(args.seed)), 3)
    engine.attach(ds, G.init_generator(key, gan_cfg, model.space,
                                       engine.device))

    srv = DSEServer(ServeConfig(max_batch=args.max_batch))
    srv.register(engine)

    ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="dse_online_")

    def post_checkpoint(sdir: str) -> None:
        if args.corrupt_step >= 0 and \
                sdir.endswith(f"step_{args.corrupt_step:09d}"):
            corrupt_checkpoint(sdir, seed=args.seed)
            print(f"[online] injected corruption into {sdir}", flush=True)

    ocfg = OnlineConfig(min_hard=args.min_hard,
                        train_iters=args.train_iters,
                        replay_capacity=args.replay,
                        keep_last_n=args.keep_last_n,
                        max_generations=args.generations,
                        seed=args.seed,
                        post_checkpoint=post_checkpoint)

    n = args.wave_size
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    waves = []
    with ServeFrontend(srv, FrontendConfig()) as fe:
        with OnlineLoop(fe, model.name, ckpt_dir, cfg=ocfg) as loop:
            loop.warmup()            # build and warm the training path
            for w in range(args.waves):
                tasks = generate_tasks(model, n, seed=args.seed + 10 + w,
                                       slack=(1.0, args.slack))
                base = int(rng.integers(1 << 20)) * 1000
                futs = [fe.submit(model.name, tasks.net_idx[i],
                                  tasks.lat_obj[i], tasks.pow_obj[i],
                                  seed=base + i) for i in range(n)]
                responses = [f.result(timeout=300) for f in futs]
                sat = sum(1 for r in responses
                          if r.ok and r.result.satisfied)
                m = loop.metrics()
                waves.append(dict(
                    wave=w, satisfied=sat, answered=sum(r.ok
                                                        for r in responses),
                    generation=m["generation"],
                    serving_step=m["serving_step"],
                    buffered=m["buffer"]["size"], swaps=m["swaps"],
                    fallbacks=m["swap_fallbacks"]))
                print(f"[online] wave={w} satisfied={sat}/{n} "
                      f"generation={m['generation']} "
                      f"serving_step={m['serving_step']} "
                      f"buffered={m['buffer']['size']} "
                      f"swaps={m['swaps']} "
                      f"fallbacks={m['swap_fallbacks']}", flush=True)
                # let the trainer catch up between waves so later waves
                # are served by later generations: wait out a generation in
                # flight (its checkpoint and swap included) and one the
                # buffer is due to start
                deadline = time.time() + 120
                while ((loop.training
                        or (len(loop.buffer) >= ocfg.min_hard
                            and not (args.generations > 0
                                     and loop.generation >= args.generations)))
                       and time.time() < deadline):
                    time.sleep(0.05)
        # read after the loop has stopped: no generation is mid-swap
        final = loop.metrics()
        timings = list(loop.timings)
    return dict(args=args, waves=waves, final=final, timings=timings,
                summary=srv.summary(), seconds=time.perf_counter() - t0,
                ckpt_dir=ckpt_dir)


def main(argv=None) -> int:
    rep = run(argv)
    final, s, args = rep["final"], rep["summary"], rep["args"]
    for t in rep["timings"]:
        print(f"[online] generation={t['generation']} "
              f"train_s={t['train_s']:.3f} save_s={t['save_s']:.3f} "
              f"restore_s={t.get('restore_s', float('nan')):.3f} "
              f"bytes={t['bytes']}", flush=True)
    print(f"[online] model={args.model} waves={args.waves} "
          f"satisfied/wave={[w['satisfied'] for w in rep['waves']]} "
          f"generations={final['generations']} swaps={final['swaps']} "
          f"fallbacks={final['swap_fallbacks']} "
          f"errors={final['generation_errors']} "
          f"mined={final['mined_rows']} "
          f"stale_cache_skips={s['stale_cache_skips']} "
          f"invalidations={s['cache']['invalidations']} "
          f"params_gen={s['params_generation']} "
          f"checkpoints={final['checkpoint_steps']} "
          f"wall={rep['seconds']:.1f}s ckpt_dir={rep['ckpt_dir']}")
    assert final["generation_errors"] == 0, final
    assert s["pending"] == 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
