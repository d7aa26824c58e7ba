"""DSE serving launcher: micro-batching loop over a request queue.

  PYTHONPATH=src python -m repro_torch.launch.dse_serve --model im2col \
      --requests 64 --max-batch 16 [--concurrent] [--device cpu]

The DSE twin of `repro_torch.launch.serve` (the LM continuous-batching
launcher): requests are admitted into a `DSEServer`, coalesced into
pow2-bucketed micro-batches, dispatched through the engine's batched
exploration path (G through the whole-MLP kernel on the card), and
answered with per-request `DSEResult`s.  A random-init generator is
attached by default — the reference's own initial weights for the seed
(``init_generator(fold_in(PRNGKey(seed), 3))``): serving throughput does
not depend on training quality; pass --train-iters to train first and
report real satisfied counts.

``--concurrent`` serves the same workload through the production front
end (`repro_torch.serve.frontend.ServeFrontend`): non-blocking submits
with futures, continuous batching overlapping host-side batch formation
with the dispatch in flight, and admission control — pair with
--max-queue (bounded queues, shed-at-the-door) and --deadline-s
(per-request deadlines) to see load shedding in the report.

The device defaults to the card; ``--device cpu`` runs the plain versions
of the kernels.  The batched select route is chosen by
``core/fused_select.select_from_probs`` (no route flags); ``--fused off``
is the explicit opt-out to the plain versions on the card.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core.dse_api import GANDSE, summarize
from repro_torch.core.explorer import ExplorerConfig
from repro_torch.dataset.generator import (DSETask, generate_dataset,
                                           generate_tasks)
from repro_torch.design_models import DnnWeaverModel, Im2colModel, TpuMeshModel
from repro_torch.serve import (DSEResponse, DSEServer, FrontendConfig,
                               ServeConfig, ServeFrontend)

MODELS = {m.name: m for m in (DnnWeaverModel, Im2colModel, TpuMeshModel)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="im2col", choices=sorted(MODELS))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--data", type=int, default=512)
    ap.add_argument("--train-iters", type=int, default=0,
                    help="0 = attach a random-init G (throughput only)")
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--max-candidates", type=int, default=2048)
    ap.add_argument("--cache", type=int, default=4096,
                    help="LRU result-cache capacity; 0 disables")
    ap.add_argument("--repeat-frac", type=float, default=0.25,
                    help="fraction of requests re-submitted verbatim "
                         "(exercises the cache/coalescing path)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", choices=("auto", "on", "off"), default="auto",
                    help="kernel route: auto and on are the same (the "
                         "kernels on the card; the CPU runs the plain "
                         "versions), off = the plain versions on the card "
                         "too (an explicit opt-out); the reference's "
                         "choices, kept for parity")
    ap.add_argument("--concurrent", action="store_true",
                    help="serve through the threaded production front end "
                         "(futures + continuous batching) instead of the "
                         "sync submit/drain pump")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="per-model admission bound; submissions past it "
                         "are REJECTED with a retry-after hint (0 = "
                         "unbounded)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline for --concurrent; expired "
                         "requests are shed before dispatch (0 = none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def build_engine(args: argparse.Namespace) -> GANDSE:
    """The served engine: G at --layers x --neurons (batch 64), trained
    for --train-iters epochs or the random init of ``fold_in(PRNGKey(
    seed), 3)``, on --device (None: the card)."""
    model = MODELS[args.model]()
    gan_cfg = G.GANConfig(n_net=model.net_space.n_dims).scaled(
        layers=args.layers, neurons=args.neurons, batch_size=64)
    engine = GANDSE(model, gan_cfg,
                    ExplorerConfig(prob_threshold=args.threshold,
                                   max_candidates=args.max_candidates),
                    device=args.device)
    if args.train_iters > 0:
        engine.train(args.data, args.train_iters, seed=args.seed)
    else:
        ds = generate_dataset(model, args.data, seed=args.seed)
        key = prng.fold_in(prng.prng_key(torch.tensor(args.seed)), 3)
        engine.attach(ds, G.init_generator(key, gan_cfg, model.space,
                                           engine.device))
    return engine


def submit_rows(fe: ServeFrontend, model_name: str, tasks: DSETask,
                rows: Sequence[int], seed: int,
                timeout_s: Optional[float] = None) -> list:
    """One front-end submit per task row (row i with seed + i)."""
    return [fe.submit(model_name, tasks.net_idx[i], tasks.lat_obj[i],
                      tasks.pow_obj[i], seed=seed + i, timeout_s=timeout_s)
            for i in rows]


def serve_concurrent(fe: ServeFrontend, model_name: str, tasks: DSETask,
                     n: int, n_rep: int, seed: int,
                     timeout_s: Optional[float] = None
                     ) -> List[DSEResponse]:
    """The workload through a running front end: the n requests, their
    first n_rep again while in flight (coalesced, or cache hits by
    timing), then those n_rep once more after they are served (cache
    hits)."""
    futs = submit_rows(fe, model_name, tasks, range(n), seed, timeout_s) \
        + submit_rows(fe, model_name, tasks, range(n_rep), seed, timeout_s)
    responses = [f.result(timeout=300) for f in futs]
    responses += [f.result(timeout=300) for f in
                  submit_rows(fe, model_name, tasks, range(n_rep), seed,
                              timeout_s)]
    return responses


def serve_sync(srv: DSEServer, model_name: str, tasks: DSETask, n: int,
               n_rep: int, seed: int) -> List[DSEResponse]:
    """The same workload through the sync pump: duplicates of still-queued
    requests coalesce, verbatim repeats of served ones hit the cache."""
    def push(rows):
        for i in rows:
            srv.submit(model_name, tasks.net_idx[i], tasks.lat_obj[i],
                       tasks.pow_obj[i], seed=seed + i)

    push(range(n))
    push(range(n_rep))
    responses = srv.drain()
    push(range(n_rep))
    return responses + srv.drain()


def serve(argv=None) -> Dict:
    """Run the launcher; returns its report: the engine, server, tasks,
    responses (in answer order), timed seconds and the front end's
    latency percentiles (concurrent mode)."""
    args = parser().parse_args(argv)
    use_fused = False if args.fused == "off" else None
    engine = build_engine(args)
    model = engine.model
    srv = DSEServer(ServeConfig(max_batch=args.max_batch,
                                cache_capacity=args.cache,
                                max_queue=args.max_queue,
                                use_fused=use_fused))
    srv.register(engine)

    n = args.requests
    tasks = generate_tasks(model, n, seed=args.seed + 2)
    n_rep = int(n * args.repeat_frac)
    # warm-up: a full micro-batch at the pow2(max_batch) bucket the timed
    # dispatches use (off-range seeds, cache cleared, so no timed request
    # is answered from warm-up work)
    for i in range(min(args.max_batch, n)):
        srv.submit(model.name, tasks.net_idx[i % n], tasks.lat_obj[i % n],
                   tasks.pow_obj[i % n], seed=args.seed - 1_000_000 - i)
    srv.drain()
    srv.cache.clear()

    latency = None
    t0 = time.perf_counter()
    if args.concurrent:
        timeout_s = args.deadline_s if args.deadline_s > 0 else None
        with ServeFrontend(srv, FrontendConfig()) as fe:
            responses = serve_concurrent(fe, model.name, tasks, n, n_rep,
                                         args.seed, timeout_s)
            latency = fe.metrics()["frontend"]["latency"]
    else:
        responses = serve_sync(srv, model.name, tasks, n, n_rep, args.seed)
    seconds = time.perf_counter() - t0
    return dict(args=args, engine=engine, server=srv, tasks=tasks,
                responses=responses, n_total=n + 2 * n_rep,
                seconds=seconds, latency=latency)


def main(argv=None) -> int:
    rep = serve(argv)
    args, srv, responses = rep["args"], rep["server"], rep["responses"]
    s = srv.summary()
    name = rep["engine"].model.name
    served = [r.result for r in responses if r.ok]
    stats = summarize(served)
    fe_line = ""
    if rep["latency"] is not None:
        m = rep["latency"]
        fe_line = (f"p50={m['p50_ms']:.1f}ms p99={m['p99_ms']:.1f}ms "
                   f"rejected={s['rejected']} "
                   f"degraded={s['degraded_entered']} ")
    print(f"[dse_serve] model={name} "
          f"mode={'concurrent' if args.concurrent else 'sync'} "
          f"kernels={s['kernels']['backend'][name]}:"
          f"{'fused' if s['kernels']['fused'][name] else 'plain'} "
          f"requests={len(responses)}/{rep['n_total']} served={len(served)} "
          f"batches={s['batches']} mean_batch={s['mean_batch_size']:.1f} "
          f"coalesced={s['coalesced']} cache_hits={s['cache']['hits']} "
          f"satisfied={stats['n_satisfied']} {fe_line}"
          f"req/s={len(responses) / max(rep['seconds'], 1e-9):.0f}")
    assert len(responses) == rep["n_total"]   # every request terminated
    assert s["pending"] == 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
