"""Batched exploration: a closed loop of ``GANDSE.explore_batch`` calls,
each over one batch of tasks (a design-automation service exploring the
layers of many networks at once).

Set-up attaches a G drawn on the card (``GANDSE.attach``), makes a pool
of task batches, and warms the call up.  G's weights, the pool and the
dataset's normalizers come from the traffic's fixed seeds, so every run
explores the same candidate sets; ``--seed`` sets the order in which the
calls take the pool's batches and every task's noise seed.  A traced run
drives the call's two halves itself, G (``generator_probs_device`` of the
explorer that ``attach`` returns) then the select
(``fused_select.select_from_probs``), each in a span of its own.

The check takes calls drawn from the seed among those the window made
and holds every task's answer to the reference's own exploration: G in
float64 on the same inputs and noise, then the reference's select, where
a probability within the traffic's ``tie`` of a decision's edge lets
either side of it count.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import time
from typing import List

import numpy as np
import torch

from perfbench.drivers import common
from perfbench.lib import counts, inputs
from perfbench.lib.harness import Check, Run, Window
from perfbench.reference import gan as ref_gan
from perfbench.reference import select as ref_select
from perfbench.reference.oracles import Oracle


@dataclasses.dataclass
class Sample:
    tasks: inputs.Tasks
    seeds: np.ndarray
    answers: List[tuple]        # the program's, as reference answers


@dataclasses.dataclass
class State:
    run: Run
    oracle: Oracle
    rows: inputs.DatasetRows
    g_dims: List[int]
    pool: List[inputs.Tasks]
    engine: object = None
    explorer: object = None
    program_pool: list = None


def as_answer(sel) -> tuple:
    cfg = None if sel.cfg_idx is None else tuple(int(v) for v in sel.cfg_idx)
    return (cfg, float(sel.latency), float(sel.power), bool(sel.satisfied),
            int(sel.n_candidates))


def setup(run: Run) -> State:
    from repro_torch.core.dse_api import GANDSE
    from repro_torch.core.explorer import ExplorerConfig
    from repro_torch.dataset.generator import DSETask

    cfg, tr = run.config, run.traffic
    oracle = Oracle(cfg["design_model"])
    model = common.program_model(cfg)
    rows = inputs.dataset(oracle, tr["dataset_rows"], tr["pool_seed"])
    g_dims, _ = common.gan_dims(cfg, oracle)
    t = tr["tasks_per_call"]
    pool = inputs.tasks(oracle, t * tr["pool_batches"], tr["pool_seed"], t,
                        tr["slack"])
    order = inputs.rng(run.seed, inputs.ORDER).permutation(len(pool))
    st = State(run, oracle, rows, g_dims, [pool[i] for i in order])
    st.program_pool = [DSETask(p.net_idx, p.lat_obj, p.pow_obj)
                       for p in st.pool]
    x = cfg["explorer"]
    st.engine = GANDSE(model, common.gan_config(cfg, oracle),
                       ExplorerConfig(prob_threshold=x["prob_threshold"],
                                      max_candidates=x["max_candidates"],
                                      noise_samples=x["noise_samples"]),
                       device=run.device)
    g = inputs.weights(g_dims, tr["g_seed"], inputs.WEIGHTS_G, run.device)
    st.explorer = st.engine.attach(common.program_dataset(model, rows),
                                   common.params_tree(g))
    for i in range(tr["warmup_calls"]):
        call(st, -1 - i, None)
    return st


def call(st: State, c: int, tracer):
    """One exploring call: the program's Selections, task by task."""
    from repro_torch.core.fused_select import select_from_probs
    t = st.run.traffic["tasks_per_call"]
    tasks = st.program_pool[c % len(st.pool)]
    seeds = inputs.row_seeds(st.run.seed, c, t)
    if tracer is None:
        return [r.selection for r in st.engine.explore_batch(tasks,
                                                             seed=seeds)]
    with tracer.span("G"):
        probs = st.explorer.generator_probs_device(
            tasks.net_idx, tasks.lat_obj, tasks.pow_obj, seed=seeds)
        torch.cuda.synchronize(st.run.device)
    with tracer.span("select"):
        return select_from_probs(st.engine.model, tasks.net_idx, probs,
                                 st.engine.explorer_cfg, tasks.lat_obj,
                                 tasks.pow_obj)


def window(st: State, seconds: float, tracer) -> Window:
    tr = st.run.traffic
    t = tr["tasks_per_call"]
    keep = tr["check_calls"]
    draw = random.Random(st.run.seed)
    samples: List[Sample] = []
    times: List[float] = []
    n_cand = 0
    ctx = tracer.window() if tracer is not None else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        c = 0
        while True:
            a = time.perf_counter()
            sels = call(st, c, tracer)
            b = time.perf_counter()
            times.append(b - a)
            n_cand += sum(s.n_candidates for s in sels)
            # a uniform sample of the window's calls (reservoir)
            slot = c if c < keep else draw.randrange(c + 1)
            if slot < keep:
                s = Sample(st.pool[c % len(st.pool)],
                           inputs.row_seeds(st.run.seed, c, t),
                           [as_answer(x) for x in sels])
                if c < keep:
                    samples.append(s)
                else:
                    samples[slot] = s
            c += 1
            if b - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
    n_tasks = c * t
    flops, _ = counts.mlp_forward_work(t, st.g_dims)
    return Window(
        e2e={"explore_tasks_per_s": n_tasks / elapsed,
             "explore_call_ms_p95": 1e3 * common.percentile(times, 95)},
        attempted=n_tasks, failed=0,
        counts={"calls": c, "tasks": n_tasks, "candidates": n_cand,
                "g_flops_per_call": flops,
                "g_bound_s_per_call": counts.mlp_forward_bound_s(t, st.g_dims)},
        extra={"samples": samples})


def release(st: State) -> None:
    """Drop the program's state and give its memory back."""
    st.engine = st.explorer = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_probs(st: State, sample: Sample, g_layers, precision: str):
    dev = st.run.device
    enc = torch.as_tensor(st.rows.net_enc(st.oracle, sample.tasks.net_idx),
                          device=dev)
    obj = torch.as_tensor(st.rows.obj_enc(sample.tasks.lat_obj,
                                          sample.tasks.pow_obj), device=dev)
    noise = ref_gan.explore_noise(sample.seeds,
                                  st.run.config["gan"]["noise_dim"], dev)
    with torch.no_grad():
        return ref_gan.g_probs(g_layers, st.oracle.cfg.sizes, enc, obj, noise,
                               precision)


def reference_g(st: State, precision: str):
    return inputs.weights(st.g_dims, st.run.traffic["g_seed"],
                          inputs.WEIGHTS_G, st.run.device,
                          dtype=ref_gan.dtype_of(precision))


def check(st: State, win: Window) -> List[Check]:
    """Every answer of the sampled calls against the reference's
    exploration of its own float64 probabilities, ties either way."""
    release(st)
    x, tr = st.run.config["explorer"], st.run.traffic
    g64 = reference_g(st, "float64")
    differing = 0
    for s in win.extra["samples"]:
        want = reference_probs(st, s, g64, "float64").cpu().numpy()
        ok = ref_select.explore_ties(
            st.oracle, s.tasks.net_idx, want, x["prob_threshold"],
            x["max_candidates"], s.tasks.lat_obj, s.tasks.pow_obj,
            st.run.device, tr["tie"])
        differing += sum(got not in acc for got, acc in zip(s.answers, ok))
    return [Check("answers_differing", float(differing),
                  tr["limits"]["answers_differing"])]


def control_checks(st: State, win: Window, precision: str) -> List[Check]:
    """The checks with the reference at `precision` (G, then the select on
    its probabilities in float32) in the program's place, on the calls the
    window sampled."""
    release(st)
    x = st.run.config["explorer"]
    g = reference_g(st, precision)
    samples = []
    for s in win.extra["samples"]:
        probs = reference_probs(st, s, g, precision).float().cpu().numpy()
        samples.append(Sample(s.tasks, s.seeds, ref_select.explore(
            st.oracle, s.tasks.net_idx, probs, x["prob_threshold"],
            x["max_candidates"], s.tasks.lat_obj, s.tasks.pow_obj,
            st.run.device)))
    return check(st, dataclasses.replace(win, extra={"samples": samples}))
