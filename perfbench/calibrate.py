"""Readings that set a cell's limits: the program's checks over many seeds
and the control's (the reference a precision step down, in the program's
place), at the cell's own size, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--precision tf32] [--rows-kept 0.5] \\
        [--seconds 3] [--out chiprun_out/calibrate.jsonl]

With ``--trained-epochs 8,32`` (an explore cell, one seed in
``--seeds``), it reads instead what exploring costs with the cell's own G
drawn from a seed and with a G trained by the program's Algorithm 1
(``train_gan`` on the cell's dataset) for each number of epochs: G's and
the select's milliseconds a call and the candidates a task.

Each reading is one JSON line (stdout, and appended to ``--out``).  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--precision", default="tf32")
    p.add_argument("--rows-kept", type=float, default=1.0,
                   help="train only: the control keeps this share of a batch")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--trained-epochs", default="",
                   help="explore only: epochs of training to read after")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from perfbench.lib import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find(bench["workloads"], args.workload, "workload")
    config = harness.load_json(ROOT / harness.find(
        bench["configs"], cell["config"], "config")["file"])
    traffic = harness.load_json(harness.BENCH / "traffic"
                                / f"{cell['traffic']}.json")
    harness.cache_dirs(ROOT)
    harness.import_reference()
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    device = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    if args.trained_epochs:
        run = harness.Run(cell, config, traffic, seeds(args.seeds)[0], device,
                          ROOT)
        trained(driver, run, seeds(args.trained_epochs), emit)
        return 0

    for kind, seed_list in (("program", seeds(args.seeds)),
                            ("control", seeds(args.control_seeds))):
        for seed in seed_list:
            t0 = time.perf_counter()
            run = harness.Run(cell, config, traffic, seed, device, ROOT)
            st = driver.setup(run)
            rec = {"workload": cell["name"], "kind": kind, "seed": seed}
            win = driver.window(st, args.seconds, None)
            if kind == "program":
                checks = driver.check(st, win)
                rec["e2e"] = win.e2e
            else:
                kw = {"rows_kept": args.rows_kept} if args.rows_kept != 1.0 \
                    else {}
                checks = driver.control_checks(st, win, args.precision, **kw)
                rec["precision"] = args.precision
                rec.update(kw)
            rec["checks"] = {c.name: c.value for c in checks}
            if getattr(st, "diag", None):
                rec["diag"] = st.diag
            rec["seconds"] = time.perf_counter() - t0
            emit(rec)
            del st
    if out:
        out.close()
    return 0


def trained(driver, run, epochs, emit, calls: int = 8) -> None:
    """Exploring's cost with the seeded G, then after each number of
    epochs of the program's training on the cell's dataset."""
    import statistics

    import torch
    from repro_torch.core.fused_select import select_from_probs
    from repro_torch.core.train import train_gan

    from perfbench.drivers import common
    from perfbench.lib import inputs

    st = driver.setup(run)
    engine, t = st.engine, run.traffic["tasks_per_call"]
    ds = common.program_dataset(engine.model, st.rows)

    def sync():
        torch.cuda.synchronize(run.device)

    def measure(label: str, extra: dict) -> None:
        g_ms, sel_ms, cands = [], [], []
        for c in range(-2, calls):
            tasks = st.program_pool[c % len(st.pool)]
            seeds = inputs.row_seeds(run.seed, c, t)
            sync()
            a = time.perf_counter()
            probs = st.explorer.generator_probs_device(
                tasks.net_idx, tasks.lat_obj, tasks.pow_obj, seed=seeds)
            sync()
            b = time.perf_counter()
            sels = select_from_probs(engine.model, tasks.net_idx, probs,
                                     engine.explorer_cfg, tasks.lat_obj,
                                     tasks.pow_obj)
            sync()
            if c >= 0:
                g_ms.append(1e3 * (b - a))
                sel_ms.append(1e3 * (time.perf_counter() - b))
                cands.append(sum(s.n_candidates for s in sels) / t)
        emit({"workload": run.cell["name"], "kind": "trained", "G": label,
              "seed": run.seed, "g_ms": statistics.median(g_ms),
              "select_ms": statistics.median(sel_ms),
              "candidates_per_task": statistics.mean(cands),
              "satisfied_share": sum(s.satisfied for s in sels) / t,
              **extra})

    measure("seeded", {})
    state, done = None, 0
    for n in epochs:
        t0 = time.perf_counter()
        state = train_gan(engine.model, ds, engine.gan_cfg, iters=n - done,
                          seed=run.seed + n, state=state, device=run.device)
        sync()
        last = state.history[-1]
        done = n
        st.explorer = engine.attach(ds, state.g_params)
        measure(f"trained {n} epochs", {
            "train_s": time.perf_counter() - t0,
            "loss_g": last["loss_g"], "loss_d": last["loss_d"],
            "sat_rate": last["sat_rate"]})


if __name__ == "__main__":
    sys.exit(main())
