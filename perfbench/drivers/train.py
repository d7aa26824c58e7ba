"""Algorithm 1: epochs back to back through ``core/train.make_epoch_fn``,
the loop ``GANDSE.train`` runs, on a dataset made from the seed.

Set-up builds the one training object (G and D drawn from the seed, Adam
at zero, the noise key, the program's encoded dataset), drives its first
steps through the epoch call on rows that all differ (step 1 alone, then
steps 2-3) and hands that object to the window.  Each window epoch draws
its permutation on the host as ``train_gan`` does, copies G's and D's
parameters and Adam's moments aside before it starts, and reads its
metrics back once, at its end.

The check holds to the float64 reference, started from the seed, those
first steps: the first step's losses, the first gradient's norm a leaf
(from Adam's first moment after one step) and each leaf's change after
three.  It holds the window's last epoch, a call of the window's own
shape, to the reference started from the copy made before it (the noise
key the reference derives from the seed itself): that epoch's first
losses and each leaf's change over its steps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import time
from typing import List, Optional

import numpy as np
import torch

from perfbench.drivers import common
from perfbench.lib import counts, inputs
from perfbench.lib.harness import Check, Run, Window
from perfbench.reference import gan as ref_gan
from perfbench.reference import threefry
from perfbench.reference.oracles import Oracle


@dataclasses.dataclass
class State:
    run: Run
    oracle: Oracle
    rows: inputs.DatasetRows
    g_dims: List[int]
    d_dims: List[int]
    order: np.random.Generator
    first_rows: np.ndarray              # (steps, batch) rows of the first steps
    first: Optional[ref_gan.TrainRecord] = None
    epoch: object = None
    carry: object = None
    data: object = None
    snap: Optional[List[torch.Tensor]] = None   # the copy before an epoch
    last: Optional[dict] = None                 # the window's last epoch
    diag: Optional[dict] = None


def leaves(carry_params) -> List[torch.Tensor]:
    return [t for layer in carry_params["layers"] for t in (layer["w"],
                                                           layer["b"])]


def params(carry) -> List[torch.Tensor]:
    """G's leaves then D's."""
    return [*leaves(carry[0]), *leaves(carry[1])]


def state_leaves(carry) -> List[torch.Tensor]:
    """G's and D's leaves, then Adam's moments: G's first and second, then
    D's."""
    g_opt, d_opt = carry[2], carry[3]
    return [*params(carry), *leaves(g_opt.mu), *leaves(g_opt.nu),
            *leaves(d_opt.mu), *leaves(d_opt.nu)]


def initial(st: State, dtype=torch.float32):
    """G's and D's initial weights, drawn from the seed."""
    dev = st.run.device
    return (inputs.weights(st.g_dims, st.run.seed, inputs.WEIGHTS_G, dev, dtype),
            inputs.weights(st.d_dims, st.run.seed, inputs.WEIGHTS_D, dev, dtype))


def permutation(st: State) -> np.ndarray:
    n, b = st.rows.net_idx.shape[0], st.run.config["gan"]["batch_size"]
    return st.order.permutation(n)[: (n // b) * b].reshape(n // b, b)


def setup(run: Run) -> State:
    from repro_torch.core.train import encode_dataset, make_epoch_fn

    cfg, tr = run.config, run.traffic
    oracle = Oracle(cfg["design_model"])
    model = common.program_model(cfg)
    rows = inputs.dataset(oracle, tr["dataset_rows"], run.seed)
    g_dims, d_dims = common.gan_dims(cfg, oracle)
    st = State(run, oracle, rows, g_dims, d_dims,
               inputs.rng(run.seed, inputs.ORDER), None)
    st.data = encode_dataset(model, common.program_dataset(model, rows),
                             run.device)
    g_optim, d_optim, st.epoch = make_epoch_fn(model,
                                               common.gan_config(cfg, oracle))
    g, d = initial(st)
    g_params, d_params = common.params_tree(g), common.params_tree(d)
    st.carry = (g_params, d_params, g_optim.init(g_params),
                d_optim.init(d_params), threefry.key(run.seed, run.device))
    first = permutation(st)
    n_first = tr["check_steps"]
    st.first_rows = first[:n_first]
    perm = torch.as_tensor(st.first_rows, device=run.device)
    st.carry, m1 = st.epoch(st.carry, st.data, perm[:1])
    b1 = np.float32(1 - cfg["gan"]["adam"]["b1"])
    grad1 = [float(t.norm()) / float(b1) for t in
             (*leaves(st.carry[2].mu), *leaves(st.carry[3].mu))]
    st.carry, m2 = st.epoch(st.carry, st.data, perm[1:])
    g0, d0 = initial(st)
    delta = [float((a - b).norm()) for a, b in zip(
        params(st.carry), (*ref_gan.flat(g0), *ref_gan.flat(d0)))]
    del g0, d0
    losses = [(float(a), float(b)) for m in (m1, m2)
              for a, b in zip(m["loss_g"], m["loss_d"])]
    st.first = ref_gan.TrainRecord(losses, [], grad1, delta)
    st.snap = [t.clone() for t in state_leaves(st.carry)]
    return st


def window(st: State, seconds: float, tracer) -> Window:
    batch = st.run.config["gan"]["batch_size"]
    steps, failed = 0, 0
    done = st.run.traffic["check_steps"]
    ctx = tracer.window() if tracer is not None else contextlib.nullcontext()
    span = tracer.span if tracer is not None else (
        lambda _name: contextlib.nullcontext())
    with ctx:
        t0 = time.perf_counter()
        while True:
            with span("copy aside"):
                for a, b in zip(st.snap, state_leaves(st.carry)):
                    a.copy_(b)
            with span("epoch"):
                rows = permutation(st)
                perm = torch.as_tensor(rows, device=st.run.device)
                st.carry, metrics = st.epoch(st.carry, st.data, perm)
            with span("read metrics"):
                losses = torch.stack([metrics["loss_g"], metrics["loss_d"]])
                losses = losses.cpu().numpy()
            st.last = {"rows": rows, "losses": losses, "done": done + steps}
            steps += losses.shape[1]
            failed += int((~np.isfinite(losses).all(0)).sum())
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
    products = counts.algorithm1_products(batch, st.g_dims, st.d_dims)
    return Window(
        e2e={"train_samples_per_s": steps * batch / elapsed},
        attempted=steps, failed=failed,
        counts={"steps": steps, "step_flops": counts.flops(products),
                "dense_bound_s_per_step": counts.bound_s(products)})


def release(st: State) -> None:
    """Drop the program's state (the copy before the last epoch stays, for
    the reference to start from) and give its memory back."""
    st.carry = st.data = st.epoch = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def encoded(st: State, rows, rows_kept: float):
    dev = st.run.device
    out = []
    for r in rows:
        enc = st.rows.encoded(st.oracle, r[: int(len(r) * rows_kept)])
        out.append({k: torch.as_tensor(v, device=dev) for k, v in enc.items()})
    return out


def noise_keys(st: State, done: int, n: int) -> List[torch.Tensor]:
    """The noise keys of steps done+1 .. done+n, split from the seed's (on
    the host: a key is two words)."""
    k, keys = threefry.key(st.run.seed), []
    for i in range(done + n):
        k, noise_key = threefry.split(k)
        if i >= done:
            keys.append(noise_key.to(st.run.device))
    return keys


def reference(st: State, precision: str, tie: float,
              rows_kept: float = 1.0) -> ref_gan.TrainRecord:
    """Algorithm 1's first steps in the reference at `precision`, from the
    seed, on the first `rows_kept` share of each batch."""
    cfg = st.run.config["gan"]
    batches = encoded(st, st.first_rows, rows_kept)
    g, d = initial(st)
    return ref_gan.train_steps(g, d, batches, noise_keys(st, 0, len(batches)),
                               st.oracle.device, st.oracle.cfg.sizes, cfg,
                               precision, tie)


def reference_epoch(st: State, precision: str, tie: float,
                    rows_kept: float = 1.0) -> ref_gan.TrainRecord:
    """The window's last epoch in the reference at `precision`, from the
    program's copy of G, D and Adam's moments made before it."""
    cfg, last = st.run.config["gan"], st.last
    batches = encoded(st, last["rows"], rows_kept)
    n = len(st.snap) // 3
    half = n // 2
    g = ref_gan.unflat(st.snap[:half])
    d = ref_gan.unflat(st.snap[half:n])
    moments = [st.snap[n + i * half:n + (i + 1) * half] for i in range(4)]
    return ref_gan.train_steps(g, d, batches,
                               noise_keys(st, last["done"], len(batches)),
                               st.oracle.device, st.oracle.cfg.sizes, cfg,
                               precision, tie, moments, last["done"])


def loss_gap(got, bounds, ref) -> float:
    """The widest gap of one step's (loss_g, loss_d) outside the span a
    tied row allows, over the reference's loss."""
    return max(max(lo - v, v - hi, 0.0) / abs(r)
               for v, (lo, hi), r in zip(got, bounds, ref))


def change_gaps(got: List[float], want: ref_gan.TrainRecord) -> List[float]:
    """Each leaf's gap of change norms, over the larger of the leaf's and
    the median leaf's.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by rounding alone and are left
    out."""
    med = statistics.median(want.grad1_norms)
    moved = [i for i, g in enumerate(want.grad1_norms) if g >= 1e-3 * med]
    med_d = statistics.median(want.delta_norms[i] for i in moved)
    return [abs(got[i] - want.delta_norms[i])
            / max(want.delta_norms[i], med_d) for i in moved]


def judge(got: ref_gan.TrainRecord, want: ref_gan.TrainRecord,
          got_epoch: ref_gan.TrainRecord, want_epoch: ref_gan.TrainRecord,
          limits: dict) -> List[Check]:
    """The first step's losses, the first gradient's norm and each leaf's
    change after the first steps; the last epoch's first losses and each
    leaf's change over it, by the widest gap and by the median leaf's.
    Gaps of norms are taken a leaf, over the larger of the leaf's norm and
    the median leaf's.  Later steps' losses are not compared: a row tied
    within rounding at one step splits the two trajectories at the next
    (PERF.md)."""
    med = statistics.median(want.grad1_norms)
    grad_gap = max(abs(a - b) / max(b, med)
                   for a, b in zip(got.grad1_norms, want.grad1_norms))
    epoch_gaps = change_gaps(got_epoch.delta_norms, want_epoch)
    values = {
        "first_loss_gap": loss_gap(got.losses[0], want.bounds[0],
                                   want.losses[0]),
        "grad_gap": grad_gap,
        "update_gap": max(change_gaps(got.delta_norms, want)),
        "epoch_loss_gap": loss_gap(got_epoch.losses[0], want_epoch.bounds[0],
                                   want_epoch.losses[0]),
        "epoch_update_gap": max(epoch_gaps),
        "epoch_median_gap": statistics.median(epoch_gaps),
    }
    return [Check(k, v, limits[k]) for k, v in values.items()]


def epoch_record(st: State) -> ref_gan.TrainRecord:
    """What the program's last window epoch gave: its first losses and
    each leaf's change over it."""
    losses = st.last["losses"]
    delta = [float((a - b).norm()) for a, b in zip(params(st.carry),
                                                   st.snap)]
    return ref_gan.TrainRecord([(float(losses[0, 0]), float(losses[1, 0]))],
                               [], [], delta)


def diagnose(st: State, got, want, got_epoch, want_epoch) -> None:
    st.diag = {"losses": got.losses, "ref_losses": want.losses,
               "tied_rows": want.ambiguous_rows,
               "grad1": [got.grad1_norms, want.grad1_norms],
               "delta": [got.delta_norms, want.delta_norms],
               "epoch_losses": got_epoch.losses,
               "epoch_ref_losses": want_epoch.losses[:1],
               "epoch_tied_rows": want_epoch.ambiguous_rows,
               "epoch_delta": [got_epoch.delta_norms, want_epoch.delta_norms],
               "epoch_done": st.last["done"]}


def check(st: State, win: Window) -> List[Check]:
    got_epoch = epoch_record(st)
    release(st)
    tr = st.run.traffic
    want = reference(st, "float64", tr["tie"])
    want_epoch = reference_epoch(st, "float64", tr["tie"])
    diagnose(st, st.first, want, got_epoch, want_epoch)
    return judge(st.first, want, got_epoch, want_epoch, tr["limits"])


def control_checks(st: State, win: Window, precision: str,
                   rows_kept: float = 1.0) -> List[Check]:
    """The checks with the reference at `precision`, on the first
    `rows_kept` share of each batch, in the program's place: for the first
    steps, and for the window's last epoch from the same copy."""
    release(st)
    tr = st.run.traffic
    got = reference(st, precision, 0.0, rows_kept)
    want = reference(st, "float64", tr["tie"])
    got_epoch = reference_epoch(st, precision, 0.0, rows_kept)
    want_epoch = reference_epoch(st, "float64", tr["tie"])
    diagnose(st, got, want, got_epoch, want_epoch)
    return judge(got, want, got_epoch, want_epoch, tr["limits"])
