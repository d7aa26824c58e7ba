"""Phase t of ``chip_smoke.py`` alone, on one H100, then two checks of
phase t2's gates.  A probe, not part of the package:

    python3 src/repro_torch/kernels/probes/phase_t.py [--out JSON]

1. Builds the kernels, runs phase 3's im2col path (``chip_smoke.drive_path``:
   G 11 x 2048, 64 tasks) for the Selections t1 is held to, then
   ``chip_smoke.phase_t1`` in this process (a world of one on NCCL).
2. The gap trace, for T_TRAIN's 4 steps at batch 1024, one step at batch
   2048 and T_FIRST's one step: in each of t2's two ranks on the one card
   (gloo), data-parallel ``train_gan`` records every all-reduced
   gradient, the params after every step and the first step's ReLU
   masks; rank 0 first runs the same training unsharded and compares the
   two, element by element (``gap_report``): the masks that flipped, the
   gradients' gap step by step, where the params end outside the
   reference's rtol 2e-4 / atol 1e-6, at which step they left it, and
   what the gradients and the updates of those elements looked like.
3. Planted faults: t2's ranks, each with one fault planted in
   ``core/train._DataParallel`` (``FAULTS``); ``chip_smoke.t2_failures``
   must report the first step's gradients or losses for every rank.
4. Phase t2 itself, whose gates (``chip_smoke.t2_failures``) must hold.

Prints each part's JSON and writes them all to ``--out`` (default
``chiprun_out/phase_t_probe.json``) before it checks 3 and 4.  Needs the
card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[4]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import train as T  # noqa: E402
from repro_torch.nn import layers as L  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402

#: the reference's tolerance on the params (tests/test_shard.py)
RTOL, ATOL = 2e-4, 1e-6


def _is_metrics(tree) -> bool:
    return isinstance(tree, dict) and "loss_g" in tree


def plant_skip_grad_all_reduce() -> None:
    """G's and D's gradients are not all-reduced (the metrics still are):
    each rank steps on its own half of the batch."""
    real = T._DataParallel.all_reduce
    T._DataParallel.all_reduce = (
        lambda self, tree: real(self, tree) if _is_metrics(tree) else tree)


def plant_rank0_noise_rows() -> None:
    """Every rank takes rank 0's rows of the global batch's noise."""
    T._DataParallel.rows = lambda self, x: x[:x.shape[0] // self.k]


FAULTS = {"skip_grad_all_reduce": plant_skip_grad_all_reduce,
          "rank0_noise_rows": plant_rank0_noise_rows}


def record_steps() -> dict:
    """Patch ``core/train`` to keep, step by step, the all-reduced G and D
    gradients and the params each update gives, flattened, on the card;
    and, for the first step, the ReLU mask of every hidden dense layer
    (``nn/layers`` -> ``kernels/dispatch.dense``) in call order."""
    rec = {"grads": [], "params": [], "masks": [], "sizes": []}
    real_reduce, real_apply = T._DataParallel.all_reduce, T.apply_updates
    real_dense = L.D.dense

    def dense(x, w, b, *, relu=True, use_fused=None):
        y = real_dense(x, w, b, relu=relu, use_fused=use_fused)
        if relu and len(rec["params"]) < 2:      # step 1: G's, D's update
            rec["masks"].append((y > 0).detach())
        return y

    def flat(tree):
        return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)])

    def all_reduce(self, tree):
        out = real_reduce(self, tree)
        if not _is_metrics(tree):
            rec["grads"].append(flat(out))
            if len(rec["sizes"]) < 2:                # G's leaves, D's
                rec["sizes"] += [t.numel() for t in tree_leaves(out)],
        return out

    def apply_updates(params, updates):
        out = real_apply(params, updates)
        rec["params"].append(flat(out))
        return out

    T._DataParallel.all_reduce = all_reduce
    T.apply_updates = apply_updates
    L.D.dense = dense
    return rec


def _per_step(rec: dict) -> list:
    """[(gradient, params after the step)] a step, G's then D's joined."""
    g, p = rec["grads"], rec["params"]
    return [(torch.cat(g[i:i + 2]), torch.cat(p[i:i + 2]))
            for i in range(0, len(g), 2)]


def _quantiles(x: torch.Tensor, n: int = 1 << 20) -> list:
    x = x[torch.isfinite(x)].float()
    if x.numel() == 0:
        return []
    if x.numel() > n:
        gen = torch.Generator(device=x.device).manual_seed(0)
        x = x[torch.randint(x.numel(), (n,), device=x.device, generator=gen)]
    return [float(v) for v in torch.quantile(
        x, torch.tensor([0.1, 0.5, 0.9], device=x.device))]


def gap_report(one: dict, two: dict, init: torch.Tensor, lr: float) -> dict:
    """Element by element, the unsharded run `one` against the data-
    parallel run `two` (``record_steps``), from the same `init` params.

    The first step's ReLU masks that differ on rank 0's rows, and step
    by step the gradients' gap.  For the elements outside the reference's
    tolerance after the last step ("bad") and for all elements: the step
    at which each first left it; whether its gradient's sign differed
    between the runs at step 1 or at any step; its smallest |g| / its
    leaf's RMS over the steps (how small the gradient was where it
    moved); its largest relative gradient gap |g2 - g1| / |g1|; and its
    largest update gap |u2 - u1| / lr."""
    steps_one, steps_two = _per_step(one), _per_step(two)
    # a rank's rows are the first rows of the one-rank batch (rank 0)
    flips = [int((a[:b.shape[0]] != b).sum())
             for a, b in zip(one["masks"], two["masks"])]
    n = init.numel()
    sizes = one["sizes"][0] + one["sizes"][1]
    first_out = torch.full((n,), -1, dtype=torch.int8, device=init.device)
    flip_any = torch.zeros(n, dtype=torch.bool, device=init.device)
    small = torch.full((n,), float("inf"), device=init.device)
    rel = torch.zeros(n, device=init.device)
    du = torch.zeros(n, device=init.device)
    per_step = []
    prev1 = prev2 = init
    for t, ((g1, p1), (g2, p2)) in enumerate(zip(steps_one, steps_two)):
        out = (p2 - p1).abs() > ATOL + RTOL * p1.abs()
        first_out[(first_out < 0) & out] = t + 1
        flip = g1 * g2 < 0
        if t == 0:
            flip_first = flip.clone()
        flip_any |= flip
        rms = torch.repeat_interleave(
            torch.stack([x.pow(2).mean().sqrt() for x in g1.split(sizes)]),
            torch.tensor(sizes, device=g1.device))
        small = torch.minimum(small, g1.abs() / rms)
        rel = torch.maximum(rel, ((g2 - g1).abs() / g1.abs()).nan_to_num(
            nan=0.0, posinf=float("inf")))
        du = torch.maximum(du, ((p2 - prev2) - (p1 - prev1)).abs() / lr)
        per_step.append(dict(
            step=t + 1,
            grad_norm_gap=float((g2 - g1).norm() / g1.norm()),
            grad_max_gap=float((g2 - g1).abs().max() / g1.abs().max()),
            sign_flips=int(flip.sum()), outside=int(out.sum()),
            update_gap_over_lr_max=float(
                (((p2 - prev2) - (p1 - prev1)).abs() / lr).max())))
        prev1, prev2 = p1, p2
    bad = out
    nb = int(bad.sum())

    def share(mask):
        return float(mask[bad].float().mean()) if nb else 0.0

    return dict(
        n_params=n, lr=lr, step1_relu_mask_flips=sum(flips),
        step1_relu_mask_flips_by_layer=flips,
        step1_relu_units=sum(int(b.numel()) for b in two["masks"]),
        per_step=per_step, n_bad=nb,
        bad_left_at_step={t: int((first_out[bad] == t).sum())
                          for t in range(1, len(per_step) + 1)},
        bad_step1_sign_flip=share(flip_first),
        bad_any_sign_flip=share(flip_any),
        all_any_sign_flip=float(flip_any.float().mean()),
        grad_over_rms_min_q10_50_90=dict(bad=_quantiles(small[bad]),
                                         all=_quantiles(small)),
        rel_grad_gap_max_q10_50_90=dict(bad=_quantiles(rel[bad]),
                                        all=_quantiles(rel)),
        bad_rel_grad_gap_over_1=share(rel > 1),
        update_gap_over_lr_max_q10_50_90=dict(bad=_quantiles(du[bad]),
                                              all=_quantiles(du)))


def diagnose_rank(rank: int, tmp: str) -> int:
    """One rank of the gap trace (``--diagnose``): for T_TRAIN's run, one
    step at batch 2048 and T_FIRST's step, rank 0 trains unsharded, then every rank data
    parallel, each recorded; rank 0 writes ``gap_report`` of each to
    `tmp`/rank0.json."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    cs.LM.init_process_group("gloo", dist.FileStore(
        os.path.join(tmp, "store"), cs.T2_RANKS), rank, cs.T2_RANKS)
    mesh = cs.LM.make_host_mesh(device="cuda:0")
    rec = record_steps()
    model = cs.Im2colModel()
    cfg = cs.G.GANConfig(n_net=model.net_space.n_dims)
    init = T.init_state(model, cfg, 0, "cuda")
    init = torch.cat([t.reshape(-1) for t in tree_leaves(
        (init.g_params, init.d_params))])
    out = {"rank": rank}
    for name, run in (("batch 1024", (cs.T_TRAIN[0], cs.T_TRAIN[1], 1024)),
                      ("batch 2048", (2048, 1, 2048)),
                      ("first step", cs.T_FIRST)):
        for v in rec.values():
            v.clear()
        if rank == 0:
            st, _, _ = cs.t_train(None, *run)
            one = {k: list(v) for k, v in rec.items()}
            for v in rec.values():
                v.clear()
        st2, _, _ = cs.t_train(mesh, *run)
        if rank == 0:
            out[name] = gap_report(one, rec, init, cfg.g_lr)
            out[name]["loss_gap"] = [
                {k: abs(a[k] - b[k]) / abs(a[k]) for k in ("loss_g", "loss_d")}
                for a, b in zip(st.history, st2.history)]
            del one
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "phase_t_probe.json"))
    ap.add_argument("--t2-rank", type=int, help="one rank (started here)")
    ap.add_argument("--t2-dir")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--diagnose", action="store_true")
    args = ap.parse_args()
    if args.t2_rank is not None:
        if args.diagnose:
            return diagnose_rank(args.t2_rank, args.t2_dir)
        FAULTS[args.fault]()
        return cs.t2_rank(args.t2_rank, args.t2_dir)
    if not torch.cuda.is_available():
        print("phase_t: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.smi()}", flush=True)
    # the three sources phase t launches (the sLSTM's is not needed)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(load) for load in (
                cs.fm.load_library, cs.fd.load_library, cs.fa.load_library)]:
            f.result()
    run = cs.drive_path(cs.Im2colModel())
    _, state = cs.phase_t1(run["engine"], run["warm"])
    me = [sys.executable, os.path.abspath(__file__)]
    result = {"card": cs.smi(), "faults": {}}
    result["gap"] = cs.run_t2_ranks(state, me + ["--diagnose"])[0]
    print("gap: " + json.dumps(result["gap"]), flush=True)
    for name in FAULTS:
        result["faults"][name] = cs.t2_failures(
            cs.run_t2_ranks(state, me + ["--fault", name]))
        print(f"fault {name}: " + json.dumps(result["faults"][name]),
              flush=True)
    result["t2"] = cs.run_t2_ranks(state)
    result["t2_failed"] = cs.t2_failures(result["t2"])
    print("phase t2: " + json.dumps(result["t2"]), flush=True)
    torch.distributed.destroy_process_group()
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh)
    assert not result["t2_failed"], result["t2_failed"]
    for name, failed in result["faults"].items():
        for r in range(cs.T2_RANKS):
            assert any(f.startswith(f"rank {r}: first step's")
                       for f in failed), (name, failed)
    print(f"phase_t: held on {result['card']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
