"""GANDSE's G and D and Algorithm 1 in plain PyTorch (paper §4, §6.1,
Table 4): the reference the benchmark holds the program's outputs to.

Both networks are MLPs, ReLU hidden layers and a linear head, given as a
list of (w (in, out), b (out,)) pairs.  ``precision`` picks how products
run: ``"float64"`` (the reference), ``"float32"`` (TF32 off) or
``"tf32"`` (each operand of a product rounded to TF32's 10-bit mantissa,
float32 sums: the control, a step below the float32 that the
configurations state).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import threefry

#: the in-step oracle's value for a non-finite metric (infeasible)
BIG = 3.4e38


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties away) on TF32's 10-bit mantissa."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32),
                       x.float())


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).t(), to_tf32(a).t() @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def mlp(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor,
        precision: str) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = matmul(x, w, precision) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def group_softmax(sizes: Sequence[int], logits: torch.Tensor) -> torch.Tensor:
    out, off = [], 0
    for n in sizes:
        out.append(torch.softmax(logits[..., off:off + n], dim=-1))
        off += n
    return torch.cat(out, dim=-1)


def g_probs(g_layers, sizes, net_enc, obj_enc, noise, precision: str):
    """G's per-group probabilities for encoded inputs and noise."""
    dt = dtype_of(precision)
    x = torch.cat([net_enc, obj_enc, noise], dim=-1).to(dt)
    return group_softmax(sizes, mlp(g_layers, x, precision))


def explore_noise(row_seeds: np.ndarray, noise_dim: int, device) -> torch.Tensor:
    """G's exploring noise: task t draws ``uniform(fold_in(key(seed_t), 0),
    noise_dim, -0.1, 0.1)`` (one noise sample a task)."""
    k = threefry.fold_in(threefry.key(row_seeds, device), 0)
    return threefry.uniform(k, noise_dim, -0.1, 0.1)


def decode(sizes, probs: torch.Tensor, tie: float):
    """Per-group argmax of probs (B, width) -> (B, n_dims) int64, plus the
    alternatives the program could have taken where a group's two best
    probabilities lie within `tie` of each other: a list of (row, indices
    with that group's runner-up)."""
    idx, alts, off = [], [], 0
    for g, n in enumerate(sizes):
        top = torch.topk(probs[:, off:off + n], min(2, n), dim=-1)
        idx.append(top.indices[:, 0])
        if n > 1:
            close = (top.values[:, 0] - top.values[:, 1]) < tie
            for r in close.nonzero().flatten().tolist():
                alts.append((r, g, int(top.indices[r, 1])))
        off += n
    idx = torch.stack(idx, dim=-1)
    out = []
    for r, g, j in alts:
        row = idx[r].clone()
        row[g] = j
        out.append((r, row))
    return idx, out


def adam_step(params, grads, m, v, t: int, lr: float, b1=0.9, b2=0.999,
              eps=1e-8):
    """Adam (Kingma & Ba) on lists of tensors -> new params, m, v."""
    m = [b1 * mi + (1 - b1) * g for mi, g in zip(m, grads)]
    v = [b2 * vi + (1 - b2) * g * g for vi, g in zip(v, grads)]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new = [p - lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
           for p, mi, vi in zip(params, m, v)]
    return new, m, v


def flat(layers) -> List[torch.Tensor]:
    return [t for wb in layers for t in wb]


def unflat(leaves) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]


@dataclasses.dataclass
class TrainRecord:
    """What some steps of Algorithm 1 gave: each step's (loss_g, loss_d),
    the interval each loss could take where the decoded configuration is a
    tie within rounding, the first step's gradient norm a leaf (G's leaves
    then D's, w before b), and each leaf's change over all the steps."""

    losses: List[Tuple[float, float]]
    bounds: List[Tuple[Tuple[float, float], Tuple[float, float]]]
    grad1_norms: List[float]
    delta_norms: List[float]
    ambiguous_rows: int = 0


def train_steps(g_layers, d_layers, batches, keys, oracle, sizes,
                cfg: dict, precision: str, tie: float, moments=None,
                done: int = 0) -> TrainRecord:
    """Algorithm 1 from (g_layers, d_layers) over `batches` (dicts of
    encoded rows on one device) with noise keys `keys` (one (2,) key a
    step); ``oracle(net_idx, cfg_idx) -> (lat, pw)`` float32.  Adam starts
    from `moments` (G's first and second, then D's: lists of leaves) after
    `done` steps, or from zero."""
    dt = dtype_of(precision)
    g = [t.to(dt) for t in flat(g_layers)]
    d = [t.to(dt) for t in flat(d_layers)]
    g0, d0 = [t.clone() for t in g], [t.clone() for t in d]
    if moments is None:
        moments = [[torch.zeros_like(t) for t in x] for x in (g, g, d, d)]
    mg, vg, md, vd = [[t.to(dt) for t in x] for x in moments]
    rec = TrainRecord([], [], [], [])
    w_critic = cfg["w_critic"]
    for step, (batch, k) in enumerate(zip(batches, keys), start=done + 1):
        n = batch["net_enc"].shape[0]
        noise = threefry.uniform(k, n * cfg["noise_dim"], -0.1, 0.1)
        noise = noise.reshape(n, cfg["noise_dim"]).to(dt)
        net_enc, obj_enc = batch["net_enc"].to(dt), batch["obj_enc"].to(dt)
        gp = [t.detach().requires_grad_() for t in g]
        probs = group_softmax(sizes, mlp(unflat(gp), torch.cat(
            [net_enc, obj_enc, noise], -1), precision))
        with torch.no_grad():
            idx, alts = decode(sizes, probs, tie)
            lat, pw = oracle(batch["net_idx"], idx)
            sat = _sat(lat, pw, batch)
            alt_sat = {}
            for r, row in alts:
                la, pa = oracle(batch["net_idx"][r:r + 1], row[None])
                if bool(_sat(la, pa, batch, r)[0] != sat[r]):
                    alt_sat[r] = True
        rec.ambiguous_rows += len(alt_sat)
        sat = sat.to(dt)
        d_frozen = unflat([t.detach() for t in d])
        crit = torch.log_softmax(mlp(d_frozen, torch.cat(
            [net_enc, probs, obj_enc], -1), precision), -1)
        loss_critic = torch.mean(-crit[:, 1])
        ce = -torch.sum(batch["cfg_onehot"].to(dt) * torch.log(probs + 1e-9), -1)
        loss_config = torch.mean((1.0 - sat) * ce)
        loss_g = loss_config + w_critic * loss_critic
        grads_g = torch.autograd.grad(loss_g, gp)

        dp = [t.detach().requires_grad_() for t in d]
        lsd = torch.log_softmax(mlp(unflat(dp), torch.cat(
            [net_enc, probs.detach(), obj_enc], -1), precision), -1)
        per_row = -(sat * lsd[:, 1] + (1.0 - sat) * lsd[:, 0])
        loss_d = torch.mean(per_row)
        grads_d = torch.autograd.grad(loss_d, dp)

        with torch.no_grad():
            rows = torch.tensor(sorted(alt_sat), dtype=torch.long,
                                device=probs.device)
            # a tied row's label can go either way: its share of each loss
            # spans both labels
            cfg_lo = (1.0 - sat) * ce
            cfg_hi = cfg_lo.clone()
            d_lo, d_hi = per_row.detach().clone(), per_row.detach().clone()
            if rows.numel():
                cfg_lo[rows], cfg_hi[rows] = 0.0, ce[rows]
                both = -lsd[rows].detach()
                d_lo[rows] = both.min(-1).values
                d_hi[rows] = both.max(-1).values
            crit_part = w_critic * float(loss_critic)
            rec.bounds.append(((float(cfg_lo.mean()) + crit_part,
                                float(cfg_hi.mean()) + crit_part),
                               (float(d_lo.mean()), float(d_hi.mean()))))
            rec.losses.append((float(loss_g), float(loss_d)))
            if step == done + 1:
                rec.grad1_norms = [float(t.norm())
                                   for t in (*grads_g, *grads_d)]
            g, mg, vg = adam_step(g, grads_g, mg, vg, step, cfg["g_lr"])
            d, md, vd = adam_step(d, grads_d, md, vd, step, cfg["d_lr"])
    rec.delta_norms = [float((a - b).norm())
                       for a, b in zip((*g, *d), (*g0, *d0))]
    return rec


def _sat(lat, pw, batch, r=None):
    lat = torch.nan_to_num(lat.float(), nan=BIG, posinf=BIG)
    pw = torch.nan_to_num(pw.float(), nan=BIG, posinf=BIG)
    lo, po = batch["lat_obj"], batch["pow_obj"]
    if r is not None:
        lo, po = lo[r:r + 1], po[r:r + 1]
    return (lat <= lo) & (pw <= po)
