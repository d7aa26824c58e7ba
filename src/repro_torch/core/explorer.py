"""Design Explorer — GAN inference + candidate configuration sets (§6.1).

"For each configuration, if the one-hot output of one choice exceeds the
probability threshold, the choice is employed.  Then the candidate
configuration sets are the combinations of all the employed choices of all
the configurations."

The cartesian product can explode combinatorially; it is capped at
``max_candidates`` by trimming the lowest-probability employed choices
(argmax choices are never trimmed).

Two routes produce identical candidate sets from the same probs:

- ``enumerate_candidates``: host numpy + ``itertools.product`` for one task;
- ``_enum_core``: the batched device twin (threshold mask -> trimmed
  per-group keep masks -> mixed-radix tables).  ``core/fused_select``
  streams it in tiles (caps up to ``_PROD_LIM``);
  ``enumerate_candidates_batch`` unravels it whole into a padded
  ``(T, C_pad, n_dims)`` tensor (the dense route, caps up to
  ``_DENSE_LIM``), which ``selector.select_batch`` consumes.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core.shard import pow2_bucket
from repro_torch.core.encoding import ConfigSpace, device_tables
from repro_torch.dataset.generator import Dataset
from repro_torch.design_models.base import DesignModel


@dataclasses.dataclass
class ExplorerConfig:
    prob_threshold: float = 0.2
    max_candidates: int = 4096
    noise_samples: int = 1     # forward passes with independent noise
    #: streaming select tile width — peak candidate memory is
    #: O(T * select_tile * n_dims)
    select_tile: int = 1024


#: largest max_candidates the batched routes accept
_PROD_LIM = 1 << 26
#: largest cap the dense route materializes as a (T, C_pad, n_dims) tensor;
#: beyond it only the streaming route (core/fused_select) applies
_DENSE_LIM = 1 << 20


def resolve_device(device) -> torch.device:
    """None -> the card; raises when the card is asked for and absent (the
    CPU is used only when the caller names it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def row_seeds(seed, n: int) -> np.ndarray:
    """THE per-row seed convention: a scalar ``seed`` -> seed + arange(n)
    (row t explores with seed + t); an (n,) array -> as-is.  Host int64
    either way (see `task_keys`)."""
    if np.ndim(seed) == 0:
        return np.arange(n, dtype=np.int64) + int(seed)
    seeds = np.asarray(seed, np.int64).reshape(-1)
    assert seeds.shape[0] == n, (seeds.shape, n)
    return seeds


def task_keys(seed, n: int) -> torch.Tensor:
    """Per-task noise keys: ``PRNGKey`` over `row_seeds(seed, n)` masked to
    its low 32 bits in host int64 (so large seeds neither raise nor alias
    within a batch) -> (n, 2) int64 CPU tensor, bit-identical to the
    reference's keys."""
    seeds = row_seeds(seed, n) & np.int64(0xFFFFFFFF)
    return prng.prng_key(torch.from_numpy(seeds))


def _employed_choices(probs_g: List[np.ndarray], thresh: float) -> List[np.ndarray]:
    """Per group: indices of choices above threshold (argmax always kept)."""
    out = []
    for g in probs_g:
        keep = np.flatnonzero(g > thresh)
        if keep.size == 0:
            keep = np.array([int(np.argmax(g))])
        out.append(keep)
    return out


def _trimmed_employed(
    space: ConfigSpace,
    probs: np.ndarray,
    thresh: float,
    max_candidates: int,
) -> List[np.ndarray]:
    """Per-group employed choice sets after the candidate cap (host route)."""
    groups = [np.asarray(g) for g in space.split_groups(probs)]
    employed = _employed_choices(groups, thresh)

    counts = [len(e) for e in employed]
    product = 1
    for c in counts:
        product *= c
    if product > max_candidates:
        # cap the cartesian product: drop non-argmax employed choices in
        # ascending probability order until the product fits (one stable
        # argsort; ties resolve group-major, choice-major)
        gis, cis, ps = [], [], []
        for gi, (g, e) in enumerate(zip(groups, employed)):
            am = int(np.argmax(g))
            for ci in e:
                if ci != am:
                    gis.append(gi)
                    cis.append(int(ci))
                    ps.append(g[ci])
        dropped = [set() for _ in groups]
        for k in np.argsort(np.asarray(ps), kind="stable"):
            if product <= max_candidates:
                break
            gi = gis[k]
            dropped[gi].add(cis[k])
            product = product // counts[gi] * (counts[gi] - 1)
            counts[gi] -= 1
        employed = [
            e[~np.isin(e, sorted(d))] if d else e
            for e, d in zip(employed, dropped)
        ]
    return employed


def enumerate_candidates(
    space: ConfigSpace,
    probs: np.ndarray,
    thresh: float,
    max_candidates: int,
) -> np.ndarray:
    """probs: (onehot_width,) -> (C, n_dims) int candidate index matrix."""
    employed = _trimmed_employed(space, probs, thresh, max_candidates)
    return np.array(list(itertools.product(*employed)), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _enum_core(space: ConfigSpace):
    """Batched enumeration cores on tensors (any device).

    ``masks_core``: probs (T, onehot_width) -> per-group keep masks (T,
    n_dims, max_n) + counts (T, n_dims) + totals (T,), applying the same
    threshold/argmax/trim rules as the host ``enumerate_candidates``.  The
    host trim drops droppable slots in ascending-probability order while
    the product exceeds the cap, so the dropped set is a prefix of that
    order: its length is found from the products after every prefix at
    once (no sequential scan), in int64 (max product 7**12 fits).
    ``radix_core``: the kept sets -> the mixed-radix (table, stride) pair
    whose digit arithmetic unravels the product in ``itertools.product``
    order.
    """
    n_groups, mx = space.n_dims, space.max_group_size

    def masks_core(probs: torch.Tensor, thresh: float, cap: int):
        t = probs.shape[0]
        tab = device_tables(space, probs.device)
        padded, _ = space.split_groups_padded(probs, fill=float("-inf"))
        am = torch.argmax(padded, dim=-1)
        am_oh = torch.arange(mx, device=probs.device) == am[..., None]
        emp = (tab.mask & (padded > thresh)) | am_oh    # argmax always kept
        droppable = (emp & ~am_oh).reshape(t, -1)
        p_flat = torch.where(droppable, padded.reshape(t, -1), float("inf"))
        order = torch.argsort(p_flat, dim=-1, stable=True)
        n_drop = droppable.sum(-1)
        counts0 = emp.sum(-1)                           # (T, G) int64
        # drops per group after each prefix of the order: (T, S + 1, G)
        slot_group = torch.nn.functional.one_hot(order // mx, n_groups)
        in_drop = (torch.arange(order.shape[1], device=probs.device)[None]
                   < n_drop[:, None])
        cum = torch.cumsum(slot_group * in_drop[..., None], dim=1)
        cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
        prod = torch.prod(counts0[:, None, :] - cum, dim=-1)   # (T, S + 1)
        # first prefix length whose product fits (or every droppable slot)
        fits = prod <= cap
        fits[torch.arange(t, device=probs.device), n_drop] = True
        j = torch.argmax(fits.to(torch.uint8), dim=-1)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(order.shape[1],
                                             device=probs.device).expand_as(order))
        dropped = rank < j[:, None]
        keep = emp & ~dropped.reshape(t, n_groups, mx)
        counts = keep.sum(-1)
        total = torch.prod(counts, dim=-1)
        return keep, counts, total

    def radix_core(keep: torch.Tensor, counts: torch.Tensor):
        # kept slots first, ascending
        table = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
        # row-major strides (last group fastest — itertools.product order)
        rev = torch.cumprod(counts.flip(-1), dim=-1).flip(-1)
        stride = torch.cat([rev[:, 1:], torch.ones_like(rev[:, :1])], dim=-1)
        return table, stride

    return masks_core, radix_core


@functools.lru_cache(maxsize=None)
def _batched_enum_fns(space: ConfigSpace):
    """(masks, unravel) pair of the dense enumeration, over ``_enum_core``:
    ``unravel`` applies the mixed-radix digit arithmetic to the whole
    [0, c_pad) index range, giving the (T, c_pad, n_dims) padded candidate
    tensor and its (T, c_pad) validity mask."""
    masks_core, radix_core = _enum_core(space)

    def unravel(keep, counts, total, c_pad: int):
        table, stride = radix_core(keep, counts)
        j = torch.arange(c_pad, dtype=torch.int64, device=keep.device)
        digit = (j[None, :, None] // stride[:, None, :]) % counts[:, None, :]
        cand = torch.gather(table, 2, digit.transpose(1, 2)).transpose(1, 2)
        valid = j[None, :] < total[:, None]
        return cand.to(torch.int32), valid

    return masks_core, unravel


def enumerate_candidates_batch(
    space: ConfigSpace,
    probs: torch.Tensor,
    thresh: float,
    max_candidates: int,
) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Batched twin of ``enumerate_candidates``, on the probs' device.

    probs (T, onehot_width) float32 tensor ->
      cand  (T, C_pad, n_dims) int32 candidate indices,
      valid (T, C_pad) bool mask of real (non-padding) rows,
      counts (T,) host int per-task candidate counts.

    Row t's first counts[t] candidates equal ``enumerate_candidates`` on
    probs[t] exactly.  C_pad is the next power of two >= max(counts) (at
    least 2): a padding row is never valid, so a task's candidates and
    Selection do not depend on the batch it rides in.  Picking C_pad
    reads the counts on the host once per call.
    """
    assert space.max_group_size <= 1024 and 1 <= max_candidates <= _DENSE_LIM, \
        "dense route needs max group size <= 1024 and cap <= 2**20 " \
        "(use the fused tiled route for larger caps)"
    masks, unravel = _batched_enum_fns(space)
    keep, counts, total = masks(probs, thresh, max_candidates)
    counts_host = total.to(torch.int32).cpu().numpy()
    c_pad = pow2_bucket(int(counts_host.max(initial=1)))
    cand, valid = unravel(keep, counts, total, c_pad)
    return cand, valid, counts_host


def flatten_task_draws(net_enc: torch.Tensor, obj_enc: torch.Tensor,
                       keys: torch.Tensor, n_samples: int, noise_fn):
    """THE (task, sample) -> row-batch layout of the forward: sample s of
    task t draws from ``fold_in(keys[t], s)``.  noise_fn(keys (T, S, 2)) ->
    (T, S, noise_dim).  Returns (net_rows, obj_rows, noise_rows), each
    (T * n_samples, ·), task-major."""
    t = net_enc.shape[0]
    s = torch.arange(n_samples, dtype=torch.int64, device=keys.device)
    noise = noise_fn(prng.fold_in(keys[:, None, :], s[None, :]))
    rep = lambda a: a[:, None].expand(t, n_samples, a.shape[-1]) \
        .reshape(t * n_samples, -1)
    return rep(net_enc), rep(obj_enc), noise.reshape(t * n_samples, -1)


@dataclasses.dataclass
class Explorer:
    """Trained-G wrapper: task -> candidate configuration sets, on
    ``device`` (None: the card, see `resolve_device`); ``g_params`` must
    already lie there."""

    model: DesignModel
    ds: Dataset                 # carries the normalizers
    g_params: dict
    gan_cfg: G.GANConfig
    cfg: ExplorerConfig = dataclasses.field(default_factory=ExplorerConfig)
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def generator_probs_device(self, net_idx: np.ndarray, lat_obj, pow_obj,
                               seed=0) -> torch.Tensor:
        """G forward for a task batch: (T, onehot_width) mean probs on the
        explorer's device.

        Task row t draws its noise from PRNGKey(seed + t) — or PRNGKey
        (seed[t]) for a per-task seed array — so row t equals a single-task
        call with that seed: batching never changes a task's candidates.
        The (task, sample) draws are flattened into one row batch and G runs
        once over it (the whole-MLP kernel on the card).
        """
        net_enc = self.ds.net_encoded(self.model, np.atleast_2d(net_idx))
        obj_enc = self.ds.obj_encoded(np.atleast_1d(lat_obj),
                                      np.atleast_1d(pow_obj))
        t, n_s = net_enc.shape[0], self.cfg.noise_samples
        keys = task_keys(seed, t)
        net_r, obj_r, noise_r = flatten_task_draws(
            torch.from_numpy(net_enc), torch.from_numpy(obj_enc), keys, n_s,
            lambda k: G.sample_noise(k, self.gan_cfg))
        probs = G.generator_apply(
            self.g_params, self.model.space, net_r.to(self.device),
            obj_r.to(self.device), noise_r.to(self.device),
            use_fused=self.gan_cfg.use_fused, chained=True)
        return probs.reshape(t, n_s, -1).mean(dim=1)

    def generator_probs(self, net_idx: np.ndarray, lat_obj, pow_obj,
                        seed=0) -> np.ndarray:
        """Host-array view of `generator_probs_device`."""
        return self.generator_probs_device(
            net_idx, lat_obj, pow_obj, seed).cpu().numpy()

    def candidates(self, net_idx: np.ndarray, lat_obj: float, pow_obj: float,
                   seed=0) -> np.ndarray:
        probs = self.generator_probs(net_idx, lat_obj, pow_obj, seed)[0]
        return enumerate_candidates(
            self.model.space, probs, self.cfg.prob_threshold,
            self.cfg.max_candidates)
