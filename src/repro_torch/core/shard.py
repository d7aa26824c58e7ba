"""Task-axis sharding over a device mesh: the multi-rank DSE scale-out,
the twin of the reference's ``core/shard.py``.

Every batched DSE route (``GANDSE.explore_batch``, ``select_batch``, the
fused select, the MLP/SA/DRL device routes) computes independent task
lanes, so the task axis splits over the mesh's batch axes ('pod', 'data')
with no change to any lane's numbers: each rank computes its block of
rows, the results are all-gathered in task order, and every rank returns
what one device returns (sharded and one-rank Selections are the same
bits).

    from repro_torch.core import shard
    from repro_torch.launch.mesh import make_host_mesh

    shard.set_task_mesh(make_host_mesh())       # or the task_mesh() context
    results = engine.explore_tasks(tasks)       # now sharded over the mesh

Mechanics, shared by every route (``map_rows``):

1. the task batch is padded to a multiple of the shard count with the
   serve batcher's repeat-last-row rule (``pad_tasks``; padded lanes are
   computed and discarded, and per-row seeds pad along, so real rows keep
   their placement-independent noise streams);
2. each rank takes its block of rows (``put_sharded``), runs the route on
   it with the mesh switched off for that thread (nothing shards twice),
   and ``gather_objects`` puts the per-row results back in task order.

Training rides the same mesh through ``train_gan(..., mesh=...)``: the
params are replicated (``replicate``), each rank computes its rows of the
batch, and the gradients are all-reduced.

On a mesh with a 'model' axis larger than 1 the task axis still splits
over the batch axes alone, as the reference's specs split it (the DSE
models are replicated over 'model'): the ranks of one 'model' group
compute the same rows, the rows and the gradients are gathered and summed
over this rank's batch-axes group (``task_group``), and ``replicate``
broadcasts over the whole mesh.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.shardings import (axis_size, batch_axes, model_axis,
                                         norm_axes)

_STATE = {"mesh": None}
#: set while a thread runs one rank's rows, so inner routes do not shard
_LOCAL = threading.local()


def set_task_mesh(mesh):
    """Install `mesh` as the process-wide task mesh (None disables
    sharding); returns the previous mesh so callers can restore it."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    return prev


def get_task_mesh():
    return _STATE["mesh"]


@contextlib.contextmanager
def task_mesh(mesh):
    """Scoped ``set_task_mesh`` (tests, benchmarks)."""
    prev = set_task_mesh(mesh)
    try:
        yield mesh
    finally:
        set_task_mesh(prev)


def task_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The mesh axes the task dim shards over: ('pod', 'data') normalized
    to the axes present at size > 1 (None when there are none — a
    model-only or one-rank mesh)."""
    if mesh is None:
        return None
    return norm_axes(batch_axes(mesh), mesh)


def n_task_shards(mesh) -> int:
    """How many ways the task axis splits on `mesh` (1 = unsharded)."""
    axes = task_axes(mesh)
    return axis_size(mesh, axes) if axes else 1


def active_n_shards() -> int:
    """Shard count of the active task mesh (1 when none is set) — what the
    serve micro-batcher sizes batches by."""
    return n_task_shards(get_task_mesh())


def pow2_bucket(n: int, floor: int = 2) -> int:
    """Smallest power of two >= max(n, floor)."""
    return 1 << (max(int(n), floor) - 1).bit_length()


def pad_rows(n: int, multiple: int) -> Optional[np.ndarray]:
    """Row gather padding `n` up to the next multiple with the
    repeat-last-row rule; None when already aligned."""
    if multiple <= 1 or n % multiple == 0:
        return None
    target = ((n + multiple - 1) // multiple) * multiple
    return np.concatenate([np.arange(n), np.full(target - n, n - 1)])


def pad_tasks(tasks, seeds: np.ndarray, mesh=None):
    """Pad a task batch (and its per-row seed array) to the batcher's
    bucket: ``n_shards * pow2_bucket(ceil(n / n_shards))`` (plain pow2 when
    no mesh is active).  Returns ``(tasks, seeds, n_real)``.  Padded rows
    repeat the last real row, seed included; their results are computed
    and discarded."""
    mesh = get_task_mesh() if mesh is None else mesh
    n = len(tasks)
    if n == 0:
        return tasks, seeds, 0
    shards = max(n_task_shards(mesh), 1)
    target = shards * pow2_bucket(-(-n // shards), floor=1)
    rows = pad_rows(n, target)
    if rows is None:
        return tasks, seeds, n
    return tasks.take(rows), np.asarray(seeds)[rows], n


# ---------------------------------------------------------------------------
# this rank's rows, and the gathers back
# ---------------------------------------------------------------------------
def task_group(mesh):
    """The process group the task axis splits over: every rank of `mesh`
    where its 'model' axis is 1, else this rank's group along the batch
    axes (``launch/mesh.axis_group``)."""
    from repro_torch.launch.mesh import axis_group, flat_group

    if model_axis(mesh) <= 1:
        return flat_group(mesh)
    return axis_group(mesh, task_axes(mesh))[0]


def shard_index(mesh) -> int:
    """This rank's block of the task axis (its rank in ``task_group``)."""
    import torch.distributed as dist

    return dist.get_rank(task_group(mesh))


def _sharded(mesh, n: int) -> bool:
    """Whether `n` rows split over `mesh`: a mesh with task axes whose
    shard count divides n, outside another rank-local call."""
    k = n_task_shards(mesh)
    return k > 1 and n % k == 0 and not getattr(_LOCAL, "inner", False)


def _take(x, rows: slice, axis: int = 0):
    if hasattr(x, "take") and not isinstance(x, (np.ndarray, torch.Tensor)):
        return x.take(np.arange(rows.start, rows.stop))       # a DSETask
    index = [slice(None)] * axis + [rows]
    return x[tuple(index)]


def put_sharded(x, mesh=None, axis: int = 0):
    """This rank's block of `x`'s `axis` dim (numpy, a tensor or a
    DSETask).  `x` itself when no mesh is active, the mesh has no task
    axes, or the dim does not divide the shard count."""
    mesh = get_task_mesh() if mesh is None else mesh
    n = len(x) if axis == 0 else x.shape[axis]
    if not _sharded(mesh, n):
        return x
    k = n_task_shards(mesh)
    r = shard_index(mesh)
    return _take(x, slice(r * (n // k), (r + 1) * (n // k)), axis)


def gather_objects(items: list, mesh=None) -> list:
    """All-gather each rank's list of per-row results (any picklable
    values) and concatenate them in rank order: the whole task axis."""
    import torch.distributed as dist

    mesh = get_task_mesh() if mesh is None else mesh
    group = task_group(mesh)
    out: List[Optional[list]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, list(items), group=group)
    return [item for part in out for item in part]


def all_reduce(tree, mesh=None):
    """Every tensor leaf of `tree` summed over the mesh's ranks, in one
    collective (the leaves flattened into one buffer); a new tree."""
    import torch.distributed as dist

    from repro_torch.optim import tree_leaves, tree_unflatten

    mesh = get_task_mesh() if mesh is None else mesh
    leaves = tree_leaves(tree)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    dist.all_reduce(flat, group=task_group(mesh))
    out, i = [], 0
    for t in leaves:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return tree_unflatten(tree, out)


@contextlib.contextmanager
def _rank_local():
    """Within the block, routes called by this thread do not shard."""
    prev = getattr(_LOCAL, "inner", False)
    _LOCAL.inner = True
    try:
        yield
    finally:
        _LOCAL.inner = prev


def map_rows(fn: Callable[..., list], *rows, mesh=None) -> list:
    """``fn(*rows)`` -> one result a row, over the task mesh: each rank
    runs `fn` on its block of every argument's rows and the per-row
    results are gathered in task order.  Runs `fn` on all rows where the
    rows do not split (no mesh, one shard, a count the shards do not
    divide, or already inside one rank's block)."""
    mesh = get_task_mesh() if mesh is None else mesh
    if not _sharded(mesh, len(rows[0])):
        return fn(*rows)
    mine = [put_sharded(r, mesh) for r in rows]
    with _rank_local():
        out = fn(*mine)
    return gather_objects(out, mesh)


def map_tasks(fn: Callable[[object, np.ndarray], list], tasks,
              seeds: np.ndarray, mesh=None) -> list:
    """The batched DSE routes' shard-and-gather: pad `tasks` and their
    per-row `seeds` (``pad_tasks``), run ``fn(tasks, seeds)`` -> one result
    a row over the mesh (``map_rows``), and drop the padded rows."""
    tasks_p, seeds_p, n_real = pad_tasks(tasks, seeds, mesh)
    return map_rows(fn, tasks_p, seeds_p, mesh=mesh)[:n_real]


def replicate(tree, mesh=None):
    """Broadcast every tensor of `tree` (params, optimizer state) from the
    mesh's first rank to all of its ranks, in place, so every rank holds
    the same values.  The identity when no mesh is active or the mesh has
    one shard."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import flat_group
    from repro_torch.optim import tree_leaves

    mesh = get_task_mesh() if mesh is None else mesh
    if n_task_shards(mesh) <= 1:
        return tree
    group = flat_group(mesh)
    src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD \
        else 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=src, group=group)
    return tree
