"""The forward collectives of serving across a 'model' axis, and the
layout the layers read.

Each rank holds its block of every param leaf (``param_specs(fsdp=True)``)
and decode-state leaf (``state_specs``), ``train/shardings.shard_params``
and ``shard_states``.  The layers compute on those blocks and meet the
other ranks' through three collectives, built on c10d's ``all_gather``
and ``all_reduce`` alone, with no autograd (serving only; ROADMAP Queue 1
item 6b):

  gather_dim(t, dim, group)   # the blocks of every rank, concatenated
  sum_over(t, group)          # partial sums -> the sum, in place
  max_over(t, group)          # the elementwise max, in place

A group of None is one rank: each is then the identity.  The group of an
axis comes from ``launch/mesh.axis_group``.

``model_axis()`` is the 'model' axis of the mesh that the running step
installed (``shardings.use_mesh``), as (group, coordinate, size), or None
where there is none larger than 1: the layers then run as on one rank.
``unshard_data(tree, specs)`` gathers every leaf's FSDP dims (its
'pod'/'data' entries) just before a layer uses it; the copy is dropped
with the layer.  ``param_layout(m, mesh)`` is the spec tree of a model's
params, from their full shapes on the meta device.
"""
from __future__ import annotations

import collections
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.train import shardings as SH

ModelAxis = collections.namedtuple("ModelAxis", "group rank size")


class Owned:
    """One layer's sub-tree whose stacked leaves put the layer axis on
    'model': ``mine`` on the rank that stores the layer (``tree`` its
    leaves), else ``tree`` is None."""

    def __init__(self, tree, mine: bool):
        self.tree, self.mine = tree, mine


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `t` along `dim`, in the group's rank order."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the group's ranks, in place."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def max_over(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over the group's ranks, in place."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def axis(mesh, name) -> ModelAxis:
    """(group, coordinate, size) of this rank along `name` (an axis or a
    tuple of axes) of `mesh`."""
    from repro_torch.launch.mesh import axis_group

    group, coord = axis_group(mesh, name)
    size = 1 if group is None else SH.axis_size(mesh,
                                                 SH.norm_axes(name, mesh))
    return ModelAxis(group, coord, size)


def model_axis() -> Optional[ModelAxis]:
    """The running step's 'model' axis, or None (no mesh, or one of
    size 1)."""
    mesh = SH.current_mesh()
    if SH.model_axis(mesh) <= 1:
        return None
    return axis(mesh, "model")


def unshard_data(tree, specs):
    """`tree` (a rank's blocks) with every dim that its spec puts on the
    batch axes ('pod', 'data': FSDP) gathered over them, so each leaf is
    sharded over 'model' at most.  Leaves whose specs hold no batch axis
    are passed through."""
    mesh = SH.current_mesh()
    batch = set(SH.batch_axes(mesh))

    def one(t, spec):
        for d, entry in enumerate(spec):
            axes = SH.norm_axes(entry, mesh)
            if axes is not None and batch.issuperset(axes):
                t = gather_dim(t, d, axis(mesh, axes).group)
        return t

    def walk(x, s):
        if isinstance(x, Owned):
            return Owned(walk(x.tree, s), True) if x.mine else x
        if isinstance(x, dict):
            return {k: walk(x[k], s[k]) for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(a, b) for a, b in zip(x, s))
        return one(x, s) if isinstance(x, torch.Tensor) else x

    return walk(tree, specs)


def drop_layer_axis(specs):
    """The specs of one layer of a (repeats, ...) stacked spec tree."""
    if isinstance(specs, SH.P):
        return SH.P(*specs[1:])
    if isinstance(specs, dict):
        return {k: drop_layer_axis(v) for k, v in specs.items()}
    return type(specs)(drop_layer_axis(v) for v in specs)


@functools.lru_cache(maxsize=16)
def _layout(m, sizes: tuple):
    from repro_torch.core import prng
    from repro_torch.models import base as MB

    class Sizes:
        shape = dict(sizes)

    structs = MB.init_params(prng.prng_key(torch.tensor(0)), m,
                             torch.device("meta"))
    return SH.param_specs(structs, Sizes(), fsdp=True)


def param_layout(m, mesh):
    """``param_specs(fsdp=True)`` of `m`'s params on `mesh`, from their
    full shapes (``init_params`` on meta), cached by model and mesh
    shape."""
    return _layout(m, tuple(SH.mesh_sizes(mesh).items()))


def batch_axes_for(mesh, batch: int):
    """The axes a batch of `batch` rows splits over: the batch axes where
    their product divides it, else 'data' where that divides it, else
    None (the rule of ``step.batch_specs`` and of ``state_spec``'s batch
    dim)."""
    ba = SH.norm_axes(SH.batch_axes(mesh), mesh)
    if ba is not None and batch % SH.axis_size(mesh, ba) == 0:
        return ba
    data = SH.norm_axes("data", mesh)
    if data is not None and batch % SH.axis_size(mesh, data) == 0:
        return data
    return None


def rows(x: torch.Tensor, ax: ModelAxis, dim: int = 0) -> torch.Tensor:
    """This rank's block of `x` along `dim` on the axis `ax`."""
    if ax.size <= 1:
        return x
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)
