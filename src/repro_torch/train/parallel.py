"""The collectives of serving and training across a 'model' axis, and
the layout the layers read.

Each rank holds its block of every param leaf (``param_specs(fsdp)``,
FSDP's by default) and decode-state leaf (``state_specs``),
``train/shardings.shard_params`` and ``shard_states``.  The layers
compute on those blocks and meet the other ranks' through c10d's
``all_gather`` and ``all_reduce`` alone (no reduce-scatter: gloo has
none), each wrapped as an autograd Function whose backward depends on
what consumes its output:

  gather_dim(t, dim, group)   # the blocks of every rank, concatenated;
                              # backward: the gradient summed over the
                              # group (the consumer is rank-local work),
                              # then this rank's block; with
                              # grad_group=None (a replicated consumer)
                              # the block alone
  sum_over(t, group)          # partial sums -> the sum, out of place
                              # (a row-parallel exit); backward: identity
  enter_local(t, group)       # identity (the replicated residual stream,
                              # or a replicated leaf, entering rank-local
                              # work); backward: the sum over the group
  keep_block(t, dim, ax)      # this rank's block (an ``act_shard`` save
                              # point); backward: the blocks gathered
  max_over(t, group)          # the elementwise max, in place, no
                              # gradient (a softmax's stabiliser)

On top of them: ``project`` (a column-split weight's product with every
column, the weight or the product gathered), ``column_blocks`` (a rank's
block of each part of a side-by-side layout: hymba's x | z, xlstm's
q | k | v) and ``rmsnorm_blocks`` (an RMSNorm over a feature dim split
over 'model': the sum of squares summed).

Megatron's f and g are ``enter_local`` and ``sum_over``: between them a
rank's gradients are partial, outside them replicated and complete.  So
every rank issues the same collectives in the same order in the backward
too (autograd runs the nodes of one graph in reverse creation order), as
long as each rank builds the same Functions in the same order: a layer
with no work on a rank still passes its input through an op (``x · 0``),
never a fresh ``zeros_like``.  A group of None is one rank: each is then
the identity.  The group of an axis comes from ``launch/mesh.axis_group``.

``model_axis()`` is the 'model' axis of the mesh that the running step
installed (``shardings.use_mesh``), as (group, coordinate, size), or None
where there is none larger than 1: the layers then run as on one rank.
``unshard_data(tree, specs)`` gathers every leaf's FSDP dims (its
'pod'/'data' entries) just before a layer uses it, the copy dropped with
the layer; its backward sums the gradient over the batch axes the step
split its rows over (FSDP's reduce-scatter) and takes the rank's block,
and where the rows did not split (every rank computed the whole batch)
takes the block alone.  ``finish_grads`` then sums each leaf's gradient
over the split axes its spec does not shard, and ``global_norm`` is the
norm of the whole gradient from the blocks.  ``param_layout(m, mesh,
fsdp)`` is the spec tree of a model's params and ``state_layout`` that of
its decode states, from their full shapes on the meta device, out of a
counter's sight; ``relayout`` moves a state leaf's block between two
specs.
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


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (contiguous), in the group's rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced over the group, in place."""
    dist.all_reduce(t, op=op, group=group)
    return t


def _block(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, grad_group):
        ctx.dim, ctx.group, ctx.grad_group = dim, group, grad_group
        return torch.cat(_all_gather(t, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_group is not None:
            g = _all_reduce(g.contiguous().clone(), ctx.grad_group)
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(t, dim, group).clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.group), dim=ctx.dim), None, None


def _graph(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


#: ``gather_dim``'s default `grad_group`: the gather's own group
OWN = object()


def gather_dim(t: torch.Tensor, dim: int, group,
               grad_group=OWN) -> torch.Tensor:
    """Every rank's `t` along `dim`, in the group's rank order.  Its
    gradient is summed over `grad_group` before this rank's block is
    taken: by default over the gather's own group (the consumer computes
    rank-local work: a gathered weight or activation), with None only
    cut (the consumer is replicated over the group)."""
    if group is None:
        return t
    if _graph(t):
        return _Gather.apply(t, dim, group,
                             group if grad_group is OWN else grad_group)
    return torch.cat(_all_gather(t, group), dim=dim)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the group's ranks: the exit of rank-local work
    (a row-parallel product's partial sums), whose gradient passes
    through unchanged.  In place where no gradient is taken."""
    if group is None:
        return t
    if _graph(t):
        return _Sum.apply(t, group)
    return _all_reduce(t, group)


def enter_local(t: torch.Tensor, group) -> torch.Tensor:
    """`t`, replicated over the group, as the input of rank-local work
    (Megatron's f): the identity, whose gradient is summed over the
    group."""
    if group is None or not _graph(t):
        return t
    return _Enter.apply(t, group)


def keep_block(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of `t` (replicated over the group) along `dim`, a
    copy: what an ``act_shard`` save point keeps; its gradient is the
    ranks' blocks gathered.  ``gather_dim(.., grad_group=None)`` undoes
    it."""
    if group is None:
        return t
    if _graph(t):
        return _Keep.apply(t, dim, group)
    return _block(t, dim, group).clone()


def project(x: torch.Tensor, w: torch.Tensor, cols: int, ax: ModelAxis,
            local: bool) -> torch.Tensor:
    """``x @ w`` with all `cols` output columns where `w` holds this rank's
    column block: the weight gathered where x has more rows than w (a
    prefill, a train step), else the product's columns (a decode step).
    `local`: whether the consumer is rank-local work, so the gather's
    gradient is summed over 'model' (``gather_dim``).  A gathered product
    gives each rank x's gradient through its columns alone, so for a
    replicated consumer x enters as rank-local work (``enter_local``: the
    ranks' parts summed)."""
    if w.shape[-1] == cols:
        return x @ w
    grad_group = ax.group if local else None
    if x.numel() // x.shape[-1] > w.shape[0]:
        return x @ gather_dim(w, -1, ax.group, grad_group)
    if not local:
        x = enter_local(x, ax.group)
    return gather_dim(x @ w, -1, ax.group, grad_group)


def column_blocks(x: torch.Tensor, w: torch.Tensor, width: int, parts: int,
                  ax: ModelAxis) -> torch.Tensor:
    """``x @ w[:, cols]`` for the columns of this rank's block of each of
    the `parts` contiguous blocks of `width` columns that a layout lays
    side by side (hymba's x | z, xlstm's q | k | v), where `w` holds this
    rank's block of all ``parts · width`` columns (not the rank's block of
    each part): its columns gathered first (rank-local work, so the
    gather's gradient is summed over 'model'), or at a decode step the
    product's."""
    n = width // ax.size
    lo = ax.rank * n

    def pick(t):
        return torch.cat([t[..., p * width + lo:p * width + lo + n]
                          for p in range(parts)], dim=-1)

    if x.numel() // x.shape[-1] > w.shape[0]:
        return x @ pick(gather_dim(w, -1, ax.group))
    return pick(gather_dim(x @ w, -1, ax.group))


def rmsnorm_blocks(params, h: torch.Tensor, d: int, ax: ModelAxis,
                   eps: float = 1e-6) -> torch.Tensor:
    """``nn/layers.rmsnorm_apply`` over a width-`d` feature dim of which
    `h` (.., d/m) is this rank's block (rank-local work): the sum of
    squares summed over 'model' and entered again (its gradient is every
    rank's), the scale's block from the whole entered scale."""
    hf = h.to(torch.float32)
    ss = enter_local(sum_over(hf.square().sum(-1, keepdim=True), ax.group),
                     ax.group)
    n = h.shape[-1]
    scale = enter_local(params["scale"], ax.group)[ax.rank * n:
                                                   (ax.rank + 1) * n]
    return (h * torch.rsqrt(ss / d + eps) * scale).to(h.dtype)


def max_over(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over the group's ranks, in place (no
    gradient)."""
    if group is not None:
        _all_reduce(t, group, dist.ReduceOp.MAX)
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


def split_axes(mesh):
    """The batch axes the running step split its rows over
    (``shardings.current_split``, ``batch_axes_for``'s rule), or None."""
    k = SH.current_split()
    if k <= 1:
        return None
    ba = SH.norm_axes(SH.batch_axes(mesh), mesh)
    if ba is not None and SH.axis_size(mesh, ba) == k:
        return ba
    return SH.norm_axes("data", mesh)


def _batch_entries(spec, mesh):
    """(dim, axes) of each entry of `spec` on the batch axes alone."""
    batch = set(SH.batch_axes(mesh))
    out = []
    for d, entry in enumerate(spec):
        axes = SH.norm_axes(entry, mesh)
        if axes is not None and batch.issuperset(axes):
            out.append((d, axes))
    return out


def unshard_data(tree, specs):
    """`tree` (a rank's blocks) with every dim that its spec puts on the
    batch axes ('pod', 'data': FSDP) gathered over them, so each leaf is
    sharded over 'model' at most.  Leaves whose specs hold no batch axis
    are passed through.  A gathered leaf's gradient is summed over the
    axes the step split its rows over, then cut to this rank's block."""
    mesh = SH.current_mesh()
    split = set(split_axes(mesh) or ())

    def one(t, spec):
        for d, axes in _batch_entries(spec, mesh):
            summed = tuple(a for a in axes if a in split)
            t = gather_dim(t, d, axis(mesh, axes).group, grad_group=(
                axis(mesh, summed).group if summed else None))
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


def _by_axes(leaves, axes_of) -> dict:
    """{axes: [leaf index, ...]} of the leaves with an axes tuple."""
    groups: dict = {}
    for i, t in enumerate(leaves):
        axes = axes_of(i)
        if axes:
            groups.setdefault(axes, []).append(i)
    return groups


def finish_grads(grads: list, specs: list, mesh) -> list:
    """The gradient blocks `grads` (one a leaf of `specs`) summed over the
    split batch axes (``split_axes``) that their specs do not put on a
    dim: those leaves' gradients are partial sums of the rows of each
    rank, where ``unshard_data``'s backward has already summed the
    sharded ones.  One collective an axes set, the leaves flattened into
    one buffer."""
    split = split_axes(mesh)
    if split is None:
        return grads

    def axes_of(i):
        done = {a for _, axes in _batch_entries(specs[i], mesh)
                for a in axes}
        return tuple(a for a in split if a not in done)

    grads = list(grads)
    for axes, idx in _by_axes(grads, axes_of).items():
        flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                           axis(mesh, axes).group)
        o = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[o:o + n].view_as(grads[i])
            o += n
    return grads


def global_norm(grads: list, specs: list, mesh) -> torch.Tensor:
    """The norm of the whole gradient from this rank's blocks: each
    leaf's sum of squares summed over the mesh axes its spec shards it
    over and no other (a leaf replicated over an axis counts once), the
    leaves that share those axes in one collective.  The same value on
    every rank."""
    order = list(SH.mesh_sizes(mesh))

    def axes_of(i):
        axes = {a for entry in specs[i]
                for a in (SH.norm_axes(entry, mesh) or ())}
        return tuple(a for a in order if a in axes)

    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    groups = _by_axes(grads, axes_of)
    sharded = {i for idx in groups.values() for i in idx}
    for i, g in enumerate(grads):
        if i not in sharded:
            total = total + torch.sum(torch.square(g.float()))
    for axes, idx in sorted(groups.items()):
        part = sum(torch.sum(torch.square(grads[i].float()))
                   for i in idx).reshape(1)
        for a in axes:          # the sum over the axes, one at a time
            part = _all_reduce(part, axis(mesh, a).group)
        total = total + part[0]
    return torch.sqrt(total)


def drop_layer_axis(specs):
    """The specs of one layer of a (repeats, ...) stacked spec tree."""
    if isinstance(specs, SH.P):
        return SH.P(*specs[1:])
    if isinstance(specs, dict):
        return {k: drop_layer_axis(v) for k, v in specs.items()}
    return type(specs)(drop_layer_axis(v) for v in specs)


def _param_structs(m):
    from repro_torch.core import prng
    from repro_torch.models import base as MB

    return MB.init_params(prng.prng_key(torch.tensor(0)), m,
                          torch.device("meta"))


@functools.lru_cache(maxsize=16)
def _layout(m, sizes: tuple, fsdp: bool):
    return SH.param_specs(_param_structs(m), SH.Sizes(sizes), fsdp=fsdp)


@functools.lru_cache(maxsize=16)
def _state_layout(m, sizes: tuple, batch: int, cache_len: int):
    from repro_torch.models import base as MB

    states = MB.init_decode_state(_param_structs(m), m, batch, cache_len)
    return SH.state_specs(states, SH.Sizes(sizes), batch)


def _unseen(fn, *args):
    """``fn(*args)`` with no dispatch mode in effect: the structs it makes
    on meta are set-up, which a counter (``utils/op_cost``) running the
    step must not see."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return fn(*args)


def param_layout(m, mesh, fsdp: bool = True):
    """``param_specs(fsdp=fsdp)`` of `m`'s params on `mesh`, from their
    full shapes (``init_params`` on meta), cached by model, mesh shape
    and `fsdp`."""
    return _unseen(_layout, m, tuple(SH.mesh_sizes(mesh).items()),
                   bool(fsdp))


def current_layout(m):
    """``param_layout`` of `m` on the running step's mesh, by its
    ``fsdp``."""
    return param_layout(m, SH.current_mesh(), SH.current_fsdp())


def state_layout(m, mesh, batch: int, cache_len: int):
    """``state_specs`` of `m`'s decode states for `batch` lanes and a
    cache of `cache_len` on `mesh`, from their full shapes (on meta),
    cached by model, mesh shape, batch and cache length."""
    return _unseen(_state_layout, m, tuple(SH.mesh_sizes(mesh).items()),
                   int(batch), int(cache_len))


def relayout(t: torch.Tensor, have: SH.P, want: SH.P, mesh) -> torch.Tensor:
    """This rank's block of a leaf under `want`, from its block `t` under
    `have`: every dim whose entries differ gathered over `have`'s axes,
    all of them before any is cut (a dim cut first would gather other
    ranks' different blocks), then cut to this rank's block of `want`'s.
    No gradient (a decode step's state)."""
    changed = [d for d, (h, w) in enumerate(zip(have, want))
               if SH.norm_axes(h, mesh) != SH.norm_axes(w, mesh)]
    for d in changed:
        if SH.norm_axes(have[d], mesh) is not None:
            t = gather_dim(t, d, axis(mesh, have[d]).group)
    for d in changed:
        if SH.norm_axes(want[d], mesh) is not None:
            t = rows(t, axis(mesh, want[d]), d)
    return t


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
