"""Sharding rules for params, optimizer state, activations and caches: the
twin of the reference's ``train/shardings.py``, rule for rule.

Strategy (FSDP x TP hybrid, the reference's default):
  * weights: the feature/output dim of every projection goes to the
    'model' mesh axis (Megatron TP); the other large dim to 'data'
    (ZeRO/FSDP).  The 'pod' axis is pure data parallel.
  * activations: the residual stream at layer boundaries is sharded
    (batch -> ('pod', 'data'), d_model -> 'model').
  * caches and recurrent state: batch over ('pod', 'data') when it
    divides; else the sequence dim goes to 'data' and the head or feature
    dim to 'model'.

Every rule checks divisibility and falls back to replication.

A spec is `P`, a tuple with one entry a dim: None (replicated), an axis
name, or a tuple of names.  The rules read only the mesh's axis names and
sizes (``mesh_sizes``): a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names`` and ``shape``), or any object whose ``shape`` is a
mapping of name to size (the reference's ``AbstractMesh``, a test's fake).

What the port executes of these rules: the batch axes ('pod', 'data') are
data parallel (``core/shard``, ``core/train``, ``train/step``).  Across a
'model' axis larger than 1 the port serves and trains (``train/step``'s
steps, ``launch/serve.Engine``): each rank stores exactly its block of
every leaf, ``shard_params`` under ``param_specs(fsdp=True)`` and
``shard_states`` under ``state_specs`` (``local_block`` cuts one leaf,
``gather_leaf`` puts one back together), and the layers compute on those
blocks with explicit collectives under autograd (``train/parallel``);
the residual stream's ``act_shard`` policy applies at the remat save
points (``models/base._forward_sharded``), every ported arch's blocks
included.  ``placements`` turns a spec into
``Shard``/``Replicate`` placements for state that is placed with
DTensor.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.optim import tree_leaves


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    A one-name tuple entry is stored as the name and an empty one as None,
    as the reference's ``PartitionSpec`` stores them, so a spec equals the
    reference's read as a tuple."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, (canon(e) for e in entries))

    def __repr__(self):
        return "P" + super().__repr__()


# ---------------------------------------------------------------------------
# mesh context (lets model code read the mesh without carrying it)
# ---------------------------------------------------------------------------
#: mesh: the active mesh; act_shard: the residual stream's policy; split:
#: how many ways the running step split its batch over the batch axes (1:
#: every rank holds the whole batch), which ``nn/moe`` reads to place the
#: reference's token groups; fsdp: whether the params' blocks are
#: ``param_specs(fsdp=True)``'s (the layers read their layout from it)
_CTX: Dict[str, Any] = {"mesh": None, "act_shard": "model", "split": 1,
                        "fsdp": True}

ACT_SHARD = ("model", "seq", "none")


@contextlib.contextmanager
def use_mesh(mesh, act_shard: str = "model", split: int = 1,
             fsdp: bool = True):
    """act_shard: how the residual stream is sharded at the layer
    boundaries — 'model' (d_model over 'model'), 'seq' (S over 'model')
    or 'none' (replicated); across a 'model' axis the port applies it at
    the remat save points.  fsdp: the ``param_specs`` the params' blocks
    were cut by."""
    if act_shard not in ACT_SHARD:
        raise ValueError(f"act_shard {act_shard!r} is not one of {ACT_SHARD}")
    prev = dict(_CTX)
    _CTX.update(mesh=mesh, act_shard=act_shard, split=int(split),
                fsdp=bool(fsdp))
    try:
        yield
    finally:
        _CTX.update(prev)


def current_mesh():
    return _CTX["mesh"]


def current_split() -> int:
    return _CTX["split"]


def current_act_shard() -> str:
    return _CTX["act_shard"]


def current_fsdp() -> bool:
    return _CTX["fsdp"]


class Sizes:
    """A mesh that the rules read and no collective runs on: its axis
    sizes alone, from a mapping or (name, size) pairs."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of `mesh`, in the mesh's axis order."""
    shape = mesh.shape
    if hasattr(shape, "keys"):
        return {str(k): int(v) for k, v in shape.items()}
    return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names, shape)}


def axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return int(np.prod([axis_size(mesh, n) for n in name]))
    return mesh_sizes(mesh).get(name, 1)


def norm_axes(axes, mesh=None):
    """Normalize a spec entry: drop axes the mesh lacks or holds at size 1,
    and collapse an empty result to None (``P((), ...)`` is no spec)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    if mesh is not None:
        axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    return axes if axes else None


def _div(dim: int, mesh, name) -> bool:
    """True iff `name` names real (present, size > 1) mesh axes whose
    product divides `dim`."""
    name = norm_axes(name, mesh)
    return name is not None and dim % axis_size(mesh, name) == 0


def batch_axes(mesh) -> Tuple[str, ...]:
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> int:
    """The size of `mesh`'s 'model' axis (1 with no mesh)."""
    return 1 if mesh is None else axis_size(mesh, "model")


def activation_spec(mesh, batch: int, d_model: int,
                    seq: Optional[int] = None) -> P:
    """(B, S, D) residual-stream spec (policy set by ``use_mesh``'s
    act_shard)."""
    ba = norm_axes(batch_axes(mesh), mesh)
    b_ax = ba if _div(batch, mesh, ba) \
        else (norm_axes("data", mesh) if _div(batch, mesh, "data") else None)
    policy = _CTX["act_shard"]
    if policy == "seq" and seq is not None and _div(seq, mesh, "model"):
        return P(b_ax, "model", None)
    if policy == "model" and _div(d_model, mesh, "model"):
        return P(b_ax, None, "model")
    return P(b_ax, None, None)


# ---------------------------------------------------------------------------
# parameter rules (matched on the leaf's key name; a leading stacked-layer
# axis pads the spec with None on the left)
# ---------------------------------------------------------------------------
_LAST = {"wq", "wkv", "w_gate", "w_up", "in_proj", "wz", "wqkv", "wx",
         "dt_w", "conv_w", "lm_head", "router"}
_PENULT = {"wo", "w_down", "out_proj", "x_proj", "A_log", "rh"}
_VOCAB_FIRST = {"table", "pos_embed"}       # embed: vocab over 'model'
_VEC_MODEL = {"D_skip", "dt_bias"}          # 1-D inner-dim vectors


def _param_spec(path: str, shape: Tuple[int, ...], mesh,
                fsdp: bool = True) -> P:
    name = path.split("/")[-1]
    rank = len(shape)
    spec = [None] * rank

    def put(dim: int, ax: str):
        if ax == "data" and not fsdp:
            return
        if 0 <= dim < rank and _div(shape[dim], mesh, ax) and spec[dim] is None:
            spec[dim] = ax

    if name in ("w_gate", "w_up", "w_down") and rank >= 3:
        # MoE expert tensors (E, D, F) / (E, F, D): expert parallel when E
        # divides the 'model' axis, else TP on the F dim
        e_dim = rank - 3
        if _div(shape[e_dim], mesh, "model"):
            put(e_dim, "model")
            put(rank - 1 if name != "w_down" else rank - 2, "data")
        elif name in _LAST:
            put(rank - 1, "model")
            put(rank - 2, "data")
        else:
            put(rank - 2, "model")
            put(rank - 1, "data")
    elif name in _LAST and rank >= 2:
        put(rank - 1, "model")
        put(rank - 2, "data")                      # FSDP on the other big dim
    elif name in _PENULT and rank >= 2:
        put(rank - 2, "model")
        put(rank - 1, "data")
    elif name in _VOCAB_FIRST and rank >= 2:
        put(rank - 2, "model")
        put(rank - 1, "data")
    elif name in _VEC_MODEL and rank >= 1:
        put(rank - 1, "model")
    elif rank >= 2 and min(shape[-2:]) >= 256:     # any other big matrix: FSDP
        put(rank - 1, "data")
    return P(*spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_specs(params, mesh, fsdp: bool = True):
    """A tree of `P` like `params` (dicts and lists, the reference's
    layout, so a leaf's path is the reference's).  fsdp=False keeps the
    weights replicated across 'data'."""
    return _map_with_path(
        lambda path, leaf: _param_spec(path, tuple(leaf.shape), mesh,
                                       fsdp=fsdp), params)


# ---------------------------------------------------------------------------
# decode/cache state rules (structural, shape-driven)
# ---------------------------------------------------------------------------
def state_spec(shape: Tuple[int, ...], mesh, batch: int) -> P:
    """Greedy structural spec for a decode-state leaf: a leading layer
    axis, then batch.  (L, B, S, H, D) KV caches, (L, B, H, dh, dh) matrix
    memories, (L, B, D, N) SSM states, (L, B) scalars."""
    rank = len(shape)
    spec = [None] * rank
    if rank < 2:
        return P(*spec)
    used_model = False
    ba = norm_axes(batch_axes(mesh), mesh)
    data_used = False
    if shape[1] == batch and _div(batch, mesh, ba):
        spec[1] = ba
        data_used = True
    elif shape[1] == batch and _div(batch, mesh, "data"):
        spec[1] = norm_axes("data", mesh)
        data_used = True
    # remaining dims, largest first: 'data' (if free) to the largest (the
    # long sequence axis), 'model' to the next largest that divides
    order = sorted(range(2, rank), key=lambda i: -shape[i])
    for i in order:
        if not data_used and shape[i] >= 1024 and _div(shape[i], mesh, "data"):
            spec[i] = "data"
            data_used = True
        elif not used_model and _div(shape[i], mesh, "model") and shape[i] > 1:
            spec[i] = "model"
            used_model = True
    return P(*spec)


def spec_leaves(specs) -> list:
    """The ``P``s of a spec tree in ``tree_leaves``' order (a decode
    state's ``len`` ints dropped)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [p for v in specs.values() for p in spec_leaves(v)]
    if isinstance(specs, (list, tuple)):
        return [p for v in specs for p in spec_leaves(v)]
    return []


def block_bytes(tree, specs, mesh) -> int:
    """The bytes of a rank's blocks of every tensor leaf of the full
    `tree` under `specs` (a tree of ``P``s like it), from the leaves'
    shapes and dtypes and the mesh's axis sizes: what a device holds of
    it."""
    leaves = [t for t in tree_leaves(tree) if hasattr(t, "shape")]
    flat = spec_leaves(specs)
    if len(leaves) != len(flat):
        raise ValueError(f"{len(leaves)} leaves, {len(flat)} specs")
    total = 0
    for t, spec in zip(leaves, flat):
        n = t.element_size()
        for dim, entry in zip(t.shape, spec):
            n *= dim // axis_size(mesh, norm_axes(entry, mesh) or ())
        total += n
    return total


def state_specs(states, mesh, batch: int):
    """``state_spec`` for every tensor leaf of a decode-state tree (ints
    such as a layer's ``len`` are left as they are)."""
    def spec(leaf):
        if hasattr(leaf, "shape"):
            return state_spec(tuple(leaf.shape), mesh, batch)
        return leaf
    return _map_with_path(lambda _, leaf: spec(leaf), states)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------
def placements(spec: P, mesh) -> tuple:
    """One placement a mesh dim for `spec` on the ``DeviceMesh`` `mesh`:
    ``Shard(d)`` on each mesh dim that tensor dim d names, ``Replicate()``
    on the rest.  A tensor dim split over several mesh dims
    (``("pod", "data")``) gets ``Shard(d)`` on each, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for ax in norm_axes(entry) or ():
            out[names.index(ax)] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# a rank's blocks: storage under the specs
# ---------------------------------------------------------------------------
def coordinate(mesh) -> Dict[str, int]:
    """{axis name: this rank's coordinate} on the ``DeviceMesh`` `mesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def block_of(entry, mesh, coord: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of the block a spec entry gives the rank at `coord`:
    row-major over a tuple of axes, (0, 1) where the entry shards
    nothing."""
    axes = norm_axes(entry, mesh)
    idx, n = 0, 1
    for a in axes or ():
        size = axis_size(mesh, a)
        idx, n = idx * size + coord[a], n * size
    return idx, n


def local_block(t, spec: P, mesh, coord: Optional[Dict[str, int]] = None):
    """A rank's block of the full leaf `t` under `spec`: its slice along
    every sharded dim (a view).  `coord` defaults to this rank's
    (``coordinate``)."""
    coord = coordinate(mesh) if coord is None else coord
    for d, entry in enumerate(spec):
        i, n = block_of(entry, mesh, coord)
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, i * size, size)
    return t


def gather_leaf(t, spec: P, mesh):
    """The full leaf from every rank's block `t` under `spec`: an
    all-gather along each sharded dim (collective over those axes; for
    tests and checkpoints)."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.train import parallel as PAR

    for d, entry in enumerate(spec):
        axes = norm_axes(entry, mesh)
        if axes is not None:
            t = PAR.gather_dim(t, d, axis_group(mesh, axes)[0])
    return t


def _blocks(tree, specs, mesh):
    coord = coordinate(mesh)

    def cut(t, spec):
        if not hasattr(t, "shape"):
            return t
        return local_block(t, spec, mesh, coord).contiguous().clone()

    def walk(x, s):
        if isinstance(x, dict):
            return {k: walk(x[k], s[k]) for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(a, b) for a, b in zip(x, s))
        return cut(x, s)

    return walk(tree, specs)


def shard_params(params, mesh, fsdp: bool = True):
    """This rank's block of every param leaf under ``param_specs(params,
    mesh, fsdp)``: new contiguous tensors, so the full tree can be
    dropped."""
    return _blocks(params, param_specs(params, mesh, fsdp=fsdp), mesh)


def shard_states(states, mesh, batch: int):
    """This rank's block of every decode-state leaf under
    ``state_specs(states, mesh, batch)`` (ints kept)."""
    return _blocks(states, state_specs(states, mesh, batch), mesh)
