"""Device meshes over ``torch.distributed``: the twin of the reference's
``launch/mesh.py``.

A mesh is a ``DeviceMesh`` over the process group's ranks, one rank a
device, with the reference's axis names ('pod', 'data', 'model').  A
rank's device is ``cuda:<local rank>`` unless the caller names one.  The
process group is the caller's: ``init_process_group`` starts it from an
explicit backend, store, rank and world size (nothing is read from the
environment), and a mesh built with none running starts a world of one
(NCCL on the card, gloo on the CPU).

  make_host_mesh()            # every rank of the world as (data=n, model=1)
  make_host_mesh((2, 1))      # a submesh over ranks 0 and 1
  make_production_mesh()      # (data=16, model=16): needs 256 ranks

  with counting_world(256):   # rank 0 of a world of 256 in this process
      mesh = make_production_mesh(device="cpu")

``axis_group(mesh, name)`` is this rank's process group along one mesh
axis ('model', 'data') or a tuple of them (the batch axes ('pod',
'data')), with its coordinate there: the groups the layers' collectives
run over (``train/parallel``).  The rules read only the mesh.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_process_group(backend: str, store, rank: int, world_size: int,
                       timeout_s: float = 300.0) -> None:
    """Start the default process group from an explicit `backend` ('nccl'
    or 'gloo'), c10d `store` (a ``FileStore``, ``TCPStore`` or
    ``HashStore``), `rank` and `world_size`."""
    import datetime

    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _device_type(device) -> str:
    return "cuda" if device is None else torch.device(device).type


def _world(device_type: str) -> int:
    """The world's size; starts a world of one if no group is running."""
    if not dist.is_initialized():
        init_process_group(_default_backend(device_type), dist.HashStore(),
                           rank=0, world_size=1)
    return dist.get_world_size()


#: the process group over each submesh's ranks, keyed by its rank tuple
#: (made once, by every rank, when the submesh is built)
_FLAT_GROUPS: dict = {}
#: the process group over each plane of several axes (('pod', 'data') at
#: every 'model' coordinate), keyed by its rank tuple in row-major order;
#: made by every rank when the mesh is built
_PLANE_GROUPS: dict = {}


def _build(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    n = _world(device_type)
    want = int(np.prod(shape))
    ranks = torch.arange(want, dtype=torch.int64).reshape(shape)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))
    if want < n:
        key = tuple(range(want))
        if key not in _FLAT_GROUPS:
            _FLAT_GROUPS[key] = dist.new_group(list(key))
    plane = [i for i, a in enumerate(axes) if a in ("pod", "data")
             and shape[i] > 1]
    if len(plane) > 1:
        rest = [i for i in range(len(shape)) if i not in plane]
        planes = ranks.permute(rest + plane).reshape(-1, int(np.prod(
            [shape[i] for i in plane])))
        for row in planes.tolist():
            if tuple(row) not in _PLANE_GROUPS:
                _PLANE_GROUPS[tuple(row)] = dist.new_group(row)
    return mesh


def axis_group(mesh, name):
    """(group, coordinate): this rank's process group along the mesh axis
    `name` ('model', 'data', 'pod') or a tuple of axes (the batch axes),
    and its coordinate along them (row-major over a tuple's axes in mesh
    order, as a spec's tuple entry splits a dim).  Axes the mesh lacks or holds at size 1
    are dropped; where none is left the group is None and the coordinate
    0 (a collective over it is the identity)."""
    names = list(mesh.mesh_dim_names)
    axes = (name,) if isinstance(name, str) else tuple(name or ())
    axes = tuple(a for a in axes if a in names
                 and mesh.shape[names.index(a)] > 1)
    if not axes:
        return None, 0
    coord = mesh.get_coordinate()
    if len(axes) == 1:
        return mesh.get_group(axes[0]), coord[names.index(axes[0])]
    dims = sorted(names.index(a) for a in axes)
    idx = 0
    for d in dims:
        idx = idx * mesh.shape[d] + coord[d]
    sel = tuple(slice(None) if d in dims else c for d, c in enumerate(coord))
    return _PLANE_GROUPS[tuple(mesh.mesh[sel].reshape(-1).tolist())], idx


def flat_group(mesh):
    """The process group over every rank of `mesh`, in mesh order."""
    ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return _FLAT_GROUPS[ranks]


@contextlib.contextmanager
def counting_world(world_size: int, rank: int = 0):
    """One rank of a world of `world_size` in this process, for counting a
    sharded step on ``meta`` (``utils/op_cost``): torch's fake process
    group (backend "fake", ``FakeStore``), whose collectives return at
    once and move nothing, so ``make_mesh`` builds a mesh of any size.
    Raises if a process group is already running.  On exit the group and
    the submesh and plane groups built under it are dropped, so a later
    world in the process starts clean."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("counting_world: a process group is already "
                           "running")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _FLAT_GROUPS.clear()
        _PLANE_GROUPS.clear()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    `multi_pod`: 256 or 512 ranks, as the reference's pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    """Any factorization whose product is the world's size (the
    reference's ``jax.make_mesh`` takes every device, and raises
    otherwise)."""
    dt = _device_type(device)
    n = _world(dt)
    shape = tuple(int(s) for s in shape)
    want = int(np.prod(shape))
    if want != n:
        raise ValueError(f"mesh shape {shape} needs {want} ranks; the world "
                         f"has {n}")
    return _build(shape, tuple(axes), dt)


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axes: Optional[Tuple[str, ...]] = None, device=None):
    """Every rank of the world as (data=n, model=1) by default.  ``shape``
    and ``axes`` override the factorization: ``shape=(2, 2)`` for a real
    'model' axis on 4 ranks, ``shape=(2, 1)`` for a submesh over the first
    2 of n ranks.  The shape's product must not exceed the world's size.
    Collective: every rank of the world calls it."""
    dt = _device_type(device)
    n = _world(dt)
    if shape is None:
        assert axes is None, "axes override requires an explicit shape"
        return _build((n, 1), ("data", "model"), dt)
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = ("data", "model")[:len(shape)] if len(shape) <= 2 \
            else ("pod", "data", "model")[:len(shape)]
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} has {len(shape)} dims but "
                         f"axes {axes} names {len(axes)}")
    want = int(np.prod(shape))
    if want > n:
        raise ValueError(
            f"mesh shape {shape} asks for {want} devices but this world has "
            f"only {n} ranks (dist.get_world_size()); reduce the shape or "
            f"start more ranks")
    return _build(shape, tuple(axes), dt)
