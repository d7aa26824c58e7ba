"""Op-level cost counter: what one eager call of a function does, counted
op by op as it runs.  The port's counterpart of the reference's
``utils/hlo_cost.py`` and ``utils/hlo.py``, which read the same numbers
from compiled HLO text.

Eager torch runs every op of every loop trip, so a count over the ops
that run is loop-aware by construction (the reference multiplies its loop
bodies through XLA's trip counts).  Eager torch fuses nothing either, so
an op's operand and result bytes are its traffic: the "post-fusion buffer
traffic" the reference counts per top-level HLO op.

* ``flops``: the matmul-class aten ops, with ``torch.utils.flop_counter``'s
  formulas (2·M·K·N a product), by execution unit.  cuBLAS runs them with
  TF32 off, so float32 operands go to ``fp32_simt``, bf16 and fp16 to
  ``bf16``, float64 to ``fp64``.  Each hand-written kernel adds its own
  work through ``charge``, which its wrapper's ``meta`` route calls with
  the unit it computes on (``tf32x3``, ``bf16``, ``fp32_simt``).  Like the
  reference, only products count: an elementwise op adds bytes, no flops.
* ``hbm_bytes``: operand plus result bytes of every aten op that is not a
  view, plus the kernels' own bytes.  A view or alias (``t``, ``view``,
  ``expand``, ``slice``, ``transpose``, ``detach``, ...) returns its input's
  storage and moves nothing.  An operand counts each element it addresses
  once (an expanded dim, stride 0, adds none).  An in-place op reads and
  writes its target once each; ``copy_``, ``fill_``, ``zero_`` and an
  ``out=`` argument are only written.  An allocation (``empty``) moves
  nothing.
* ``peak_bytes``: the highest total of live storages during the call.  The
  storages the call was given count from the start (``arg_bytes``); every
  storage an op makes is tracked through a weak reference to it, so what
  autograd keeps for the backward stays counted until it is freed, and
  what goes out of scope leaves the total.
* ``coll_bytes``, ``coll_<kind>`` and ``n_coll``: the result bytes and the
  calls of every c10d collective (``c10d``'s in-place ops and
  ``_c10d_functional``'s, whose ``wait_tensor`` is no collective), by the
  reference's categories: an all-reduce counts its tensors, an all-gather
  its gathered outputs, a reduce-scatter its outputs.  As the
  reference's ``hlo_cost`` counts every top-level op's operand and result
  bytes, a collective's also count in ``hbm_bytes``: the inputs it reads
  (not the outputs it is handed to fill) and its results.  They stay 0
  with no process group; ``launch/mesh.counting_world`` gives one rank of
  a mesh of any size in one process.

Run it on ``meta`` tensors to count a step at any size with no memory and
no card (``train/step.build_case``), or on CPU tensors to count the plain
route.  The device decides what a kernel's wrapper does: on ``meta`` it
charges its work, on the CPU it runs its plain version, whose aten ops
are counted like any others.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

#: the reference's collective categories (``utils/hlo.py``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_COLL_OPS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"),
             ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("send", "collective-permute"), ("recv", "collective-permute"))

_aten = torch.ops.aten
#: ops that allocate and write nothing
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided,
                _aten.empty_permuted}
#: in-place ops that overwrite their target without reading it
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_}

#: the counters in effect, innermost last; ``charge`` adds to the last
_ACTIVE: List["OpCounter"] = []


def charge(kernel: str, flops: float, n_bytes: float, unit: str) -> None:
    """Add a hand-written kernel's own work to the innermost counter in
    effect (none: nothing).  Called by each kernel wrapper's ``meta``
    route in place of the launch."""
    if _ACTIVE:
        _ACTIVE[-1].add(kernel, (), flops, n_bytes, unit)


def unit_of(dtype: torch.dtype) -> str:
    """The execution unit of a cuBLAS product of `dtype` operands, TF32
    off."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float64:
        return "fp64"
    return "fp32_simt"


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements `t` addresses, each once: a dim of stride 0
    (an expanded one) adds no elements; at most its storage."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride:
            n *= size
    return min(n * t.element_size(), t.untyped_storage().nbytes())


def _tensors(values) -> Iterator[torch.Tensor]:
    """The tensors among an op's arguments or results, through nested
    lists and tuples (c10d's ``Tensor[][]``)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from _tensors(v)


def _written(func, args, kwargs) -> Tuple[List[torch.Tensor], List[bool]]:
    """The tensors `func` writes in place, and for each whether it is only
    written (``copy_``'s target, an ``out=`` argument) rather than read
    and written."""
    out, only = [], []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        for t in _tensors((v,)):
            out.append(t)
            only.append(a.is_out or func.overloadpacket in _OVERWRITES)
    return out, only


def _collective(func) -> str:
    """The reference's category of a c10d collective, "" for any other
    op."""
    if func.namespace not in _COLL_NAMESPACES:
        return ""
    name = func.overloadpacket.__name__
    for key, kind in _COLL_OPS:
        if key in name:
            return kind
    return ""


class OpCounter(TorchDispatchMode):
    """Counts flops (by unit), HBM bytes, collective bytes and the peak of
    live storages over the aten ops run while it is active, plus the
    kernels' ``charge``s.  ``track(tensors)`` counts storages a call was
    given as live from the start."""

    def __init__(self):
        super().__init__()
        self.flops_by_unit: Dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.n_coll = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.arg_bytes = 0
        self._live: Dict[int, int] = {}
        self._rows: Dict[tuple, list] = {}
        self._open = True

    # -- storages ----------------------------------------------------------
    def _free(self, key: int) -> None:
        if self._open:
            self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, key)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        return n

    def track(self, tensors) -> None:
        """Count the storages of `tensors` (the call's arguments) as live
        from the start, in ``arg_bytes``."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self.arg_bytes += self._track(t)

    # -- counts ------------------------------------------------------------
    def add(self, op: str, shape: tuple, flops: float, n_bytes: float,
            unit: str) -> None:
        if flops:
            self.flops_by_unit[unit] = self.flops_by_unit.get(unit, 0.0) + flops
        self.hbm_bytes += n_bytes
        row = self._rows.setdefault((op, shape), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += n_bytes
        row[2] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        results = list(_tensors(out if isinstance(out, (list, tuple))
                                else (out,)))
        for t in results:
            self._track(t)
        packet = func.overloadpacket
        if packet in _ALLOCATIONS:
            return out
        kind = _collective(func)
        if kind:                # c10d's schemas mark nothing as written
            self._count_collective(kind, func, args, kwargs, results)
            return out
        written, only = _written(func, args, kwargs)
        inputs = list(_tensors(args)) + list(_tensors(kwargs.values()))
        if not written:
            held = {t.untyped_storage()._cdata for t in inputs}
            if results and all(t.untyped_storage()._cdata in held
                               for t in results):
                return out                 # a view or alias
        skip = {id(t) for t, o in zip(written, only) if o}
        seen = set()
        n_bytes = 0
        for t in inputs:
            if id(t) not in skip and id(t) not in seen:
                seen.add(id(t))
                n_bytes += tensor_bytes(t)
        # the results: what is written in place, and what is new
        w_keys = {t.untyped_storage()._cdata for t in written}
        n_bytes += sum(tensor_bytes(t) for t in written)
        n_bytes += sum(tensor_bytes(t) for t in results
                       if t.untyped_storage()._cdata not in w_keys)
        flops, unit = 0.0, ""
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            unit = unit_of(inputs[0].dtype)
        shape = tuple(results[0].shape) if results else ()
        self.add(packet.__name__, shape, flops, n_bytes, unit)
        return out

    def _count_collective(self, kind: str, func, args, kwargs,
                          results) -> None:
        """One collective: its results' bytes under `kind`; its inputs
        (every argument but the ``output*`` ones it fills) and results in
        ``hbm_bytes``."""
        c = sum(tensor_bytes(t) for t in results)
        read = 0
        for i, a in enumerate(func._schema.arguments):
            if not a.name.startswith("output"):
                v = args[i] if i < len(args) else kwargs.get(a.name)
                read += sum(tensor_bytes(t) for t in _tensors((v,)))
        self.coll[kind] += c
        self.n_coll += 1
        shape = tuple(results[0].shape) if results else ()
        self.add(func.overloadpacket.__name__, shape, 0.0, read + c, "")

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._open = False
        return super().__exit__(*exc)

    # -- reports -----------------------------------------------------------
    def totals(self) -> Dict[str, Any]:
        """The reference's ``hlo_cost.analyze`` keys (flops, hbm_bytes,
        coll_bytes, n_coll, coll_<kind>) plus ``flops_by_unit``,
        ``peak_bytes`` and ``arg_bytes``."""
        out: Dict[str, Any] = {
            "flops": sum(self.flops_by_unit.values(), 0.0),
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": sum(self.coll.values()),
            "n_coll": float(self.n_coll)}
        out.update({f"coll_{k}": v for k, v in self.coll.items()})
        out.update(flops_by_unit=dict(self.flops_by_unit),
                   peak_bytes=self.peak_bytes, arg_bytes=self.arg_bytes)
        return out

    def top_ops(self, n: int = 20) -> List[Dict[str, Any]]:
        """The n heaviest (op, result shape) pairs by bytes, each with its
        calls and flops: the counterpart of ``hlo_cost.top_ops``."""
        rows = [{"op": op, "shape": shape, "calls": c, "bytes": b,
                 "flops": f} for (op, shape), (c, b, f) in self._rows.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:n]


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, OpCounter]:
    """Run ``fn(*args, **kwargs)`` once under a fresh counter, the
    arguments' storages live from the start: (its result, the counter)."""
    counter = OpCounter()
    counter.track(tree_leaves((args, kwargs)))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """``count``'s totals: the counterpart of ``hlo_cost.analyze`` of the
    compiled ``fn`` (see ``OpCounter.totals``)."""
    return count(fn, *args, **kwargs)[1].totals()
