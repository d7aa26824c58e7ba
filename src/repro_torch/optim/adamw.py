"""Adam(W) as functions on trees of tensors (the reference's own update,
not ``torch.optim``).

Functional API of the reference package's ``optim/adamw.py``:
``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; ``apply_updates(params, updates) -> params``.  A tree
is a nest of dicts, lists and tuples with tensors at the leaves (the
params layout ``{"layers": [{"w", "b"}, ...]}``).  ``update`` returns new
tensors, as the reference does; ``update_in_place`` (the LM train step's,
where params, m and v are GBs) writes them in place, where the reference
donates its buffers to XLA.

The update is the reference's, ``-lr·(m/bc1)/(sqrt(v/bc2)+eps)``
(``torch.optim.Adam`` places eps and rounds the bias correction
differently).  Its bias correction ``bc = 1 - b ** step`` is a float32
power in the reference.  XLA's float32 power is the float64 power rounded
once; torch's float32 ``pow`` is not, and differs by an ulp at some
steps (the first at step 31 for b1 = 0.9).  So here the power is taken in
float64 and rounded to float32, then subtracted in float32; that agrees
with XLA to the bit except at rare steps (2 of the first 5000 at
b2 = 0.999), where it is one ulp off.

The moments ``b1·m + (1-b1)·g`` and ``b2·v + (1-b2)·g·g`` (and the
decoupled weight decay ``u - lr·wd·p``) are contracted by XLA into one
fused multiply-add each, ``fma(b1, m, (1-b1)·g)``; a
separate multiply and add differ by hundreds of ulps where the two terms
cancel.  `_fma` rounds the sum once from float64 (the product of two
float32 values is exact there); it can differ from a true FMA only where
the float64 sum lands on a float32 halfway point, and then by one ulp.
And torch's float32 ``sqrt`` on the CPU is not correctly rounded (it
differs from XLA's in ~0.6% of elements); the square root of a float32
taken in float64 and rounded once is.  These float64 steps cost extra
memory traffic on the card; a fused Adam kernel would do each with one
float32 instruction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        # a NamedTuple (AdamState) takes its fields as arguments
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """A tree of `like`'s structure holding `leaves` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


class AdamState(NamedTuple):
    step: torch.Tensor           # int32 scalar, on the params' device
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]
    #: update_in_place(grads, state, params) -> state (params, mu and nu
    #: written in place; the same bits as update + apply_updates)
    update_in_place: Callable[..., Any]


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """float32 ``1 - b ** step`` with the power rounded once from float64
    (see the module note)."""
    b32 = float(np.float32(b))
    return 1 - (b32 ** step.double()).float()


def _fma(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 ``a * x + y`` with one rounding (see the module note); `a`
    is a Python float or a float32 tensor."""
    a = a.double() if torch.is_tensor(a) else float(np.float32(a))
    return (a * x.double() + y.double()).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (see the module note)."""
    return torch.sqrt(x.double()).float()


#: elements of a leaf ``update_in_place`` updates at a time (2^26: 2.7 GB
#: of temporaries at most)
IN_PLACE_CHUNK = 1 << 26


def adamw(lr: Union[Callable[[torch.Tensor], Any], float], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _s, _lr=lr: _lr)

    def init(params):
        leaf = tree_leaves(params)[0]
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=leaf.device),
                         mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def leaf_update(g, m, v, p, bc1, bc2, lr_t):
        """One leaf's new moments and its update."""
        m = _fma(b1, m, (1 - b1) * g)
        v = _fma(b2, v, (1 - b2) * g * g)
        u = -lr_t * (m / bc1) / (_sqrt(v / bc2) + eps)
        if weight_decay and p is not None:
            # u - (lr·wd)·p, contracted like the moments
            u = _fma(-(lr_t * weight_decay), p, u)
        return m, v, u

    def scalars(state: AdamState):
        step = state.step + 1
        return (step, _bias_correction(b1, step), _bias_correction(b2, step),
                lr_fn(step))

    def update(grads, state: AdamState, params=None):
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        step, *consts = scalars(state)
        ps = (tree_leaves(params) if params is not None
              else [None] * len(tree_leaves(grads)))
        out = [leaf_update(g, m, v, p, *consts) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
            ps)]
        return (tree_unflatten(grads, [o[2] for o in out]),
                AdamState(step=step,
                          mu=tree_unflatten(state.mu, [o[0] for o in out]),
                          nu=tree_unflatten(state.nu, [o[1] for o in out])))

    @torch.no_grad()
    def update_in_place(grads, state: AdamState, params,
                        norm: Optional[torch.Tensor] = None) -> AdamState:
        """``update`` and ``apply_updates`` in one pass that writes params,
        mu and nu in place, one slice of IN_PLACE_CHUNK elements of a leaf
        at a time: the same bits (every step is elementwise), with no
        second copy of any tree and the float64 temporaries of one slice
        alive at a time (an LM's (repeats, ...) stacks are GBs each, and a
        leaf's temporaries are ~10 times its float32 size: 38 GB for
        mixtral's stacked w_gate at two layers).  Params, mu and nu must
        be contiguous.  Returns the new state, which holds the same mu and
        nu tensors.  `norm`, where given, is the whole gradient's global
        norm that the clip reads, for `grads` that are one rank's blocks
        of it (``train/parallel.global_norm``)."""
        scale = (clip_scale(grads, clip_norm, norm) if clip_norm is not None
                 else None)
        step, *consts = scalars(state)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
            for i in range(0, p.numel(), IN_PLACE_CHUNK):
                sl = slice(i, i + IN_PLACE_CHUNK)
                gs = g[sl] if scale is None else g[sl] * scale
                m_new, v_new, u = leaf_update(gs, m[sl], v[sl], p[sl],
                                              *consts)
                m[sl].copy_(m_new)
                v[sl].copy_(v_new)
                p[sl].add_(u.to(p.dtype))
                del gs, m_new, v_new, u
        return AdamState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update,
                     update_in_place=update_in_place)


def adam(lr, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_scale(grads, max_norm: float,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` multiplies every leaf by
    (`norm`: the gradient's global norm, where the caller has it)."""
    norm = global_norm(grads) if norm is None else norm
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    scale = clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads)
