"""The port's Adam(W) against the reference package's ``repro.optim``.

Same numpy params and gradients into both; the port must agree to the
bit or within 1 ulp (float32 compared as integers).  The traps it covers:
XLA contracts the moment updates into fused multiply-adds, rounds the
float32 power of the bias correction once from float64, and takes a
correctly rounded square root; a plain torch transcription differs in
each (see ``repro_torch/optim/adamw.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.optim.adamw import global_norm
from repro_torch import optim as O
from repro_torch.optim.adamw import _bias_correction

ULP = 1


def _tree(rng, scale_decades=True):
    """One G-like layer pair; gradients spread over eight decades so the
    moment terms cancel somewhere."""
    def arr(*shape):
        a = rng.normal(size=shape)
        if scale_decades:
            a = a * 10.0 ** rng.integers(-6, 2, size=shape)
        return a.astype(np.float32)
    return {"layers": [{"w": arr(37, 73), "b": arr(73)},
                       {"w": arr(73, 29), "b": arr(29)}]}


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    # map the sign-magnitude bit patterns onto one ordered integer line
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max(initial=0))


def _assert_trees_within(jtree, ttree, ulp=ULP):
    jl = jax.tree.leaves(jtree)
    tl = jax.tree.leaves(ttree)         # the same (sorted) key order
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert _ulps(a, b.numpy()) <= ulp


def _run_both(j_opt, t_opt, rng, steps=3, with_params=False):
    params = _tree(rng, scale_decades=False)
    jp = jax.tree.map(jnp.asarray, params)
    tp = O.tree_map(torch.from_numpy, params)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    update = jax.jit(j_opt.update)
    for _ in range(steps):
        g = _tree(rng)
        ju, js = update(jax.tree.map(jnp.asarray, g), js,
                        jp if with_params else None)
        jp = JO.apply_updates(jp, ju)
        tu, ts = t_opt.update(O.tree_map(torch.from_numpy, g), ts,
                              tp if with_params else None)
        tp = O.apply_updates(tp, tu)
        assert int(ts.step) == int(js.step)
        _assert_trees_within(js.mu, ts.mu)
        _assert_trees_within(js.nu, ts.nu)
        _assert_trees_within(ju, tu)
        _assert_trees_within(jp, tp)


def test_adam_three_steps_match_reference(rng):
    _run_both(JO.adam(2e-5), O.adam(2e-5), rng)


@pytest.mark.parametrize("kw", [dict(weight_decay=1e-2),
                                dict(b1=0.5, b2=0.9, eps=1e-6)])
def test_adamw_options_match_reference(kw, rng):
    _run_both(JO.adamw(1e-3, **kw), O.adamw(1e-3, **kw), rng,
              with_params=True)


def test_adam_with_clipping_matches_reference(rng):
    """Clipping scales by the global norm, a sum over every leaf taken in
    another order in each package, and the update's m / sqrt(v) magnifies
    that scale's last-bit difference where a moment nearly cancels: held
    at rtol 1e-5 plus 1e-6 of the largest update, not in ulps."""
    j_opt, t_opt = JO.adam(1e-3, clip_norm=1.0), O.adam(1e-3, clip_norm=1.0)
    params = _tree(rng, scale_decades=False)
    js = j_opt.init(jax.tree.map(jnp.asarray, params))
    ts = t_opt.init(O.tree_map(torch.from_numpy, params))
    for _ in range(3):
        g = _tree(rng)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, g), js)
        tu, ts = t_opt.update(O.tree_map(torch.from_numpy, g), ts)
        for a, b in zip(jax.tree.leaves(ju), jax.tree.leaves(tu)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                       atol=1e-6 * np.abs(a).max())


def test_adam_learning_rate_schedule_sees_the_step(rng):
    sched = lambda s: 1e-3 / s          # a float32 tensor in both packages
    _run_both(JO.adam(sched), O.adam(sched), rng)


@pytest.mark.parametrize("b", [0.9, 0.999])
def test_bias_correction_matches_xla_over_many_steps(b):
    """``1 - b ** step`` in float32 over the first 5000 steps, within one
    ulp and bit-equal at all but a few: a plain torch float32 pow is
    already off at step 31 (b = 0.9)."""
    steps = np.arange(1, 5001, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: 1 - b ** s.astype(jnp.float32))(
        jnp.asarray(steps)))
    got = _bias_correction(b, torch.from_numpy(steps)).numpy()
    assert _ulps(want, got) <= ULP
    assert int((got != want).sum()) <= 2


def test_global_norm_and_clip_match_reference(rng):
    g = _tree(rng)
    want = float(global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(O.global_norm(O.tree_map(torch.from_numpy, g)))
    assert got == pytest.approx(want, rel=1e-6)
    jc = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    tc = O.clip_by_global_norm(O.tree_map(torch.from_numpy, g), 0.5)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)


def test_adam_returns_new_tensors_and_leaves_inputs_alone(rng):
    params = O.tree_map(torch.from_numpy, _tree(rng, scale_decades=False))
    before = O.tree_map(torch.clone, params)
    opt = O.adam(1e-2)
    state = opt.init(params)
    upd, state2 = opt.update(O.tree_map(torch.ones_like, params), state)
    new = O.apply_updates(params, upd)
    for a, b in zip(O.tree_leaves(params), O.tree_leaves(before)):
        assert torch.equal(a, b)
    assert int(state.step) == 0 and int(state2.step) == 1
    assert all(not torch.equal(a, b) for a, b in
               zip(O.tree_leaves(new), O.tree_leaves(params)))
