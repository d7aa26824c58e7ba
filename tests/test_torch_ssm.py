"""The port's selective SSM (``nn/ssm``) and its plain scan against the
reference's ``nn/ssm.py``, and reduced hymba's gradients.

Both packages get the same numpy inputs (the params are the reference's,
carried through ``convert``; ``ssm_init`` itself is held bit for bit).
Tolerances: rtol 1e-5 / atol 1e-6 for the pieces (float32 exp, log1p and
sums taken in another order: the port's plain loop adds each step
unfused where XLA may fuse, and sums over N in another order); the long
scan's drift within 16 float32 ulps of the output's scale of a float64
scan (the state decays by exp(dt·a) < 1 every step, so rounding errors
do not grow with S); gradients within 1e-3 of each leaf's norm.  The
plain scan is what a CPU tensor takes; the kernel is held to it on the
card (``tests/test_torch_kernels.py -m cuda``, ``chip_smoke.py``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import synthetic as JD
from repro.models import base as JMB
from repro.nn import ssm as JS
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssm_scan as TSS
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB
from repro_torch.nn import ssm as TS
from repro_torch.optim import tree_leaves
from repro_torch.train import step as TTS

TOL = dict(rtol=1e-5, atol=1e-6)
EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _carried(d_model=16, d_state=8, seed=3):
    jp = JS.ssm_init(jax.random.PRNGKey(seed), d_model, d_state)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def layer():
    return _carried()


@pytest.mark.parametrize("d_model,d_state,seed", [(16, 8, 0), (64, 16, 1),
                                                  (20, 4, 2)])
def test_ssm_init_equals_the_reference_bit_for_bit(d_model, d_state, seed):
    want = JS.ssm_init(jax.random.PRNGKey(seed), d_model, d_state)
    got = TS.ssm_init(prng.prng_key(torch.tensor(seed)), d_model, d_state,
                      device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        a = np.asarray(want[k])
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == a.shape
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      a.view(np.uint32), err_msg=k)


def test_softplus_is_the_reference_logaddexp(rng):
    x = np.concatenate([rng.normal(size=500) * 8,
                        [-100.0, -30.0, 0.0, 19.0, 21.0, 40.0, 100.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(TS.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("with_tail", [False, True])
def test_conv_causal_matches_reference(with_tail, rng):
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_tail \
        else None
    want = JS._conv_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           None if tail is None else jnp.asarray(tail))
    got = TS._conv_causal(_t(x), _t(w), _t(b),
                          None if tail is None else _t(tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [5, 64, 128, 130])
def test_ssm_scan_matches_reference(s, with_h0, layer, rng):
    """S 128 takes the reference's chunked scan, S 130 (no multiple of
    64) its single one; y and the final state."""
    jp, tp = layer
    xz = rng.normal(size=(2, s, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, 32, 8)).astype(np.float32) if with_h0 else None
    jy, jh = JS.ssm_scan(jp, jnp.asarray(xz),
                         None if h0 is None else jnp.asarray(h0))
    ty, th = TS.ssm_scan(tp, _t(xz), None if h0 is None else _t(h0))
    assert ty.shape == (2, s, 32) and th.shape == (2, 32, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    # the explicit opt-out is the same plain loop on the CPU
    oy, oh = TS.ssm_scan(tp, _t(xz), None if h0 is None else _t(h0),
                         use_fused=False)
    assert torch.equal(oy, ty) and torch.equal(oh, th)


def test_ssm_apply_matches_reference(layer, rng):
    jp, tp = layer
    x = rng.normal(size=(2, 70, 16)).astype(np.float32)
    np.testing.assert_allclose(TS.ssm_apply(tp, _t(x)).numpy(),
                               np.asarray(JS.ssm_apply(jp, jnp.asarray(x))),
                               **TOL)


def test_decode_steps_match_reference_and_the_scan(layer, rng):
    """12 one-token steps against the reference's steps, and the same
    tokens' full-sequence scan (decode's state and conv tail carry what
    the scan carries)."""
    jp, tp = layer
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    jst = JS.ssm_decode_init(jp, 2)
    tst = TS.ssm_decode_init(tp, 2, "cpu")
    assert [tuple(a.shape) for a in tst] == [a.shape for a in jst]
    ys = []
    for t in range(12):
        jy, jst = JS.ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = TS.ssm_decode_step(tp, _t(x[:, t:t + 1]), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        ys.append(ty)
    full = TS.ssm_apply(tp, _t(x))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(), **TOL)
    _, h = TS.ssm_scan(tp, _t(x) @ tp["in_proj"])
    np.testing.assert_allclose(tst[0].numpy(), h.numpy(), **TOL)


def _scan_inputs(rng, b, s, di, n):
    """dt, bmat, cmat, x, a, h0 at a decoder's magnitudes: dt from the
    init's softplus(-4.6 ± ...), a = -(1 .. N)."""
    dt = np.log1p(np.exp(rng.normal(-4.6, 0.5, size=(b, s, di))))
    a = -np.tile(np.arange(1, n + 1), (di, 1))
    return tuple(_t(v.astype(np.float32)) for v in (
        dt, rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n)),
        rng.normal(size=(b, s, di)), a, rng.normal(size=(b, di, n)) * 0.1))


def test_plain_scan_drift_at_4096_steps_against_float64(rng):
    """The plain scan's float32 recurrence over S 4096 (Di 8, N 4) within
    16 ulps of the output's scale of the same scan in float64 (y and the
    final state)."""
    args = _scan_inputs(rng, 2, 4096, 8, 4)
    y, h = TR.ssm_scan(*args)
    y64, h64 = TR.ssm_scan(*(v.double() for v in args))
    scale = max(1.0, float(y64.abs().max()))
    err = float((y.double() - y64).abs().max())
    assert err <= 16 * EPS32 * scale, (err, scale)
    assert float((h.double() - h64).abs().max()) <= 16 * EPS32 * max(
        1.0, float(h64.abs().max()))


@pytest.mark.parametrize("s,chunk", [(130, 64), (128, 64), (64, 64),
                                     (9, 4), (1, 64)])
def test_plain_scan_chunks_are_one_loop(s, chunk, rng):
    """The chunked loop is the step-at-a-time recurrence, any chunk."""
    dt, bm, cm, x, a, h0 = _scan_inputs(rng, 2, s, 6, 4)
    y, h = TR.ssm_scan(dt, bm, cm, x, a, h0, chunk=chunk)
    want_h, want_y = h0.clone(), []
    for t in range(s):
        want_h = torch.exp(dt[:, t, :, None] * a) * want_h \
            + dt[:, t, :, None] * bm[:, t, None] * x[:, t, :, None]
        want_y.append((want_h * cm[:, t, None]).sum(-1))
    torch.testing.assert_close(y, torch.stack(want_y, 1), **TOL)
    torch.testing.assert_close(h, want_h, **TOL)


def test_plain_scan_gradient_with_and_without_checkpoint(rng):
    """Under autograd the chunks run under torch.utils.checkpoint where
    the reference's condition holds (S > chunk, chunk | S): the same
    gradients as the loop without it."""
    args = [v.requires_grad_(True) for v in _scan_inputs(rng, 2, 128, 6, 4)]
    gy = _t(rng.normal(size=(2, 128, 6)).astype(np.float32))
    gh = _t(rng.normal(size=(2, 6, 4)).astype(np.float32))

    def grads(chunk):
        y, h = TR.ssm_scan(*args, chunk=chunk)
        return torch.autograd.grad((y * gy).sum() + (h * gh).sum(), args)

    for a, b in zip(grads(64), grads(1000)):        # 1000: no checkpoint
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _scale_close(got, want, tol, what):
    """max|got - want| <= tol·max(1, max|want|)."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got.double() - want.double()).abs().max()) \
        if want.numel() else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, True),
                                             (True, False)])
@pytest.mark.parametrize("s", [128, 130, 5])
def test_plain_scan_bwd_matches_autograd(s, with_h0, with_dh, n, rng):
    """``ref.ssm_scan_bwd`` (the backward kernel's plain version: the
    adjoint loop from the states at chunk starts) against torch's autograd
    of the plain loop, at S that 64 divides (the checkpointed chunks) and
    S that it does not, h0 zeros or not, the final state's cotangent
    zeros or not: each of the six gradients within 1e-5·max(1, max|want|)
    (float32 sums of a few hundred terms in another order)."""
    args = list(_scan_inputs(rng, 2, s, 24, n))
    if not with_h0:
        args[5] = torch.zeros_like(args[5])
    dys = _t(rng.normal(size=(2, s, 24)).astype(np.float32))
    dh = _t(rng.normal(size=(2, 24, n)).astype(np.float32)) if with_dh \
        else None
    live = [v.clone().requires_grad_(True) for v in args]
    y, h = TR.ssm_scan(*live)
    loss = (y * dys).sum() + ((h * dh).sum() if with_dh else 0.0)
    want = torch.autograd.grad(loss, live)
    _, _, h_chunks = TR.ssm_scan(*args, boundaries=True)
    assert h_chunks.shape == (2, -(-s // 64), 24, n)
    got = TR.ssm_scan_bwd(*args[:5], h_chunks, dys, dh)
    for name, g, w in zip(("d_dt", "d_bmat", "d_cmat", "d_x", "d_a",
                           "d_h0"), got, want):
        _scale_close(g, w, 1e-5, name)


@pytest.mark.parametrize("s", [1, 64, 130, 200])
def test_boundary_states_are_the_plain_loops_states(s, rng):
    """``ssm_scan(..., boundaries=True)``: ys and h the same bits as
    without, and the k-th boundary state the same bits as the plain
    loop's state after k·64 steps (h0 first)."""
    args = _scan_inputs(rng, 2, s, 6, 8)
    ys, h = TR.ssm_scan(*args)
    ys2, h2, h_chunks = TR.ssm_scan(*args, boundaries=True)
    assert torch.equal(ys, ys2) and torch.equal(h, h2)
    assert h_chunks.shape == (2, -(-s // 64), 6, 8)
    assert torch.equal(h_chunks[:, 0], args[5])
    for k in range(1, h_chunks.shape[1]):
        part = [v[:, :64 * k] for v in args[:4]]
        _, hk = TR.ssm_scan(*part, args[4], args[5])
        assert torch.equal(h_chunks[:, k], hk), k


def test_scan_function_on_the_cpu_is_the_plain_pieces(rng, monkeypatch):
    """``SSMScanFn`` on CPU tensors: its ys and h the plain loop's bits,
    its gradients ``ref.ssm_scan_bwd``'s bits on the plain loop's
    boundary states (one call a backward; None for inputs that need no
    gradient), and no kernel launch counted."""
    args = _scan_inputs(rng, 2, 130, 6, 4)
    dys = _t(rng.normal(size=(2, 130, 6)).astype(np.float32))
    calls = []
    bwd = TR.ssm_scan_bwd
    monkeypatch.setattr(TR, "ssm_scan_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    before = (TSS.ssm_scan.launches, TSS.ssm_scan_bwd.launches)
    live = [v.clone().requires_grad_(i in (0, 3)) for i, v in
            enumerate(args)]
    y, h = TSS.ssm_scan(*live)
    want_y, want_h, h_chunks = TR.ssm_scan(*args, boundaries=True)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(),
                                                           want_h)
    (y * dys).sum().backward()
    assert len(calls) == 1
    want = bwd(*args[:5], h_chunks, dys)
    assert torch.equal(live[0].grad, want[0])
    assert torch.equal(live[3].grad, want[3])
    assert all(v.grad is None for i, v in enumerate(live) if i not in (0, 3))
    assert (TSS.ssm_scan.launches, TSS.ssm_scan_bwd.launches) == before


@pytest.mark.parametrize("s,with_h0", [(128, False), (130, True)])
def test_scan_vjp_matches_the_reference(s, with_h0, layer, rng,
                                        monkeypatch):
    """``jax.vjp`` of the reference's ``nn/ssm.ssm_scan`` (params, xz and
    h0) against the port's ``nn/ssm.ssm_scan`` under autograd, which goes
    through ``SSMScanFn`` and the plain adjoint loop (counted): xz and h0
    within rtol 1e-4 / atol 1e-5, each param within 1e-3 of its norm, for
    cotangents of y and of the final state."""
    jp, tp = layer
    xz = rng.normal(size=(2, s, 64)).astype(np.float32)
    h0 = (rng.normal(size=(2, 32, 8)) * 0.1).astype(np.float32)
    gy = rng.normal(size=(2, s, 32)).astype(np.float32)
    gh = rng.normal(size=(2, 32, 8)).astype(np.float32)
    calls = []
    bwd = TR.ssm_scan_bwd
    monkeypatch.setattr(TR, "ssm_scan_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    if with_h0:
        _, vjp = jax.vjp(JS.ssm_scan, jp, jnp.asarray(xz), jnp.asarray(h0))
    else:
        _, vjp = jax.vjp(lambda p, z: JS.ssm_scan(p, z), jp, jnp.asarray(xz))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = _t(xz).requires_grad_(True)
    ht = _t(h0).requires_grad_(True) if with_h0 else None
    y, h = TS.ssm_scan(live, xt, ht)
    wrt = [xt, *live.values()] + ([ht] if with_h0 else [])
    grads = torch.autograd.grad((y * _t(gy)).sum() + (h * _t(gh)).sum(),
                                wrt, allow_unused=True)   # in/out_proj
    assert len(calls) == 1
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrads[1]),
                               rtol=1e-4, atol=1e-5)
    if with_h0:
        np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgrads[2]),
                                   rtol=1e-4, atol=1e-5)
    for name, g in zip(live, grads[1:]):
        want = np.asarray(jgrads[0][name], np.float64)
        if g is None:
            assert not want.any(), name
            continue
        err = np.linalg.norm(g.numpy().astype(np.float64) - want)
        assert err <= 1e-3 * max(np.linalg.norm(want), 1e-30), name


def test_kernel_wrapper_takes_the_plain_scan_on_the_cpu(rng):
    args = _scan_inputs(rng, 2, 40, 6, 4)
    before = TSS.ssm_scan.launches
    y, h = TSS.ssm_scan(*args)
    oy, oh = TOPS.ssm_scan(*args, use_fused=False)
    want_y, want_h = TR.ssm_scan(*args)
    for got in ((y, h), (oy, oh)):
        assert torch.equal(got[0], want_y) and torch.equal(got[1], want_h)
    assert TSS.ssm_scan.launches == before      # the CPU route counts none


def test_ssm_gradient_matches_reference(layer, rng):
    """d(loss)/d(params, x) of ssm_apply at S 128 (the chunked route in
    both packages) against jax.grad."""
    jp, tp = layer
    x = rng.normal(size=(2, 128, 16)).astype(np.float32)
    gy = rng.normal(size=(2, 128, 16)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(JS.ssm_apply(p, xx) * jnp.asarray(gy))

    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = _t(x).requires_grad_(True)
    grads = torch.autograd.grad((TS.ssm_apply(live, xt) * _t(gy)).sum(),
                                [xt, *live.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    for name, g in zip(live, grads[1:]):
        want = np.asarray(jg[name], np.float64)
        err = np.linalg.norm(g.numpy().astype(np.float64) - want)
        assert err <= 1e-3 * max(np.linalg.norm(want), 1e-30), name


# ---------------------------------------------------------------------------
# reduced hymba: loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
def test_hymba_gradients_match_reference(remat):
    """Reduced hymba (5 layers) at 2 x 128 of ``SyntheticStream``: the
    loss within rtol 1e-5 and every gradient leaf within 1e-3 of its norm
    of ``jax.grad`` of the reference's loss, with remat on and off in
    both packages."""
    m = JC.get_reduced("hymba-1.5b")
    jp = JMB.init_params(jax.random.PRNGKey(0), m)
    tm = TC.get_reduced("hymba-1.5b")
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks, labels = JD.SyntheticStream(JD.DataConfig(
        vocab=m.vocab, seq_len=128, global_batch=2)).batch(0)

    def loss_fn(p):
        return JTS.next_token_loss(JMB.forward(p, m, jnp.asarray(toks),
                                               remat=remat),
                                   jnp.asarray(labels))

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(jp)
    loss, grads = TTS.loss_and_grads(
        tm, tp, {"tokens": _t(toks).long(), "labels": _t(labels).long()},
        remat=remat)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = jax.tree.leaves(convert.lm_params_to_numpy(grads))
    want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.linalg.norm(g.astype(np.float64) - w)
        assert err <= 1e-3 * max(np.linalg.norm(w), 1e-30), \
            (jax.tree_util.keystr(path), err, np.linalg.norm(w))



@pytest.mark.parametrize("remat", [False, True])
def test_hymba_scan_calls_per_gradient(remat, monkeypatch):
    """Reduced hymba's gradient at 2 x 64: one ``SSMScanFn`` backward an
    SSM layer, and one forward with its boundary states an SSM layer, two
    with remat (``torch.utils.checkpoint`` runs the Function's forward
    again and makes its states again); the gradients the same bits with
    remat on and off."""
    tm = TC.get_reduced("hymba-1.5b")
    tp = TMB.init_params(prng.prng_key(torch.tensor(0)), tm, "cpu")
    n_ssm = sum(seg.repeats for seg in tm.segments for sp in seg.pattern
                if sp.cfg.ssm_state)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, tm.vocab, (2, 64), generator=g),
             "labels": torch.randint(0, tm.vocab, (2, 64), generator=g)}
    fwd, bwd = TSS.ssm_scan_fwd, TSS.ssm_scan_bwd
    calls = {"fwd": 0, "bwd": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TSS, "ssm_scan_fwd", count("fwd", fwd))
    monkeypatch.setattr(TSS, "ssm_scan_bwd", count("bwd", bwd))
    loss, grads = TTS.loss_and_grads(tm, tp, batch, remat=remat)
    assert calls == {"fwd": n_ssm * (2 if remat else 1), "bwd": n_ssm}
    monkeypatch.undo()
    _, again = TTS.loss_and_grads(tm, tp, batch, remat=not remat)
    for a, b in zip(tree_leaves(grads), tree_leaves(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 3])
def test_hymba_train_steps_match_reference(n):
    """Reduced hymba's ``make_train_step`` (adamw, weight decay 0.1, clip
    1.0, the scan under ``SSMScanFn``) from the reference's params against
    the reference's jitted step, a new synthetic batch each step: losses
    within rtol 1e-5, params within rtol 1e-4 / atol 1e-5."""
    m = JC.get_reduced("hymba-1.5b")
    jp = JMB.init_params(jax.random.PRNGKey(0), m)
    tm = TC.get_reduced("hymba-1.5b")
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jstep, joptim = JTS.make_train_step(m, lr=3e-4, remat=False)
    jstep, jopt = jax.jit(jstep), joptim.init(jp)
    tstep, toptim = TTS.make_train_step(tm, lr=3e-4, remat=False)
    topt = toptim.init(tp)
    stream = JD.SyntheticStream(JD.DataConfig(vocab=m.vocab, seq_len=64,
                                              global_batch=2))
    for i in range(n):
        toks, labels = stream.batch(i)
        jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
        tp, topt, tmet = tstep(tp, topt, {"tokens": _t(toks).long(),
                                          "labels": _t(labels).long()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_hymba_launcher_restart_equals_an_uninterrupted_run(tmp_path):
    """``launch/train --arch hymba-1.5b`` (the reduced config) on the CPU,
    12 steps, once whole and once failing at step 7: the restarted run
    resumes from step 4's checkpoint and its losses equal the whole
    run's."""
    run = ["--arch", "hymba-1.5b", "--batch", "4", "--seq", "32",
           "--ckpt-every", "4", "--steps", "12", "--log-every", "1",
           "--device", "cpu"]
    hist = {}
    for name, extra in (("whole", []), ("restarted",
                                         ["--simulate-failure-at", "7"])):
        out = str(tmp_path / f"{name}.json")
        assert TLT.main(run + extra + ["--ckpt-dir", str(tmp_path / name),
                                       "--history-out", out]) == 0
        with open(out) as f:
            hist[name] = {r["step"]: r["loss"] for r in json.load(f)}
    assert sorted(hist["whole"]) == list(range(1, 13))
    assert hist["whole"] == hist["restarted"]
