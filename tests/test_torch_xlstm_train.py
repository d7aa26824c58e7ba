"""xLSTM training in the port against the reference: the tie rule of
``max``, the sLSTM recurrence's backward (the plain adjoint loop that the
backward kernel is held to, and ``SLSTMScanFn`` over it on the CPU),
reduced xlstm's gradients, ``make_train_step`` and the launcher.

Both packages get the same numpy inputs; the port computes from the
reference's own params carried through ``convert``.  Tolerances are
named in each test.  On the CPU the sLSTM's Function runs its plain
pieces (``ref.slstm_scan`` with its chunk states, ``ref.slstm_scan_bwd``);
the kernels are held to them on the card (``tests/test_torch_kernels.py
-m cuda -k slstm``, ``chip_smoke.py`` phase p).
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
from repro.nn import xlstm as JX
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.kernels import ref as TR
from repro_torch.kernels import slstm_scan as TSL
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB
from repro_torch.nn import xlstm as TX
from repro_torch.optim import tree_leaves
from repro_torch.train import step as TTS

ARCH = "xlstm-1.3b"


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the tie rule: jax splits max's gradient 0.5 / 0.5 at a tie
# ---------------------------------------------------------------------------
def _mlstm_tie_inputs():
    """One mLSTM step from C = n = 0, m = -1e30 with i = f = 0, v = 1,
    k = e0 and q = (1, 0.5, 0, 0): |n·q| = 1 exactly, so the denominator's
    ``max(|n·q|, 1)`` is at a tie (B = H = 1, dh = 4)."""
    state = (np.zeros((1, 1, 4, 4), np.float32), np.zeros((1, 1, 4),
                                                           np.float32),
             np.full((1, 1), -1e30, np.float32))
    q = np.array([[[1.0, 0.5, 0.0, 0.0]]], np.float32)
    k = np.array([[[1.0, 0.0, 0.0, 0.0]]], np.float32)
    v = np.ones((1, 1, 4), np.float32)
    gates = np.zeros((1, 1), np.float32)
    return state, q, k, v, gates


@pytest.mark.parametrize("form", ["cell", "chunkwise"])
def test_mlstm_denominator_tie_takes_jax_gradient(form):
    """d sum(h) / dq of one mLSTM step at ``|n·q| = 1``: jax gives (2, 0,
    0, 0) (half of the denominator's gradient); the stepwise cell and the
    chunkwise form (one chunk of one step) give it too, exactly, with the
    forward's bits unchanged."""
    state, q, k, v, gates = _mlstm_tie_inputs()

    if form == "cell":
        def jfn(qq):
            return JX._mlstm_cell(tuple(map(jnp.asarray, state)),
                                  (qq, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(gates), jnp.asarray(gates)))[1]

        def tfn(qq):
            return TX._mlstm_cell(tuple(map(_t, state)),
                                  (qq, _t(k), _t(v), _t(gates), _t(gates)))[1]
        qin = q
    else:
        def jfn(qq):
            return JX.mlstm_chunkwise(
                qq, *(jnp.asarray(a[:, None]) for a in (k, v, gates, gates)),
                tuple(map(jnp.asarray, state)), 1)[1]

        def tfn(qq):
            return TX.mlstm_chunkwise(
                qq, *(_t(a[:, None]) for a in (k, v, gates, gates)),
                tuple(map(_t, state)), 1)[1]
        qin = q[:, None]
    want = np.asarray(jax.grad(lambda qq: jfn(qq).sum())(jnp.asarray(qin)))
    np.testing.assert_array_equal(want.reshape(-1), [2.0, 0.0, 0.0, 0.0])
    live = _t(qin).clone().requires_grad_(True)
    h = tfn(live)
    (got,) = torch.autograd.grad(h.sum(), live)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(h.detach().numpy(),
                                  np.asarray(jfn(jnp.asarray(qin))))


@pytest.mark.parametrize("use_fused", [None, False])
def test_slstm_normalizer_tie_takes_jax_gradient(use_fused):
    """One sLSTM step (d = 1) whose n lands on 1e-6 exactly (n0 = 1e-6, the
    forget gate 1, the input gate 0), so ``max(n, 1e-6)`` is at a tie:
    d h / d (c0, n0, m0, h0) equals ``jax.grad`` of the reference's
    ``slstm_apply`` exactly, through ``SLSTMScanFn`` (the plain adjoint
    loop) and through torch's autograd of the plain loop."""
    pre = np.array([[0.3, -200.0, 200.0, 0.0]], np.float32)   # z, i, f, o
    jp = {"wx": pre, "rh": np.zeros((1, 1, 4), np.float32),
          "b": np.zeros(4, np.float32), "gn": {"scale": np.ones(1,
                                                              np.float32)},
          "wo": np.ones((1, 1), np.float32)}
    x = np.ones((1, 1, 1), np.float32)
    st = [np.array([[v]], np.float32) for v in (1e-6, 1e-6, 0.0, 0.25)]

    def jfn(*s0):
        jpp = jax.tree.map(jnp.asarray, jp)
        return JX.slstm_apply(jpp, jnp.asarray(x), 1, state=s0)[1][3].sum()

    want = jax.grad(jfn, argnums=(0, 1, 2, 3))(*map(jnp.asarray, st))
    tp = convert.params_from_numpy(jp, "cpu")
    live = [_t(a).clone().requires_grad_(True) for a in st]
    _, fin = TX.slstm_apply(tp, _t(x), 1, state=tuple(live),
                            use_fused=use_fused)
    got = torch.autograd.grad(fin[3].sum(), live)
    assert float(want[1][0, 0]) == pytest.approx(-0.5 * 0.5 * 1e-6 / 1e-12,
                                                 rel=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("x0", [0.0, -0.0])
def test_softplus_and_log_sigmoid_at_zero_take_jax_gradient(x0):
    """``ref.softplus`` and ``nn/xlstm._log_sigmoid`` at ±0: jax's gradient
    0.5 (``logaddexp``'s), exactly."""
    for tfn, jfn in ((TR.softplus, jax.nn.softplus),
                     (TX._log_sigmoid, jax.nn.log_sigmoid)):
        x = torch.tensor([x0], requires_grad=True)
        (got,) = torch.autograd.grad(tfn(x).sum(), x)
        want = float(jax.grad(lambda v: jfn(v))(jnp.float32(x0)))
        assert want == 0.5
        assert float(got[0]) == want


def test_tie_repair_keeps_the_forward_bits():
    """``ref.maximum(x, c)`` has ``torch.clamp(x, min=c)``'s bits at the
    port's constants 1e-6 and 1.0, and its values at 0.0 (torch's
    vectorized maximum may give -0.0 against 0.0 as +0.0, which clamp
    keeps); the repaired softplus has the old formula's bits, -0.0
    included (a zero's sign vanishes in ``+ log1p(exp(-0))``); over
    values that include ±0, the constants, their neighbours, ±inf and
    many normal draws.  NaN stays NaN (its payload may differ)."""
    base = np.array([0.0, -0.0, 1.0, -1.0, 1e-6, 1e-30, -1e30, np.inf,
                     -np.inf, 20.0, -20.0, 88.0, -104.0], np.float32)
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(np.concatenate([
        base, np.nextafter(np.float32(1e-6), np.float32(1))[None],
        np.nextafter(np.float32(1), np.float32(0))[None],
        rng.normal(scale=10, size=4000).astype(np.float32)]))

    def bits(t):
        return t.view(torch.int32)

    for c in (1e-6, 1.0):
        assert torch.equal(bits(TR.maximum(vals, c)),
                           bits(torch.clamp(vals, min=c))), c
    assert torch.equal(TR.maximum(vals, 0.0), torch.clamp(vals, min=0.0))
    old = torch.clamp(vals, min=0) + torch.log1p(torch.exp(-vals.abs()))
    assert torch.equal(bits(TR.softplus(vals)), bits(old))
    nan = torch.tensor([float("nan")] * 40)
    assert bool(TR.maximum(nan, 1.0).isnan().all())
    assert bool(TR.softplus(nan).isnan().all())


# ---------------------------------------------------------------------------
# the plain adjoint loop and SLSTMScanFn
# ---------------------------------------------------------------------------
def _slstm_inputs(b, s, d, h, initial, dtype=torch.float64, seed=1):
    """wx, rh, bias and a state at an xLSTM layer's magnitudes; with
    `initial` the reference's initial state (zeros, n 1e-6, m -1e30)."""
    rng = np.random.default_rng(seed)
    dh = d // h
    as_t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    wx = as_t(rng.normal(size=(b, s, 4 * d)))
    rh = as_t(rng.normal(size=(h, dh, 4 * dh)) * dh ** -0.5)
    bias = as_t(np.concatenate([np.zeros(2 * d), np.full(d, 3.0),
                                np.zeros(d)]))
    if initial:
        state = TX.slstm_state_init(b, d, "cpu", dtype)
    else:
        state = tuple(as_t(a) for a in (
            rng.normal(size=(b, d)), np.abs(rng.normal(size=(b, d))) + 1e-6,
            rng.normal(size=(b, d)), rng.normal(size=(b, d)) * 0.1))
    return wx, rh, bias, state


@pytest.mark.parametrize("s", [40, 128])
@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("state_grads", [False, True])
def test_adjoint_loop_matches_autograd_float64(s, initial, state_grads):
    """``ref.slstm_scan_bwd`` against torch's autograd of ``ref.slstm_scan``
    (chunks checkpointed at S 128), float64, every input and the final
    state given a cotangent or not: all seven gradients within rtol
    1e-10 of autograd's, element by element, with an atol of 1e-13 of
    the largest: the i-gate slice of d_bias is zero up to rounding (a
    constant added to every step's i shifts c, n and m together and
    leaves h unchanged), so its entries are float64 rounding, ~1e-16."""
    wx, rh, bias, state = _slstm_inputs(2, s, 16, 2, initial)
    rng = np.random.default_rng(2)
    dys = torch.tensor(rng.normal(size=(2, s, 16)))
    d_state = (tuple(torch.tensor(rng.normal(size=(2, 16)))
                     for _ in range(4)) if state_grads else None)
    live = [t.clone().requires_grad_(True) for t in (wx, rh, bias, *state)]
    hs, fin = TR.slstm_scan(*live[:3], tuple(live[3:]))
    loss = (hs * dys).sum()
    if d_state:
        loss = loss + sum((a * g).sum() for a, g in zip(fin, d_state))
    want = torch.autograd.grad(loss, live)
    with torch.no_grad():
        hs, _, chunks = TR.slstm_scan(wx, rh, bias, state, boundaries=True)
        got = TR.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys,
                                d_state)
    assert len(got) == 7
    for name, g, w in zip(("d_wx", "d_rh", "d_bias", "dc0", "dn0", "dm0",
                           "dh0"), got, want):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-10,
            atol=1e-13 * float(w.abs().max()), err_msg=name)


@pytest.mark.parametrize("s", [1, 64, 100])
def test_boundary_states_are_the_loop_states(s):
    """``ref.slstm_scan(..., boundaries=True)``, float32: hs and the final
    state the same bits as without boundaries, and chunk k's (c, n, m) the
    same bits as the loop's state after 64·k steps."""
    wx, rh, bias, state = _slstm_inputs(3, s, 32, 4, False, torch.float32)
    hs, fin, chunks = TR.slstm_scan(wx, rh, bias, state, boundaries=True)
    hs0, fin0 = TR.slstm_scan(wx, rh, bias, state)
    assert torch.equal(hs, hs0)
    assert all(torch.equal(a, b) for a, b in zip(fin, fin0))
    assert chunks[0].shape == (3, -(-s // 64), 32)
    for k in range(chunks[0].shape[1]):
        st = state
        if k:
            _, st = TR.slstm_scan(wx[:, :64 * k], rh, bias, state)
        for got, want in zip(chunks, st[:3]):
            assert torch.equal(got[:, k], want)


@pytest.mark.parametrize("s", [40, 128])
def test_function_on_the_cpu_is_the_plain_pieces(s):
    """``SLSTMScanFn`` on the CPU (what ``slstm_scan`` takes for inputs that
    need a gradient): its outputs ``ref.slstm_scan``'s bits, its gradients
    those of ``ref.slstm_scan_bwd`` on the plain loop's chunk states, bit
    for bit; it launches nothing."""
    wx, rh, bias, state = _slstm_inputs(2, s, 32, 2, False, torch.float32)
    rng = np.random.default_rng(5)
    dys = torch.tensor(rng.normal(size=(2, s, 32)), dtype=torch.float32)
    dh = torch.tensor(rng.normal(size=(2, 32)), dtype=torch.float32)
    live = [t.clone().requires_grad_(True) for t in (wx, rh, bias, *state)]
    before = (TSL.slstm_scan.launches, TSL.slstm_scan_bwd.launches)
    hs, fin = TSL.slstm_scan(*live[:3], tuple(live[3:]))
    assert type(hs.grad_fn).__name__ == "SLSTMScanFnBackward"
    got = torch.autograd.grad((hs * dys).sum() + (fin[3] * dh).sum(), live)
    with torch.no_grad():
        hs0, fin0, chunks = TR.slstm_scan(wx, rh, bias, state,
                                          boundaries=True)
        want = TR.slstm_scan_bwd(wx, rh, bias, state, hs0, chunks, dys,
                                 (None, None, None, dh))
    assert torch.equal(hs.detach(), hs0)
    assert all(torch.equal(a.detach(), b) for a, b in zip(fin, fin0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (TSL.slstm_scan.launches, TSL.slstm_scan_bwd.launches) == before


# ---------------------------------------------------------------------------
# reduced xlstm: gradients, train steps, the launcher
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    """(reference cfg, its params, the port's cfg, converted params) of
    xlstm-reduced: 2 repeats of [mLSTM, sLSTM], d 64, 4 heads."""
    m = JC.get_reduced(ARCH)
    jp = JMB.init_params(jax.random.PRNGKey(0), m)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return m, jp, TC.get_reduced(ARCH), tp


def _stream(m, s, b=2):
    return JD.SyntheticStream(JD.DataConfig(vocab=m.vocab, seq_len=s,
                                            global_batch=b))


@pytest.fixture(scope="module")
def reference_gradient(model):
    """The batch (2 x 64 of ``SyntheticStream``), and the loss and
    gradient of the reference's jitted ``jax.value_and_grad`` with remat
    on (``jax.checkpoint`` recomputes the same ops, so the gradient is
    remat's either way), compiled once."""
    m, jp, _, _ = model
    toks, labels = _stream(m, 64).batch(0)

    def loss_fn(p):
        return JTS.next_token_loss(JMB.forward(p, m, jnp.asarray(toks),
                                               remat=True),
                                   jnp.asarray(labels))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    return (toks, labels), float(loss), grads


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(remat, model, reference_gradient):
    """Reduced xlstm at 2 x 64 (the mLSTM chunkwise, the sLSTM under
    ``SLSTMScanFn``), remat on and off in the port: the loss within rtol
    1e-5 of the reference's, and each gradient leaf within 1e-3 of
    max(its norm, 1e-6 x the whole gradient's norm).  The floor is for
    the mLSTM's ``b_i`` (and the sLSTM's i-gate bias): adding a constant
    to the input gate's pre-activation shifts C, n and the stabilizer m
    together and leaves h unchanged unless ``max(|n·q|, 1)`` engages, so
    that leaf is zero up to rounding (norm ~5e-10 beside the embedding's
    ~4) and its own norm is no scale for its error."""
    _, _, tm, tp = model
    (toks, labels), want_loss, want_g = reference_gradient
    loss, grads = TTS.loss_and_grads(
        tm, tp, {"tokens": _t(toks).long(), "labels": _t(labels).long()},
        remat=remat)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = jax.tree.leaves(convert.lm_params_to_numpy(grads))
    want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(got) == len(want)
    total = np.sqrt(sum(np.sum(np.asarray(w, np.float64) ** 2)
                        for _, w in want))
    for g, (path, w) in zip(got, want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.linalg.norm(g.astype(np.float64) - w)
        assert err <= 1e-3 * max(np.linalg.norm(w), 1e-6 * total), \
            (jax.tree_util.keystr(path), err, np.linalg.norm(w))


@pytest.mark.parametrize("remat", [False, True])
def test_slstm_calls_per_gradient(remat):
    """Reduced xlstm's gradient at 2 x 64: one ``SLSTMScanFn`` backward an
    sLSTM layer, and one forward with its chunk states an sLSTM layer, two
    with remat (``torch.utils.checkpoint`` runs the Function's forward
    again); the recomputed forward's hs the first's bits; the gradients
    the same bits with remat on and off."""
    tm = TC.get_reduced(ARCH)
    tp = TMB.init_params(prng.prng_key(torch.tensor(0)), tm, "cpu")
    n_sl = sum(seg.repeats for seg in tm.segments for sp in seg.pattern
               if sp.kind == "slstm")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, tm.vocab, (2, 64), generator=g),
             "labels": torch.randint(0, tm.vocab, (2, 64), generator=g)}
    fwd, bwd = TSL.slstm_scan_fwd, TSL.slstm_scan_bwd
    seen = {"fwd": [], "bwd": 0}

    def count_fwd(*a, **k):
        out = fwd(*a, **k)
        seen["fwd"].append(out[0].clone())
        return out

    def count_bwd(*a, **k):
        seen["bwd"] += 1
        return bwd(*a, **k)

    TSL.slstm_scan_fwd, TSL.slstm_scan_bwd = count_fwd, count_bwd
    try:
        _, grads = TTS.loss_and_grads(tm, tp, batch, remat=remat)
    finally:
        TSL.slstm_scan_fwd, TSL.slstm_scan_bwd = fwd, bwd
    assert (len(seen["fwd"]), seen["bwd"]) == (n_sl * (2 if remat else 1),
                                               n_sl)
    if remat:     # each layer's first forward, then its recompute
        firsts = seen["fwd"][:n_sl]
        again = seen["fwd"][n_sl:][::-1]
        for a, b in zip(firsts, again):
            assert torch.equal(a, b)
    _, other = TTS.loss_and_grads(tm, tp, batch, remat=not remat)
    for a, b in zip(tree_leaves(grads), tree_leaves(other)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def reference_steps(model):
    """The reference's jitted ``make_train_step`` (remat on, its default)
    from its initial params over 3 synthetic batches at 2 x 64, compiled
    once: the batches, each step's loss, and the params after each step."""
    m, jp, _, _ = model
    jstep, joptim = JTS.make_train_step(m, lr=3e-4)
    jstep, jopt = jax.jit(jstep), joptim.init(jp)
    stream = _stream(m, 64)
    batches, losses, params = [], [], []
    for i in range(3):
        toks, labels = stream.batch(i)
        batches.append((toks, labels))
        jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
        losses.append(float(jm["loss"]))
        params.append(jax.tree.leaves(jp))
    return batches, losses, params


@pytest.mark.parametrize("n", [1, 3])
def test_train_steps_match_reference(n, model, reference_steps):
    """Reduced xlstm's ``make_train_step`` (adamw, weight decay 0.1, clip
    1.0, remat on as the reference's default, the sLSTM under
    ``SLSTMScanFn``) from the reference's params against the reference's
    jitted step, a new synthetic batch each step: losses within rtol
    1e-5, params within rtol 1e-4 / atol 1e-5 after `n` steps."""
    m, jp, tm, _ = model
    batches, losses, params = reference_steps
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tstep, toptim = TTS.make_train_step(tm, lr=3e-4)
    topt = toptim.init(tp)
    for i in range(n):
        toks, labels = batches[i]
        tp, topt, tmet = tstep(tp, topt, {"tokens": _t(toks).long(),
                                          "labels": _t(labels).long()})
        np.testing.assert_allclose(float(tmet["loss"]), losses[i],
                                   rtol=1e-5)
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(tp)),
                    params[n - 1]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_launcher_restart_equals_an_uninterrupted_run(tmp_path):
    """``launch/train --arch xlstm-1.3b`` (the reduced config) on the CPU,
    12 steps, once whole and once failing at step 7: the restarted run
    resumes from step 4's checkpoint and its losses equal the whole
    run's."""
    run = ["--arch", ARCH, "--batch", "4", "--seq", "32", "--ckpt-every",
           "4", "--steps", "12", "--log-every", "1", "--device", "cpu"]
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
