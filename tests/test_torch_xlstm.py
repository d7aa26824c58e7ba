"""The port's xLSTM (``nn/xlstm``, the plain sLSTM loop, xlstm-1.3b's
model, decode and ``Engine``) against the reference's.

Both packages get the same numpy inputs; the modules compute from the
reference's own params carried through ``convert`` (the inits themselves
are held bit for bit).  Tolerances: the modules within
1e-5·max(1, max|reference|) (float32 exp, log1p, cumsum and sums taken
in another order); whole models within 1e-4·max(1, max|reference|)
over 4 layers; the engine must emit the same tokens.  The mLSTM's two
forms differ in the last bits, so each comparison pairs like with like:
a length that ``chunk`` divides runs chunkwise in both packages, any
other length and every decode step stepwise.  On the CPU the sLSTM's
recurrence is the kernel's plain version (``kernels/ref.slstm_scan``);
the kernel is held to it on the card (``tests/test_torch_kernels.py -m
cuda``, ``chip_smoke.py`` phase o).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as JS
from repro.models import base as JMB
from repro.nn import xlstm as JX
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TR
from repro_torch.launch import serve as TS
from repro_torch.models import base as TMB
from repro_torch.nn import xlstm as TX
from repro_torch.train import step as TTS

ARCH = "xlstm-1.3b"
#: xlstm-1.3b's parameters at full width (48 layers, d 2048, vocab 50304,
#: tied), as ``jax.eval_shape`` of the reference's init counts them
FULL_PARAMS = 1_135_659_344


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol: float) -> None:
    """max|got - want| <= tol·max(1, max|want|), and finite."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _close_tree(got, want, tol: float = 1e-5) -> None:
    got = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a), got))
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol)


def _same_bits(want, got) -> None:
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = jax.tree.leaves(convert.params_to_numpy(got))
    assert len(got) == len(want)
    for (path, a), b in zip(want, got):
        a = np.asarray(a)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), \
            jax.tree_util.keystr(path)


def _carried(kind: str, d: int, h: int, seed: int = 3):
    init = {"mlstm": JX.mlstm_init, "slstm": JX.slstm_init}[kind]
    jp = init(jax.random.PRNGKey(seed), d, h)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _state_np(kind: str, rng, b: int, d: int, h: int):
    """A carried state at a decoder's magnitudes (n > 0, m finite)."""
    dh = d // h
    if kind == "mlstm":
        return (rng.normal(size=(b, h, dh, dh)) * 0.1,
                np.abs(rng.normal(size=(b, h, dh))),
                rng.normal(size=(b, h)))
    return (rng.normal(size=(b, d)), np.abs(rng.normal(size=(b, d))) + 1e-6,
            rng.normal(size=(b, d)), rng.normal(size=(b, d)) * 0.1)


def _both(state_np):
    f32 = [np.asarray(a, np.float32) for a in state_np]
    return (tuple(jnp.asarray(a) for a in f32), tuple(_t(a) for a in f32))


@pytest.fixture(scope="module")
def model():
    """(reference cfg, its params, the port's cfg, converted params) of
    xlstm-reduced: 2 repeats of [mLSTM, sLSTM], d 64, 4 heads."""
    m = JC.get_reduced(ARCH)
    jp = JMB.init_params(jax.random.PRNGKey(0), m)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return m, jp, TC.get_reduced(ARCH), tp


# ---------------------------------------------------------------------------
# configs and inits
# ---------------------------------------------------------------------------
def test_full_width_layout_and_param_count(monkeypatch):
    """xlstm-1.3b: 6 repeats of [mLSTM x 7, sLSTM], every leaf the
    reference's shape (``jax.eval_shape``; the port's draws replaced by
    empty meta tensors), 1,135,659,344 params."""
    m = TC.get_arch(ARCH)
    assert [(s.repeats, [sp.kind for sp in s.pattern])
            for s in m.segments] == [(6, ["mlstm"] * 7 + ["slstm"])]
    monkeypatch.setattr(prng, "normal_scaled",
                        lambda key, shape, scale, device: torch.empty(
                            shape, device="meta"))
    tp = TMB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    want = jax.eval_shape(lambda k: JMB.init_params(k, JC.get_arch(ARCH)),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: tuple(a.shape), want) == \
        jax.tree.map(lambda a: tuple(a.shape), tp)
    assert TMB.param_count(tp) == FULL_PARAMS


@pytest.mark.parametrize("kind,d,h,seed", [
    ("mlstm", 64, 4, 0), ("mlstm", 32, 2, 5), ("slstm", 64, 4, 0),
    ("slstm", 64, 2, 1), ("slstm", 32, 1, 7)])
def test_inits_equal_the_reference_bit_for_bit(kind, d, h, seed):
    init = {"mlstm": (JX.mlstm_init, TX.mlstm_init),
            "slstm": (JX.slstm_init, TX.slstm_init)}[kind]
    want = init[0](jax.random.PRNGKey(seed), d, h)
    _same_bits(want, init[1](prng.prng_key(torch.tensor(seed)), d, h, "cpu"))


@pytest.mark.parametrize("chunk", [1 << 14, 1000])
def test_slstm_wx_at_and_past_the_chunk(chunk, monkeypatch):
    """The sLSTM's wx (d x 4d) at d 64 is 2^14 counters: with the chunk
    at 2^14 it is drawn in one piece (as xlstm-1.3b's 2^24 are at
    ``prng.CHUNK``), at 1000 in pieces: the reference's bits both ways."""
    monkeypatch.setattr(prng, "CHUNK", chunk)
    want = JX.slstm_init(jax.random.PRNGKey(2), 64, 4)
    _same_bits(want, TX.slstm_init(prng.prng_key(torch.tensor(2)), 64, 4,
                                   "cpu"))


# ---------------------------------------------------------------------------
# the mLSTM
# ---------------------------------------------------------------------------
def test_mlstm_cell_matches_reference(rng):
    b, h, dh = 2, 4, 16
    carry = _both(_state_np("mlstm", rng, b, h * dh, h))
    inp = [rng.normal(size=(b, h, dh)).astype(np.float32) for _ in range(3)]
    inp += [rng.normal(size=(b, h)).astype(np.float32) * 3 for _ in range(2)]
    want_c, want_h = JX._mlstm_cell(carry[0], tuple(map(jnp.asarray, inp)))
    got_c, got_h = TX._mlstm_cell(carry[1], tuple(map(_t, inp)))
    _close(got_h, want_h, 1e-5)
    _close_tree(got_c, want_c)


@pytest.mark.parametrize("s,chunk,chunkwise", [
    (12, 64, True), (37, 64, True), (128, 32, True), (128, 64, True),
    (64, 64, True), (128, 64, False)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_apply_matches_reference(s, chunk, chunkwise, with_state,
                                       rng):
    """Stepwise (S 12, 37, and 128 asked for) and chunkwise (S 128 in
    chunks of 32 and 64, S 64 in one), from zeros or a carried state."""
    jp, tp = _carried("mlstm", 64, 4)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    st = _both(_state_np("mlstm", rng, 2, 64, 4)) if with_state else \
        (None, None)
    want_y, want_st = JX.mlstm_apply(jp, jnp.asarray(x), 4, state=st[0],
                                     chunkwise=chunkwise, chunk=chunk)
    got_y, got_st = TX.mlstm_apply(tp, _t(x), 4, state=st[1],
                                   chunkwise=chunkwise, chunk=chunk)
    _close(got_y, want_y, 1e-5)
    _close_tree(got_st, want_st)


@pytest.mark.parametrize("split,chunk", [(16, 64), (64, 32)])
def test_mlstm_streams_across_two_calls(split, chunk, rng):
    """Two calls with the first one's state carried into the second:
    stepwise halves (S 16 + 20), chunkwise halves (64 + 64 in chunks of
    32)."""
    jp, tp = _carried("mlstm", 64, 4, seed=6)
    s = 36 if split == 16 else 128
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    jy1, jst = JX.mlstm_apply(jp, jnp.asarray(x[:, :split]), 4, chunk=chunk)
    jy2, jst = JX.mlstm_apply(jp, jnp.asarray(x[:, split:]), 4, state=jst,
                              chunk=chunk)
    ty1, tst = TX.mlstm_apply(tp, _t(x[:, :split]), 4, chunk=chunk)
    ty2, tst = TX.mlstm_apply(tp, _t(x[:, split:]), 4, state=tst,
                              chunk=chunk)
    _close(torch.cat([ty1, ty2], 1), np.concatenate([jy1, jy2], 1), 1e-5)
    _close_tree(tst, jst)


def test_mlstm_stepwise_under_autograd_is_the_loop(rng):
    """Under autograd the stepwise scan (``_chunked_scan``) runs 64-step
    chunks under ``torch.utils.checkpoint``: the ys, the state and the
    inputs' gradients are those of one loop (chunk 1), bit for bit."""
    b, h, dh, s = 1, 2, 8, 128
    seqs = [rng.normal(size=(s, b, h, dh)).astype(np.float32)
            for _ in range(3)]
    seqs += [rng.normal(size=(s, b, h)).astype(np.float32) for _ in range(2)]
    carry = _both(_state_np("mlstm", rng, b, h * dh, h))[1]
    outs = []
    for chunk in (64, 1):
        live = [_t(a).requires_grad_(True) for a in seqs]
        st, ys = TX._chunked_scan(TX._mlstm_cell, carry, live, s,
                                  chunk=chunk)
        (ys.square().sum() + st[0].sum()).backward()
        outs.append((ys.detach(), *(t.detach() for t in st),
                     *(t.grad for t in live)))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


# ---------------------------------------------------------------------------
# the sLSTM and its plain loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 12, 128])
def test_slstm_apply_matches_reference(s, h, rng):
    """H 1, 2 and 4 (at H 4 head k alone feeds gate k of every channel),
    S 1, 12 and 128 (the reference's 64-step chunks), from a carried
    state; the state out as well."""
    jp, tp = _carried("slstm", 64, h, seed=h)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    st = _both(_state_np("slstm", rng, 2, 64, h))
    want_y, want_st = JX.slstm_apply(jp, jnp.asarray(x), h, state=st[0])
    got_y, got_st = TX.slstm_apply(tp, _t(x), h, state=st[1])
    _close(got_y, want_y, 1e-5)
    _close_tree(got_st, want_st)


def test_slstm_from_zeros_streams_across_two_calls(rng):
    jp, tp = _carried("slstm", 32, 4, seed=9)
    x = rng.normal(size=(2, 30, 32)).astype(np.float32)
    want, _ = JX.slstm_apply(jp, jnp.asarray(x), 4)
    y1, st = TX.slstm_apply(tp, _t(x[:, :10]), 4)
    y2, _ = TX.slstm_apply(tp, _t(x[:, 10:]), 4, state=st)
    _close(torch.cat([y1, y2], 1), want, 1e-5)


def test_plain_loop_checkpoints_its_chunks_under_autograd(rng):
    """``ref.slstm_scan`` under autograd at S 128 runs two checkpointed
    chunks of 64: the same hs, state and gradients as one loop."""
    _, tp = _carried("slstm", 32, 2)
    wx = rng.normal(size=(2, 128, 128)).astype(np.float32)
    st = _both(_state_np("slstm", rng, 2, 32, 2))[1]
    outs = []
    for chunk in (64, 1):
        w = _t(wx).requires_grad_(True)
        rh = tp["rh"].clone().requires_grad_(True)
        hs, state = TR.slstm_scan(w, rh, tp["b"], st, chunk=chunk)
        (hs.square().sum() + state[0].sum()).backward()
        outs.append((hs.detach(), *(t.detach() for t in state), w.grad,
                     rh.grad))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


def test_wrapper_and_ops_take_the_plain_loop_on_the_cpu(rng):
    """A CPU tensor gets ``ref.slstm_scan`` through the wrapper and
    through ``ops`` (use_fused None or False), and launches nothing."""
    from repro_torch.kernels import slstm_scan as TSL
    _, tp = _carried("slstm", 32, 4)
    wx = _t(rng.normal(size=(2, 9, 128)).astype(np.float32))
    st = _both(_state_np("slstm", rng, 2, 32, 4))[1]
    want = TR.slstm_scan(wx, tp["rh"], tp["b"], st)
    before = TSL.slstm_scan.launches
    for got in (TSL.slstm_scan(wx, tp["rh"], tp["b"], st),
                TOPS.slstm_scan(wx, tp["rh"], tp["b"], st),
                TOPS.slstm_scan(wx, tp["rh"], tp["b"], st,
                                use_fused=False)):
        for a, b_ in zip((got[0], *got[1]), (want[0], *want[1])):
            assert torch.equal(a, b_)
    assert TSL.slstm_scan.launches == before


# ---------------------------------------------------------------------------
# the reduced model: forward, prefill, decode, the Engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [64, 128, 12, 40])
def test_forward_matches_reference(s, model, rng):
    """S 64 and 128: the mLSTM chunkwise in both packages; S 12 and 40:
    stepwise.  ``use_fused=False`` is the same plain loop on the CPU."""
    m, jp, tm, tp = model
    toks = rng.integers(0, m.vocab, size=(2, s)).astype(np.int32)
    want = np.asarray(JMB.forward(jp, m, jnp.asarray(toks)))
    got = TMB.forward(tp, tm, _t(toks).long())
    assert got.shape == (2, s, m.vocab)
    _close(got.detach(), want, 1e-4)
    torch.testing.assert_close(
        TMB.forward(tp, tm, _t(toks).long(), use_fused=False), got,
        rtol=0, atol=0)


def test_prefill_step_matches_reference(model, rng):
    m, jp, tm, tp = model
    toks = rng.integers(0, m.vocab, size=(2, 64)).astype(np.int32)
    want = JTS.make_prefill_step(m)(jp, {"tokens": jnp.asarray(toks)})
    got = TTS.make_prefill_step(tm)(tp, {"tokens": _t(toks).long()})
    assert got.shape == (2, m.vocab)
    _close(got, want, 1e-4)


def test_decode_steps_match_reference(model, rng):
    """40 decode steps against the reference's jitted decode step: the
    logits and every recurrent state (stacked (repeats, B, ...), written
    in place by the port, returned by the reference)."""
    m, jp, tm, tp = model
    b = 2
    jstates = JMB.init_decode_state(jp, m, b, 16)
    tstates = TMB.init_decode_state(tp, tm, b, 16)
    _close_tree(tstates, jax.tree.map(np.asarray, jstates), 0.0)
    first = [t for seg in tstates for st in seg for t in st]
    jdec = jax.jit(JTS.make_decode_step(m))
    tdec = TTS.make_decode_step(tm)
    for pos in range(40):
        tok = rng.integers(0, m.vocab, size=(b, 1)).astype(np.int32)
        jl, jstates = jdec(jp, jnp.asarray(tok), jnp.int32(pos), jstates)
        tl, tstates = tdec(tp, _t(tok).long(), pos, tstates)
        _close(tl, jl, 1e-4)
    _close_tree(tstates, jax.tree.map(np.asarray, jstates), 1e-4)
    assert [t for seg in tstates for st in seg for t in st] == first


def test_decode_matches_the_stepwise_prefill(model, rng):
    """Decoding a 12-token prompt token by token ends on the prefill
    step's logits (both stepwise: 12 is no multiple of the chunk)."""
    _, _, tm, tp = model
    toks = rng.integers(0, tm.vocab, size=(3, 12)).astype(np.int64)
    states = TMB.init_decode_state(tp, tm, 3, 16)
    for pos in range(12):
        logits, states = TMB.decode_step(tp, tm, _t(toks[:, pos:pos + 1]),
                                         pos, states)
    want = TTS.make_prefill_step(tm)(tp, {"tokens": _t(toks)})
    _close(logits[:, 0], want, 1e-4)


def _serve(serve, m, params, prompts, slots, cache_len=64, max_new=6, **kw):
    eng = serve.Engine(m, params, slots, cache_len, **kw)
    for r, p in enumerate(prompts):
        eng.submit(serve.Request(rid=r, prompt=list(p), max_new=max_new))
    eng.run(max_iters=512)
    assert len(eng.finished) == len(prompts)
    return {r.rid: r.out for r in eng.finished}


def test_engine_generates_the_reference_tokens(model):
    """Five requests through two slots (three reuse a lane, whose
    recurrent states are reset on admission): the reference's tokens."""
    m, jp, tm, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, m.vocab, size=n).tolist()
               for n in (12, 7, 9, 12, 5)]
    eng = TS.Engine(tm, tp, 2, 64, device="cpu")
    assert eng._kv_horizon is None
    assert _serve(TS, tm, tp, prompts, 2, device="cpu") == \
        _serve(JS, m, jp, prompts, 2)


def test_reused_lane_matches_a_fresh_engine(model):
    _, _, tm, tp = model
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, tm.vocab, size=12).tolist()
    p2 = rng.integers(0, tm.vocab, size=9).tolist()
    reused = _serve(TS, tm, tp, [p1, p2], 1, device="cpu")
    assert reused[1] == _serve(TS, tm, tp, [p2], 1, device="cpu")[0]
    assert reused[0] == _serve(TS, tm, tp, [p1], 1, device="cpu")[0]


def test_engine_resets_only_the_admitted_lane(model):
    """Both kinds' tuples: lane 0 back to its initial values (C, n 0, m
    at -1e30; c 0, n 1e-6, m -1e30, h 0), lane 1 untouched."""
    _, _, tm, tp = model
    eng = TS.Engine(tm, tp, 2, 64, device="cpu")
    for r in range(2):
        eng.submit(TS.Request(rid=r, prompt=[1, 2, 3], max_new=2))
    eng.step()
    leaves = [t for st in eng.states[0] for t in st]
    lane1 = [t[:, 1].clone() for t in leaves]
    assert all(not torch.equal(t[:, 0], f[:, 0]) for t, f in zip(
        leaves, [f for st in eng._fresh_recurrent[0] for f in st]))
    TS._reset_recurrent_lane(eng.states, eng._fresh_recurrent, tm, 0)
    fresh = TMB.init_decode_state(tp, tm, 2, 64)
    for t, f, keep in zip(leaves, [x for st in fresh[0] for x in st], lane1):
        assert torch.equal(t[:, 0], f[:, 0]) and torch.equal(t[:, 1], keep)


def test_serve_main_serves_xlstm_on_the_cpu(capsys):
    assert TS.main(["--arch", ARCH, "--device", "cpu"]) == 0
    assert "arch=xlstm-reduced requests=8/8 engine_iters=" in \
        capsys.readouterr().out


def test_params_round_trip(model):
    """Per-spec dicts of (repeats, ...) stacks, rh (repeats, H, dh, 4dh),
    carried to numpy and back, leaf for leaf."""
    _, jp, tm, tp = model
    back = convert.lm_params_to_numpy(tp)
    assert back["segments"][0][1]["rh"].shape == (2, 4, 16, 64)
    for a, b_ in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b_)
    again = convert.lm_params_to_numpy(convert.lm_params_from_numpy(back,
                                                                   "cpu"))
    for a, b_ in zip(jax.tree.leaves(back), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b_)
    assert dataclasses.asdict(tm) == dataclasses.asdict(JC.get_reduced(ARCH))
