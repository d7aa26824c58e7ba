"""whisper-small in the port against the reference, at the reduced config
(2 encoder + 2 decoder layers, d 64, 4 heads of 16, vocab 512,
``max_enc_len`` 64): LayerNorm and the GEGLU's gelu, the encoder and
decoder blocks and the cross-attention, ``encode`` (also past
``max_enc_len``, where ``pos_embed`` repeats), ``forward`` with
``enc_out``, the prefill step with ``frames``, decode steps, the
gradient with ``frames`` (remat on and off), the flash Function at
Sq ≠ Sk without a mask, train steps, the params' round trip and the
launcher's refusal.

Both packages get the same numpy inputs (frames drawn as ``normal ·
0.1``, as the reference's tests draw them) and the port computes from
the reference's own params (``convert.lm_params_from_numpy``); on the CPU
its attention is the kernel's plain version.  Tolerances: elementwise
layers within rtol 1e-6 (float32 rounding of rsqrt and tanh); a block
and the cross-attention within rtol 2e-5; whole models within ``MODEL_TOL``
(rtol 1e-4, atol 2e-5: float32 sums in another order over 4 layers); a
loss within rtol 1e-5 and each gradient leaf within 1e-3 of its norm;
params after train steps within rtol 1e-4, atol 1e-5.  The reduced
init's bits, both seeds, are ``tests/test_torch_lm_init.py``'s; here the
full width's ``pos_embed``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs import whisper_small as JW
from repro.models import base as JMB
from repro.nn import attention as JA
from repro.nn import blocks as JB
from repro.nn import layers as JL
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.configs import whisper_small as TW
from repro_torch.core import prng
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB
from repro_torch.nn import attention as TA
from repro_torch.nn import blocks as TB
from repro_torch.nn import layers as TL
from repro_torch.optim import tree_leaves
from repro_torch.train import step as TTS

ARCH = "whisper-small"
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
B, S_ENC, S_DEC = 2, 48, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _frames(rng, b=B, s=S_ENC, d=64):
    return (rng.normal(size=(b, s, d)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, its params from seed 0, the port's cfg, the
    reference's params converted)."""
    m = JC.get_reduced(ARCH)
    jp = JMB.init_params(jax.random.PRNGKey(0), m)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return m, jp, TC.get_reduced(ARCH), tp


@pytest.fixture(scope="module")
def inputs(model):
    """Frames (B, S_ENC, d), decoder tokens (B, S_DEC), and the
    reference's encoder output of those frames."""
    m, jp, _, _ = model
    rng = np.random.default_rng(5)
    frames = _frames(rng)
    toks = rng.integers(0, m.vocab, size=(B, S_DEC)).astype(np.int32)
    return frames, toks, _jit(JMB.encode, 1)(jp, m, jnp.asarray(frames))


def _jit(fn, *static):
    """The reference's function, jitted (one compile, not one an op)."""
    return jax.jit(fn, static_argnums=static)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ---------------------------------------------------------------------------
# config, layers, init
# ---------------------------------------------------------------------------
def test_decoder_train_len_and_encoder_segments():
    assert TW.DECODER_TRAIN_LEN == JW.DECODER_TRAIN_LEN == 448
    full = TC.get_arch(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(JW.FULL)
    assert [s.n_layers for s in full.enc_segments] == [12]
    assert full.family == "audio" and full.max_enc_len == 1500


def test_layernorm_matches_reference(rng):
    """rtol 1e-6: the population variance in float32, as ``jnp.var``."""
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    want = JL.layernorm_apply({"scale": jnp.asarray(scale),
                               "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = TL.layernorm_apply({"scale": _t(scale), "bias": _t(bias)}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    init = TL.layernorm_init(7, "cpu")
    assert torch.equal(init["scale"], torch.ones(7))
    assert torch.equal(init["bias"], torch.zeros(7))


def test_geglu_gelu_is_jax_default_tanh_form(rng):
    """The FFN's gelu, isolated by 0/1 weights (h = [x, 1]: the gate
    reads x, the up projection 1), within 1e-6 of ``jax.nn.gelu`` (its
    default, the tanh approximation); torch's default erf form is over
    1e-4 away from jax's."""
    x = (rng.normal(size=1 << 16) * 3).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    pick = {"w_gate": torch.tensor([[1.0], [0.0]]),
            "w_up": torch.tensor([[0.0], [1.0]]),
            "w_down": torch.ones(1, 1)}
    h = torch.stack([_t(x), torch.ones(x.size)], 1)
    got = TB._geglu(pick, h)[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_full_width_pos_embed_bit_for_bit():
    """whisper-small's (1500, 768) ``pos_embed`` from seed 3, with the
    layers cut away (its key does not depend on them): the reference's
    bits."""
    cut = lambda m: dataclasses.replace(m, vocab=8, segments=(),  # noqa
                                        enc_segments=())
    want = JMB.init_params(jax.random.PRNGKey(3), cut(JC.get_arch(ARCH)))
    got = TMB.init_params(prng.prng_key(torch.tensor(3)),
                          cut(TC.get_arch(ARCH)), "cpu")
    got = convert.lm_params_to_numpy(got)
    for k in ("pos_embed", "ln_f"):
        for a, b in zip(jax.tree.leaves(want["encoder"][k]),
                        jax.tree.leaves(got["encoder"][k])):
            a = np.asarray(a)
            assert a.shape == b.shape
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k


# ---------------------------------------------------------------------------
# blocks and cross-attention
# ---------------------------------------------------------------------------
def test_encoder_block_matches_reference(model, inputs):
    """Encoder layer 0 (non-causal attention with RoPE, GEGLU) on the
    frames plus ``pos_embed``: rtol 2e-5."""
    m, jp, tm, tp = model
    frames = inputs[0]
    cfg, tcfg = m.enc_segments[0].pattern[0].cfg, \
        tm.enc_segments[0].pattern[0].cfg
    x = frames + np.asarray(jp["encoder"]["pos_embed"])[None, :S_ENC]
    pos = np.broadcast_to(np.arange(S_ENC), (B, S_ENC)).astype(np.int32)
    want = _jit(JB.enc_block_apply, 2)(
        _layer0(jp["encoder"]["segments"][0][0]), jnp.asarray(x), cfg,
        jnp.asarray(pos))
    got = TB.enc_block_apply(_layer0(tp["encoder"]["segments"][0][0]),
                             _t(x), tcfg, _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_decoder_block_and_cross_attention_match_reference(model, inputs):
    """Decoder layer 0 (causal self-attention, cross-attention over the
    reference's encoder output, GEGLU) and the cross-attention alone, 16
    queries against 48 keys: rtol 2e-5."""
    m, jp, tm, tp = model
    _, toks, je = inputs
    cfg, tcfg = m.segments[0].pattern[0].cfg, tm.segments[0].pattern[0].cfg
    x = np.asarray(jp["embed"]["table"])[toks]
    pos = np.broadcast_to(np.arange(S_DEC), (B, S_DEC)).astype(np.int32)
    jl, tl = _layer0(jp["segments"][0][0]), _layer0(tp["segments"][0][0])
    te = _t(je)
    want = _jit(JB.dec_block_apply, 3)(jl, jnp.asarray(x), je, cfg,
                                       jnp.asarray(pos))
    got = TB.dec_block_apply(tl, _t(x), te, tcfg, _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    want = _jit(JB._cross_attn, 3)(jl["cross_attn"], jnp.asarray(x), je,
                                   cfg)
    got = TB._cross_attn(tl["cross_attn"], _t(x), te, tcfg)
    assert got.shape == (B, S_DEC, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_function_at_sq_ne_sk_matches_jax_vjp(rng):
    """``FlashAttentionFn`` (12 queries, 40 keys, no mask, GQA 4:2, its
    backward in q blocks of 5: a ragged last block) against ``jax.vjp``
    of the reference's ``attention_reference(causal=False)``: out, dq, dk
    and dv within 2e-5·max(1, scale)."""
    q, do = (rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    def fwd_bwd(a, b, c, dout):
        out, vjp = jax.vjp(lambda *t: JA.attention_reference(
            *t, causal=False), a, b, c)
        return [out, *vjp(dout)]

    want = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, do)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    o = TA.flash_attention(*leaves, causal=False, q_block=5)
    assert "FlashAttentionFn" in type(
        o.grad_fn.next_functions[0][0]).__name__
    o.backward(_t(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          [o.detach()] + [t.grad for t in leaves], want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the model: encode, forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s_enc", [48, 80])
def test_encode_matches_reference(s_enc, model):
    """``encode`` at 48 frames and at 80 (past ``max_enc_len`` 64: the
    reference tiles ``pos_embed`` cyclically, so does the port)."""
    m, jp, tm, tp = model
    frames = _frames(np.random.default_rng(s_enc), s=s_enc)
    want = _jit(JMB.encode, 1)(jp, m, jnp.asarray(frames))
    got = TMB.encode(tp, tm, _t(frames))
    assert got.shape == (B, s_enc, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_forward_and_prefill_match_reference(model, inputs):
    """``forward`` with the reference's ``enc_out`` and the prefill step
    on the frames (which it encodes) against the reference's."""
    m, jp, tm, tp = model
    frames, toks, je = inputs
    want = jax.jit(lambda p, t, e: JMB.forward(p, m, t, enc_out=e))(
        jp, jnp.asarray(toks), je)
    got = TMB.forward(tp, tm, _t(toks).long(), enc_out=_t(je))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    batch = {"frames": frames, "tokens": toks}
    want = jax.jit(JTS.make_prefill_step(m))(jp, _jnp(batch))
    got = TTS.make_prefill_step(tm)(tp, {"frames": _t(frames),
                                         "tokens": _t(toks).long()})
    assert got.shape == (B, m.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_decode_steps_match_reference_and_forward(model, inputs):
    """8 ``decode_step``s with ``enc_out`` (cache 16) against the
    reference's jitted decode step's logits, and against the port's
    teacher-forced ``forward`` on the same 8 tokens."""
    m, jp, tm, tp = model
    _, toks, je = inputs
    n, cache = 8, 16
    jdec = jax.jit(JTS.make_decode_step(m))
    tdec = TTS.make_decode_step(tm)
    jst = JMB.init_decode_state(jp, m, B, cache)
    tst = TMB.init_decode_state(tp, tm, B, cache)
    te = _t(je)
    got = []
    for t in range(n):
        jl, jst = jdec(jp, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jst,
                       je)
        tl, tst = tdec(tp, _t(toks[:, t:t + 1]).long(), t, tst, te)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL,
                                   err_msg=f"step {t}")
        got.append(tl[:, 0])
    full = TMB.forward(tp, tm, _t(toks[:, :n]).long(), enc_out=te)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               **MODEL_TOL)


# ---------------------------------------------------------------------------
# gradients and train steps
# ---------------------------------------------------------------------------
def _stream_batch(m, i):
    toks = np.random.default_rng(100 + i).integers(
        0, m.vocab, size=(B, S_DEC + 1)).astype(np.int32)
    return {"frames": _frames(np.random.default_rng(200 + i)),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: (_t(v).long() if v.dtype == np.int32 else _t(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference_gradient(model):
    """The loss and gradient of the reference's ``loss_fn`` (``encode`` of
    the frames, then ``forward``, remat on: ``jax.checkpoint`` recomputes
    the same ops) on batch 0, jitted once."""
    m, jp, _, _ = model
    batch = _stream_batch(m, 0)

    def loss_fn(p, b):
        enc = JMB.encode(p, m, b["frames"], remat=True)
        return JTS.next_token_loss(JMB.forward(p, m, b["tokens"], enc_out=enc,
                                               remat=True), b["labels"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp, _jnp(batch))
    return batch, float(loss), grads


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(remat, model, reference_gradient):
    """``loss_and_grads`` with ``frames`` (encoder and decoder, the
    cross-attention's K/V projection gets its gradient through both):
    loss rtol 1e-5, each leaf within 1e-3 of its norm."""
    _, _, tm, tp = model
    batch, want_loss, want_g = reference_gradient
    loss, grads = TTS.loss_and_grads(tm, tp, _torch(batch), remat=remat)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = jax.tree.leaves(convert.lm_params_to_numpy(grads))
    want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.linalg.norm(g.astype(np.float64) - w)
        assert err <= 1e-3 * np.linalg.norm(w), \
            (jax.tree_util.keystr(path), err, np.linalg.norm(w))


@pytest.fixture(scope="module")
def reference_steps(model):
    """The reference's jitted ``make_train_step`` (remat on, its default)
    from its initial params over 3 batches, and with ``microbatches=2``
    over the first: for each step the params and optimizer state before
    it (numpy), its loss and the params after it."""
    m, jp0, _, _ = model
    out = {}
    for micro, n in ((1, 3), (2, 1)):
        jstep, joptim = JTS.make_train_step(m, lr=3e-4, microbatches=micro)
        jstep, jp, jopt = jax.jit(jstep), jp0, joptim.init(jp0)
        steps = []
        for i in range(n):
            before = jax.tree.map(np.asarray, (jp, jopt))
            jp, jopt, jm = jstep(jp, jopt, _jnp(_stream_batch(m, i)))
            steps.append((before, float(jm["loss"]), jax.tree.leaves(jp)))
        out[micro] = steps
    return out


#: 100x Adam's eps: below it, ``g / (|g| + eps)`` turns a float32
#: rounding difference of g into a visible change of the update
NOISE = 1e-6


@pytest.mark.parametrize("n,micro", [(1, 1), (3, 1), (1, 2)])
def test_train_steps_match_reference(n, micro, model, reference_steps):
    """``make_train_step`` (adamw, weight decay 0.1, clip 1.0, remat on),
    `micro` microbatches (``frames`` split with the tokens), a new batch
    each step: the port's first `n` steps, each taken from the params and
    optimizer state the reference held before it (so the optimizer's
    step count, mu and nu carry across), against the reference's: loss
    rtol 1e-5, params rtol 1e-4 / atol 1e-5.

    Adam's update ``m̂ / (√v̂ + 1e-8)`` is ~±lr whatever the gradient's
    size, so an element whose gradient is within ``NOISE`` of 0 but not
    0 (batch 0 has one in ``pos_embed``: -1.9e-9 in the reference, -3.8e-8
    here, float32 rounding of a sum whose terms reach 1e-3) moves by a
    different fraction of lr in the two packages.  Such elements (the
    port's own gradient) may instead be within 2·lr, at most 4 a leaf;
    taking each step from the reference's state keeps that difference
    from spreading to the next step's gradient."""
    m, _, tm, _ = model
    lr = 3e-4
    tstep, _ = TTS.make_train_step(tm, lr=lr, microbatches=micro)
    for i, ((params, opt), loss, want) in enumerate(
            reference_steps[micro][:n]):
        tp = convert.lm_params_from_numpy(params, "cpu")
        topt = convert.lm_opt_state_from_numpy(opt, "cpu")
        batch = _torch(_stream_batch(m, i))
        _, g = TTS.loss_and_grads(tm, tp, batch)
        noisy = [(a != 0) & (np.abs(a) < NOISE)
                 for a in jax.tree.leaves(convert.lm_params_to_numpy(g))]
        tp, topt, tmet = tstep(tp, topt, batch)
        assert int(topt.step) == i + 1
        np.testing.assert_allclose(float(tmet["loss"]), loss, rtol=1e-5)
        for got, w, nz in zip(jax.tree.leaves(
                convert.lm_params_to_numpy(tp)), want, noisy):
            w = np.asarray(w)
            d = np.abs(got - w)
            out = d > 1e-5 + 1e-4 * np.abs(w)
            assert int(out.sum()) <= 4 and np.all(nz[out]), (i, d.max())
            assert np.all(d[out] <= 2 * lr), (i, d.max())


# ---------------------------------------------------------------------------
# conversion, launcher
# ---------------------------------------------------------------------------
def test_params_round_trip_carries_the_encoder(model):
    m, jp, _, tp = model
    back = convert.lm_params_to_numpy(tp)
    assert set(back) == set(jp) and "encoder" in back
    assert set(back["encoder"]) == {"segments", "pos_embed", "ln_f"}
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    again = convert.lm_params_from_numpy(back, "cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(again)):
        assert torch.equal(a, b)


def test_train_launcher_refuses_whisper_early(tmp_path):
    """The synthetic stream makes no frames: the launcher says so before
    it builds anything."""
    with pytest.raises(ValueError, match="frames"):
        TLT.main(["--arch", ARCH, "--steps", "1", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path)])
