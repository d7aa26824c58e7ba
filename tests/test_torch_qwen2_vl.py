"""qwen2-vl-7b in the port against the reference, at the reduced config
(2 layers, d 64, 4 heads / 2 kv of 16, d_ff 128, vocab 512, untied,
M-RoPE sections (2, 3, 3)): ``apply_mrope`` (also at the full width's
head dim 128, sections (16, 24, 24), theta 1e6), text-only M-RoPE as
RoPE bit for bit, ``forward`` and the prefill step with text positions
and with a vision layout of (3, B, S) positions, decode steps, the
``Engine``, the gradient, train steps (also in microbatches), the
training launcher, and the reference's microbatch split at B = 3, which
fails in both packages.

Both packages get the same numpy inputs and the port computes from the
reference's own params (``convert.lm_params_from_numpy``); on the CPU
its attention is the kernel's plain version.  Tolerances: M-RoPE within
rtol and atol 1e-5 (float32 cos and sin of the same angles, each
package's own); whole models within ``MODEL_TOL`` (rtol 1e-4, atol 2e-5:
float32 sums in another order over 2 layers); a loss within rtol 1e-5
and each gradient leaf within 1e-3 of its norm; params after train
steps within rtol 1e-4, atol 1e-5.  The reduced init's bits are
``tests/test_torch_lm_init.py``'s.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as JS
from repro.launch import train as JLT
from repro.models import base as JMB
from repro.nn import layers as JL
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.configs.qwen2_vl_7b import vision_positions
from repro_torch.launch import serve as TS
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB
from repro_torch.nn import layers as TL
from repro_torch.optim import tree_leaves
from repro_torch.train import step as TTS

ARCH = "qwen2-vl-7b"
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
B, S = 2, 48
#: the vision layout at S: 4 text tokens, a 4 x 4 image, 28 text tokens
LAYOUT = dict(text=4, grid=4)
#: (head dim, sections, theta): the reduced config's and the full width's
MROPE = {"reduced": (16, (2, 3, 3), 1e4), "full": (128, (16, 24, 24), 1e6)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _positions(layout, b=B, s=S):
    """(B, S) text positions for "text", else the (3, B, S) vision
    layout (`layout` a dict of ``vision_positions``' text and grid, or
    "vision" for LAYOUT); numpy int32 (the reference's dtype; the port
    takes them as int64)."""
    if layout == "text":
        return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kw = LAYOUT if layout == "vision" else layout
    return vision_positions(b, s, **kw).numpy().astype(np.int32)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, its params from seed 0, the port's cfg, the
    reference's params converted)."""
    m = JC.get_reduced(ARCH)
    jp = JMB.init_params(jax.random.PRNGKey(0), m)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return m, jp, TC.get_reduced(ARCH), tp


@pytest.fixture(scope="module")
def tokens(model):
    return np.random.default_rng(5).integers(
        0, model[0].vocab, size=(B, S)).astype(np.int32)


def _leaf_norm_close(got_tree, want_tree):
    got = jax.tree.leaves(convert.lm_params_to_numpy(got_tree))
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.linalg.norm(g.astype(np.float64) - w)
        assert err <= 1e-3 * np.linalg.norm(w), \
            (jax.tree_util.keystr(path), err, np.linalg.norm(w))


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
def test_vision_positions_follow_qwen2_vl_layout():
    """Text 0..3; the image at t = 4, h = 4 + row, w = 4 + col; text
    again from 4 + grid = 8."""
    p = vision_positions(2, S, text=4, grid=4)
    assert p.shape == (3, 2, S) and torch.equal(p[:, 0], p[:, 1])
    t, h, w = p[:, 0]
    assert t[:4].tolist() == h[:4].tolist() == w[:4].tolist() == [0, 1, 2, 3]
    assert t[4:20].tolist() == [4] * 16
    assert h[4:20].tolist() == [4 + i // 4 for i in range(16)]
    assert w[4:20].tolist() == [4 + i % 4 for i in range(16)]
    assert t[20:].tolist() == h[20:].tolist() == w[20:].tolist() == \
        list(range(8, 8 + S - 20))


@pytest.mark.parametrize("size", sorted(MROPE))
def test_apply_mrope_matches_reference(size, rng):
    """Distinct t / h / w rows (offset and shuffled), rtol and atol 1e-5."""
    dh, sections, theta = MROPE[size]
    x = rng.normal(size=(2, 33, 4, dh)).astype(np.float32)
    pos = np.stack([rng.permutation(np.arange(33) + 900 * r)
                    for r in range(3 * 2)]).reshape(3, 2, 33).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta)
    got = TL.apply_mrope(_t(x), _t(pos).long(), sections, theta)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(AssertionError):
        TL.apply_mrope(_t(x), _t(pos).long(), (1, 1, 1), theta)


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("size", sorted(MROPE))
def test_equal_rows_give_rope_bits(size, package, rng):
    """With t = h = w, each angle is the product ``apply_rope`` forms, so
    M-RoPE is RoPE to the bit, in each package."""
    dh, sections, theta = MROPE[size]
    x = rng.normal(size=(2, 40, 4, dh)).astype(np.float32)
    pos = (np.arange(40, dtype=np.int32) + 3000)[None].repeat(2, 0)
    pos3 = np.broadcast_to(pos, (3, 2, 40)).copy()
    if package == "port":
        a = TL.apply_mrope(_t(x), _t(pos3).long(), sections, theta).numpy()
        b = TL.apply_rope(_t(x), _t(pos).long(), theta).numpy()
    else:
        a = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                      sections, theta))
        b = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta))
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_text_positions_and_their_broadcast_give_the_same_logits(model,
                                                                 tokens):
    _, _, tm, tp = model
    toks = _t(tokens).long()
    pos = _t(_positions("text")).long()
    a = TMB.forward(tp, tm, toks)
    b = TMB.forward(tp, tm, toks, positions=pos)
    c = TMB.forward(tp, tm, toks, positions=pos[None].expand(3, B, S))
    assert torch.equal(a, b) and torch.equal(a, c)


# ---------------------------------------------------------------------------
# forward, prefill, decode, the Engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["text", "vision"])
def test_forward_matches_reference(layout, model, tokens):
    m, jp, tm, tp = model
    pos = _positions(layout)
    want = np.asarray(JMB.forward(jp, m, jnp.asarray(tokens),
                                  positions=jnp.asarray(pos)))
    got = TMB.forward(tp, tm, _t(tokens).long(), positions=_t(pos).long())
    assert got.shape == (B, S, m.vocab)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


@pytest.mark.parametrize("layout", ["text", "vision"])
def test_prefill_step_matches_reference(layout, model, tokens):
    m, jp, tm, tp = model
    pos = _positions(layout)
    want = np.asarray(JTS.make_prefill_step(m)(
        jp, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)}))
    got = TTS.make_prefill_step(tm)(
        tp, {"tokens": _t(tokens).long(), "positions": _t(pos).long()})
    assert got.shape == (B, m.vocab)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_decode_steps_match_reference_and_the_prefill(model, tokens):
    """A 12-token prompt then 28 more tokens, one decode step each (the
    (B, 1) positions broadcast to M-RoPE's three rows), with a per-lane
    start, against the reference's jitted decode step; the prompt's last
    step against the prefill step on the prompt."""
    m, jp, tm, tp = model
    cache_len, plen = 48, 12
    jstates = JMB.init_decode_state(jp, m, B, cache_len)
    tstates = TMB.init_decode_state(tp, tm, B, cache_len)
    jdec = jax.jit(JTS.make_decode_step(m))
    tdec = TTS.make_decode_step(tm)
    for pos in range(40):
        tok = tokens[:, pos:pos + 1]
        jl, jstates = jdec(jp, jnp.asarray(tok), jnp.int32(pos), jstates)
        tl, tstates = tdec(tp, _t(tok).long(), pos, tstates)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        if pos == plen - 1:
            want = TTS.make_prefill_step(tm)(
                tp, {"tokens": _t(tokens[:, :plen]).long()})
            np.testing.assert_allclose(tl[:, 0].numpy(), want.numpy(),
                                       **MODEL_TOL)
    assert all(st["len"] == 40 for seg in tstates for st in seg)


def _serve(serve, m, params, prompts, slots, **kw):
    eng = serve.Engine(m, params, slots, 64, **kw)
    for r, p in enumerate(prompts):
        eng.submit(serve.Request(rid=r, prompt=list(p), max_new=6))
    eng.run(max_iters=512)
    assert len(eng.finished) == len(prompts)
    return {r.rid: r.out for r in eng.finished}


def test_engine_generates_the_reference_tokens(model):
    """Five requests through two slots (three reuse a lane), text
    positions from the engine's clock as the reference's: the same
    tokens."""
    m, jp, tm, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, m.vocab, size=n).tolist()
               for n in (12, 7, 9, 12, 5)]
    assert _serve(TS, tm, tp, prompts, 2, device="cpu") == \
        _serve(JS, m, jp, prompts, 2)


# ---------------------------------------------------------------------------
# gradients, train steps, the launcher
# ---------------------------------------------------------------------------
def _batch(m, b=B, s=S, step=0, layout="vision"):
    """numpy tokens, labels (the next tokens, the last wrapped) and, for
    the vision layout, (3, B, S) positions, from a seed per step."""
    toks = np.random.default_rng(100 + step).integers(
        0, m.vocab, size=(b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if layout != "text":
        out["positions"] = _positions(layout, b, s)
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(remat, model):
    """``loss_and_grads`` with (3, B, S) positions against
    ``jax.value_and_grad`` of the reference's loss: loss rtol 1e-5, each
    leaf (the untied ``lm_head`` too) within 1e-3 of its norm."""
    m, jp, tm, tp = model
    batch = _batch(m)

    def loss_fn(p, b):
        return JTS.next_token_loss(JMB.forward(
            p, m, b["tokens"], positions=b["positions"]), b["labels"])

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(jp, _jnp(batch))
    loss, grads = TTS.loss_and_grads(tm, tp, _torch(batch), remat=remat)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _leaf_norm_close(grads, want_g)


@pytest.mark.parametrize("n,micro", [(1, 1), (3, 1), (1, 2), (3, 2)])
def test_train_steps_match_reference(n, micro, model):
    """``make_train_step`` (adamw, weight decay 0.1, clip 1.0), `micro`
    microbatches (the (3, B, S) positions cut along B, the tokens and
    labels along axis 0), a new batch each step, params carried by each
    package: losses rtol 1e-4, params rtol 1e-4 / atol 1e-5."""
    m, jp, tm, _ = model
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batches = [_batch(m, b=4, s=32, step=i) for i in range(n)]
    jstep, joptim = JTS.make_train_step(m, lr=3e-4, microbatches=micro)
    jstep, jopt = jax.jit(jstep), joptim.init(jp)
    tstep, toptim = TTS.make_train_step(tm, lr=3e-4, microbatches=micro,
                                        remat=False)
    topt = toptim.init(tp)
    for i in range(n):
        jp, jopt, jm = jstep(jp, jopt, _jnp(batches[i]))
        tp, topt, tmet = tstep(tp, topt, _torch(batches[i]))
        np.testing.assert_allclose(float(tmet["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert int(topt.step) == n
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_microbatch_split_at_batch_3_fails_in_both_packages(model):
    """The reference's split takes any value whose axis 0 is 3 for
    positions: at B = 3 and ``microbatches = 3`` the tokens and labels
    (3, S) are cut along S, the positions (3, 3, S) along B, and M-RoPE
    cannot broadcast (3, 1, S) positions over (3, S/3) tokens.  The port
    copies the rule, so it fails there too."""
    m, jp, tm, tp = model
    batch = _batch(m, b=3, s=12, layout=dict(text=2, grid=2))
    jstep, joptim = JTS.make_train_step(m, microbatches=3)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jstep(jp, joptim.init(jp), _jnp(batch))
    tstep, toptim = TTS.make_train_step(tm, microbatches=3)
    with pytest.raises(RuntimeError, match="must match the size"):
        tstep(tp, toptim.init(tp), _torch(batch))
    micro = TTS._split(_torch(batch)["tokens"], 3)
    assert micro.shape == (3, 3, 4)
    assert torch.equal(micro[1], _torch(batch)["tokens"][:, 4:8])


def test_train_launcher_losses_equal_the_reference(tmp_path):
    """``launch/train --arch qwen2-vl-7b`` on the CPU (the stream makes no
    positions, so ``forward`` broadcasts its text positions): each logged
    loss is the reference launcher's."""
    base = ["--arch", ARCH, "--batch", "4", "--seq", "32", "--steps", "4",
            "--log-every", "1"]
    h_ref, h_port = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    JLT.main(base + ["--ckpt-dir", str(tmp_path / "r"),
                     "--history-out", h_ref])
    TLT.main(base + ["--ckpt-dir", str(tmp_path / "p"), "--history-out",
                     h_port, "--device", "cpu"])
    with open(h_ref) as f:
        want = [r["loss"] for r in json.load(f)]
    with open(h_port) as f:
        got = [r["loss"] for r in json.load(f)]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_params_round_trip_carries_the_lm_head(model):
    m, jp, _, tp = model
    back = convert.lm_params_to_numpy(tp)
    assert "lm_head" in back and not m.tied_embeddings
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    again = convert.lm_params_from_numpy(back, "cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(again)):
        assert torch.equal(a, b)
