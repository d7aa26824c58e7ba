"""LM training in the port against the reference: the flash attention's
gradient (``nn/attention.FlashAttentionFn``, the counterpart of the
reference's custom VJP ``_flash_custom``), ``next_token_loss``, a model's
loss and gradients, ``make_train_step`` (one and three steps,
microbatches, remat), the schedules, ``GradCompressor``,
``SyntheticStream`` and the training launcher with its checkpoints.

Both packages get the same numpy inputs; the port computes from the
reference's own params and optimizer state (``convert``).  On the CPU the
Function's forward is the kernel's plain version (with lse) and its
backward the blocked torch-ops backward.  Tolerances: attention 1e-5 of
max(1, max|ref|) (float32 sums in another order); gradients of whole
models each leaf within 1e-4 of its norm; params after train steps rtol
1e-4, atol 1e-5; losses 1e-5 relative; the data stream, the compressor
and the schedules' float32 arithmetic bit for bit (``cosine`` within one
ulp, stated in its test).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import synthetic as JD
from repro.launch import train as JLT
from repro.models import base as JMB
from repro.nn import attention as JA
from repro.optim import compress as JCMP
from repro.optim import schedule as JSCH
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.data import synthetic as TD
from repro_torch.kernels import ops as TOPS
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL
from repro_torch.optim import compress as TCMP
from repro_torch.optim import schedule as TSCH
from repro_torch.optim import tree_leaves
from repro_torch.train import step as TTS

PORTED = ["gemma3-1b", "stablelm-1.6b", "qwen3-14b", "deepseek-coder-33b",
          "hymba-1.5b", "qwen2-vl-7b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, name, tol=1e-5):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err} > {tol * scale}"


def _leaf_norm_close(got, want, name, tol=1e-4):
    """Each leaf within tol of its norm."""
    g = [np.asarray(x, np.float64) for x in jax.tree.leaves(got)]
    w = [np.asarray(x, np.float64) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (name, i)
        err = np.linalg.norm(a - b)
        assert err <= tol * max(np.linalg.norm(b), 1e-30), \
            f"{name} leaf {i}: {err} vs norm {np.linalg.norm(b)}"


# ---------------------------------------------------------------------------
# the flash attention's gradient
# ---------------------------------------------------------------------------
def _attn_inputs(rng, b, s, h, hkv, d):
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _port_vjp(q, k, v, do, **kw):
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = TA.flash_attention(qt, kt, vt, **kw)
    out.backward(_t(do))
    # the (B, S, H, D) output is a transpose of what the Function returned
    return (out.detach(), qt.grad, kt.grad, vt.grad,
            out.grad_fn.next_functions[0][0])


def _ref_vjp(q, k, v, do, **kw):
    out, vjp = jax.vjp(lambda a, b_, c: JA.flash_attention_xla(a, b_, c, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (out, *vjp(jnp.asarray(do)))


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 32, 700])
def test_flash_function_matches_the_custom_vjp(window, hkv, rng):
    """S 1024: the reference runs ``_flash_custom`` (q_block 512), the
    port the Function over two 512-row blocks."""
    q, k, v, do = _attn_inputs(rng, 1, 1024, 4, hkv, 16)
    got = _port_vjp(q, k, v, do, window=window)
    assert type(got[4]).__name__ == "FlashAttentionFnBackward"
    want = _ref_vjp(q, k, v, do, window=window)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, f"{name} window={window} hkv={hkv}")
    # lse against the reference's _flash_fwd_impl ((B, Sq, H) there)
    _, lse = TOPS.flash_attention(*(_t(a).transpose(1, 2) for a in (q, k, v)),
                                  window=window, return_lse=True)
    _, ref_lse = JA._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, window, 512, 512, 0)
    _close(lse.transpose(1, 2).numpy(), ref_lse, f"lse window={window}")


@pytest.mark.parametrize("s,window,hkv", [(64, None, 2), (64, 16, 1),
                                          (600, 100, 2), (600, None, 4)])
def test_flash_function_matches_the_unblocked_vjp(s, window, hkv, rng):
    """Lengths the reference's blocks do not divide: it differentiates
    its unblocked attention; the port's Function takes 512-row blocks and
    a partial last one."""
    q, k, v, do = _attn_inputs(rng, 2, s, 4, hkv, 16)
    got = _port_vjp(q, k, v, do, window=window)
    want = _ref_vjp(q, k, v, do, window=window)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, f"{name} s={s} window={window}")


@pytest.mark.parametrize("q_block", [16, 48, 512])
def test_flash_backward_blocks_and_the_plain_route_agree(q_block, rng):
    """The Function's backward at several q blocks, and use_fused=False
    (the unblocked plain attention under torch's autograd), from the same
    inputs; q_offset continues a prefill."""
    q, k, v, do = _attn_inputs(rng, 1, 100, 4, 2, 16)
    kw = dict(window=40, q_offset=0)
    got = _port_vjp(q, k, v, do, q_block=q_block, **kw)
    plain = _port_vjp(q, k, v, do, use_fused=False, **kw)
    assert type(plain[4]).__name__ != "FlashAttentionFnBackward"
    for name, g, w in zip(("out", "dq", "dk", "dv"), got[:4], plain[:4]):
        _close(g.numpy(), w.numpy(), f"{name} q_block={q_block}")
    qs = q[:, 60:]
    dos = do[:, 60:]
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (qs, k, v))
    TA.flash_attention(qt, kt, vt, q_offset=60, q_block=16).backward(_t(dos))
    qp, kp, vp = (_t(a).requires_grad_(True) for a in (qs, k, v))
    TA.attention_reference(qp, kp, vp, q_offset=60).backward(_t(dos))
    for name, g, w in (("dq", qt, qp), ("dk", kt, kp), ("dv", vt, vp)):
        _close(g.grad.numpy(), w.grad.numpy(), f"q_offset {name}")


def test_flash_without_grad_takes_the_forward_alone(rng):
    q, k, v, _ = _attn_inputs(rng, 1, 32, 2, 1, 16)
    qt = _t(q).requires_grad_(True)
    with torch.no_grad():
        out = TA.flash_attention(qt, _t(k), _t(v))
    assert out.grad_fn is None
    assert TA.flash_attention(_t(q), _t(k), _t(v)).grad_fn is None


def test_plain_flash_lse_is_the_logsumexp_of_the_masked_scores(rng):
    q, k, v, _ = _attn_inputs(rng, 1, 40, 4, 2, 16)
    qt, kt, vt = (_t(a).transpose(1, 2) for a in (q, k, v))
    out, lse = TOPS.flash_attention(qt, kt, vt, window=8, return_lse=True)
    assert lse.shape == (1, 4, 40) and lse.dtype == torch.float32
    torch.testing.assert_close(out, TOPS.flash_attention(qt, kt, vt,
                                                         window=8),
                               rtol=0, atol=0)
    _, ref_lse = JA._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, 8, 8, 8, 0)
    _close(lse.transpose(1, 2).numpy(), ref_lse, "lse")


# ---------------------------------------------------------------------------
# loss, model gradients, train steps
# ---------------------------------------------------------------------------
def test_next_token_loss_matches_reference(rng):
    logits = (rng.normal(size=(2, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    want = JTS.next_token_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = TTS.next_token_loss(_t(logits), _t(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _carried(arch, seed=0):
    m = JC.get_reduced(arch)
    jp = JMB.init_params(jax.random.PRNGKey(seed), m)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return m, jp, TC.get_reduced(arch), tp


def _batch(vocab, b, s, step=0, seed=0):
    toks, labels = JD.SyntheticStream(JD.DataConfig(
        vocab=vocab, seq_len=s, global_batch=b, seed=seed)).batch(step)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": _t(toks).long(), "labels": _t(labels).long()})


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-1b"])
def test_model_loss_and_gradients_match_reference(arch):
    """S 1024: the reference's attention runs its custom VJP, the port's
    the Function; gemma3's local layers take the window's band."""
    m, jp, tm, tp = _carried(arch)
    jb, tb = _batch(m.vocab, 1, 1024)

    def loss_fn(p):
        return JTS.next_token_loss(JMB.forward(p, m, jb["tokens"]),
                                   jb["labels"])

    want_loss, want_g = jax.value_and_grad(loss_fn)(jp)
    loss, grads = TTS.loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _leaf_norm_close(convert.lm_params_to_numpy(grads), want_g, arch)


def _ref_steps(m, jp, batches, n, **kw):
    step, optim = JTS.make_train_step(m, remat=False, **kw)
    step = jax.jit(step)
    opt = optim.init(jp)
    losses = []
    for i in range(n):
        jp, opt, met = step(jp, opt, batches[i])
        losses.append(float(met["loss"]))
    return jp, opt, losses


def _port_steps(tm, tp, batches, n, **kw):
    step, optim = TTS.make_train_step(tm, **kw)
    opt = optim.init(tp)
    losses = []
    for i in range(n):
        tp, opt, met = step(tp, opt, batches[i])
        losses.append(float(met["loss"]))
    return tp, opt, losses


@pytest.mark.parametrize("n", [1, 3])
def test_train_steps_match_reference(n):
    """adamw (weight decay 0.1, clip 1.0) from carried params, a new
    synthetic batch each step."""
    m, jp, tm, tp = _carried("stablelm-1.6b")
    pairs = [_batch(m.vocab, 2, 64, step=i) for i in range(n)]
    want_p, want_opt, want_l = _ref_steps(m, jp, [p[0] for p in pairs], n,
                                          lr=3e-4)
    got_p, got_opt, got_l = _port_steps(tm, tp, [p[1] for p in pairs], n,
                                        lr=3e-4, remat=False)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(got_p)),
                    jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)
    assert int(got_opt.step) == int(want_opt.step) == n


@pytest.mark.parametrize("batch,microbatches", [(4, 2), (3, 3)])
def test_microbatches_match_reference(batch, microbatches):
    """At batch 3 the reference's split takes the (3, S) tokens and
    labels for M-RoPE positions and cuts them along S; the port's too."""
    m, jp, tm, tp = _carried("stablelm-1.6b")
    jb, tb = _batch(m.vocab, batch, 48)
    want_p, _, want_l = _ref_steps(m, jp, [jb], 1, lr=3e-4,
                                   microbatches=microbatches)
    got_p, _, got_l = _port_steps(tm, tp, [tb], 1, lr=3e-4, remat=False,
                                  microbatches=microbatches)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(got_p)),
                    jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_grad_compress_in_the_step_matches_reference():
    """The reference's calling convention: a callable on the gradients."""
    m, jp, tm, tp = _carried("stablelm-1.6b")
    jb, tb = _batch(m.vocab, 2, 32)
    jc, tc = JCMP.GradCompressor(), TCMP.GradCompressor()
    jres, tres = jc.init(jp), tc.init(tp)
    want_p, _, _ = _ref_steps(m, jp, [jb], 1, lr=3e-4,
                              grad_compress=lambda g: jc(g, jres)[0])
    got_p, _, _ = _port_steps(tm, tp, [tb], 1, lr=3e-4, remat=False,
                              grad_compress=lambda g: tc(g, tres)[0])
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(got_p)),
                    jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-1b"])
def test_remat_gives_the_same_step(arch):
    _, _, tm, tp = _carried(arch)
    _, tb = _batch(tm.vocab, 2, 48)
    a, _, la = _port_steps(tm, tp, [tb, tb], 2, remat=False)
    tp2 = convert.lm_params_from_numpy(convert.lm_params_to_numpy(
        _carried(arch)[3]), "cpu")
    b, _, lb = _port_steps(tm, tp2, [tb, tb], 2, remat=True)
    assert la == lb
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_update_in_place_in_slices_equals_update_and_apply(rng,
                                                          monkeypatch):
    """Slices of a leaf smaller than the leaf (4 elements: leaves of 15 and
    7 split unevenly) give the whole leaf's bits."""
    import importlib
    monkeypatch.setattr(importlib.import_module("repro_torch.optim.adamw"),
                        "IN_PLACE_CHUNK", 4)
    test_update_in_place_equals_update_and_apply(rng)


def test_update_in_place_equals_update_and_apply(rng):
    """The step's in-place Adam gives update + apply_updates' bits."""
    from repro_torch.optim import adamw, apply_updates
    opt = adamw(1e-3, weight_decay=0.1, clip_norm=1.0)
    p = {"a": _t(rng.normal(size=(5, 3)).astype(np.float32)),
         "b": [_t(rng.normal(size=(7,)).astype(np.float32))]}
    st = opt.init(p)
    p2 = convert.lm_params_from_numpy(convert.lm_params_to_numpy(p), "cpu")
    st2 = opt.init(p2)
    for _ in range(3):
        g = {"a": _t(rng.normal(size=(5, 3)).astype(np.float32) * 3),
             "b": [_t(rng.normal(size=(7,)).astype(np.float32))]}
        upd, st = opt.update(g, st, p)
        p = apply_updates(p, upd)
        st2 = opt.update_in_place(g, st2, p2)
    for x, y in zip(tree_leaves((p, st.mu, st.nu)),
                    tree_leaves((p2, st2.mu, st2.nu))):
        assert torch.equal(x, y)
    assert int(st2.step) == 3


def test_embedding_gradient_is_the_same_twice(rng):
    """The embedding's backward sums a row's gradients in a fixed order
    (indexing sums them with atomic adds on the CPU)."""
    table = _t(rng.normal(size=(64, 256)).astype(np.float32))
    ids = _t(rng.integers(0, 4, size=(2, 4096)))
    gy = _t(rng.normal(size=(2, 4096, 256)).astype(np.float32))
    t = table.requires_grad_(True)
    grads = [torch.autograd.grad(TL.embed_apply({"table": t}, ids), t, gy)[0]
             for _ in range(4)]
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    torch.testing.assert_close(TL.embed_apply({"table": table}, ids),
                               table[ids], rtol=0, atol=0)


@pytest.mark.parametrize("arch", PORTED)
def test_train_step_reduces_loss(arch):
    """The twin of tests/test_archs.py's: 8 steps on one batch, lr 3e-3."""
    m = TC.get_reduced(arch)
    params = TMB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    step, optim = TTS.make_train_step(m, lr=3e-3, remat=False)
    opt = optim.init(params)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, m.vocab, (2, 16), generator=g),
             "labels": torch.randint(0, m.vocab, (2, 16), generator=g)}
    losses = []
    for _ in range(8):
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# schedules, compression, data
# ---------------------------------------------------------------------------
STEPS = np.arange(0, 2001, dtype=np.int32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_constant_schedule_bit_for_bit():
    got = TSCH.constant(3e-4)(_t(STEPS))
    want = JSCH.constant(3e-4)(jnp.asarray(STEPS))
    assert got.dtype == torch.float32
    assert np.array_equal(np.asarray(got, np.float32),
                          np.asarray(want, np.float32))


@pytest.mark.parametrize("which", ["cosine", "linear_warmup_cosine"])
def test_cosine_schedules_bit_for_bit_where_cos_agrees(which):
    """Steps 0-2000.  The float32 arithmetic is the reference's; torch's
    and XLA's float32 cos round some arguments one ulp apart.  Where the
    two cos agree (and at every warm-up step, which takes none) the
    schedules agree bit for bit; elsewhere 1 + cos near cos = -1 cancels,
    so the one ulp of cos grows to at most 4 ulps of the rate."""
    args = (1e-3, 1000) if which == "cosine" else (1e-3, 100, 1000)
    got = getattr(TSCH, which)(*args)(_t(STEPS)).numpy()
    want = np.asarray(getattr(JSCH, which)(*args)(jnp.asarray(STEPS)))
    assert got.dtype == np.float32 and got.shape == want.shape
    warm = 0 if which == "cosine" else 100
    t = np.clip((STEPS - warm).astype(np.float32) / (1000 - warm), 0, 1)
    cos_t = torch.cos(np.pi * _t(t)).numpy()
    cos_j = np.asarray(jnp.cos(jnp.pi * jnp.asarray(t)))
    assert _ulps(cos_t, cos_j).max() <= 1
    same = (_ulps(cos_t, cos_j) == 0) | (STEPS < warm)
    assert same.mean() > 0.9
    assert np.array_equal(got[same], want[same])
    assert _ulps(got, want).max() <= 4


def test_grad_compressor_bit_for_bit_over_five_steps(rng):
    shapes = {"w": (33, 17), "b": (17,), "deep": [(4, 5, 6)]}
    jc, tc = JCMP.GradCompressor(), TCMP.GradCompressor()

    def draw():
        return {"w": rng.normal(size=shapes["w"]).astype(np.float32),
                "b": rng.normal(size=shapes["b"]).astype(np.float32) * 1e-3,
                "deep": [rng.normal(size=shapes["deep"][0]).astype(
                    np.float32) * 50]}

    g0 = draw()
    jres = jc.init(jax.tree.map(jnp.asarray, g0))
    tres = tc.init(jax.tree.map(_t, g0))
    for _ in range(5):
        g = draw()
        jq, jres = jc(jax.tree.map(jnp.asarray, g), jres)
        tq, tres = tc(jax.tree.map(_t, g), tres)
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jq)) +
                        jax.tree.leaves(jax.tree.map(np.asarray, jres)),
                        tree_leaves(tq) + tree_leaves(tres)):
            assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 4, 0),
                                                  (100352, 33, 2, 3),
                                                  (128, 16, 8, 7)])
def test_synthetic_stream_bit_for_bit(vocab, seq, batch, seed):
    jcfg = JD.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    tcfg = TD.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    js, ts = JD.SyntheticStream(jcfg), TD.SyntheticStream(tcfg)
    for step in (0, 1, 57):
        for shard, n in ((0, 1), (1, 2)):
            for a, b in zip(js.batch(step, shard, n), ts.batch(step, shard, n)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the launcher and its checkpoints
# ---------------------------------------------------------------------------
BASE = ["--arch", "stablelm-1.6b", "--batch", "4", "--seq", "32",
        "--ckpt-every", "4"]


def _history(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in json.load(f)}


def test_port_launcher_restart_equals_an_uninterrupted_run(tmp_path):
    run = BASE + ["--steps", "12", "--log-every", "1", "--device", "cpu"]
    h1, h2 = str(tmp_path / "h1.json"), str(tmp_path / "h2.json")
    assert TLT.main(run + ["--ckpt-dir", str(tmp_path / "a"),
                           "--history-out", h1]) == 0
    assert TLT.main(run + ["--ckpt-dir", str(tmp_path / "b"),
                           "--history-out", h2,
                           "--simulate-failure-at", "7"]) == 0
    a, b = _history(h1), _history(h2)
    assert sorted(a) == sorted(b) == list(range(1, 13))
    assert a == b


def test_port_launcher_restarts_from_the_seed_before_a_checkpoint(tmp_path):
    run = BASE + ["--steps", "3", "--log-every", "1", "--device", "cpu"]
    h1, h2 = str(tmp_path / "h1.json"), str(tmp_path / "h2.json")
    TLT.main(run + ["--ckpt-dir", str(tmp_path / "a"), "--history-out", h1])
    TLT.main(run + ["--ckpt-dir", str(tmp_path / "b"), "--history-out", h2,
                    "--simulate-failure-at", "2"])
    assert _history(h1) == _history(h2)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference writes step 4; the port resumes it and takes step 5,
    whose loss is the reference's own step 5."""
    ck, h_ref, h_port = (str(tmp_path / n) for n in ("ck", "r.json",
                                                     "p.json"))
    JLT.main(BASE + ["--steps", "4", "--ckpt-dir", ck, "--log-every", "4"])
    JLT.main(BASE + ["--steps", "5", "--ckpt-dir", str(tmp_path / "whole"),
                     "--log-every", "1", "--history-out", h_ref])
    TLT.main(BASE + ["--steps", "5", "--ckpt-dir", ck, "--log-every", "1",
                     "--history-out", h_port, "--device", "cpu"])
    got, want = _history(h_port), _history(h_ref)
    assert sorted(got) == [5]
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The port writes step 4 from the reference's initial state; the
    reference resumes it, and its step 5 matches the port's."""
    from repro.checkpoint.manager import CheckpointManager as JCM
    from repro_torch.checkpoint.manager import CheckpointManager as TCM
    m = JC.get_reduced("stablelm-1.6b")
    jp = JMB.init_params(jax.random.PRNGKey(0), m)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tm = TC.get_reduced("stablelm-1.6b")
    step, optim = TTS.make_train_step(tm, lr=1e-3, remat=False)
    opt = optim.init(tp)
    stream = TD.SyntheticStream(TD.DataConfig(vocab=m.vocab, seq_len=32,
                                              global_batch=4))

    def batch(i):
        t, lab = stream.batch(i)
        return {"tokens": _t(t).long(), "labels": _t(lab).long()}

    for i in range(4):
        tp, opt, _ = step(tp, opt, batch(i))
    TCM(str(tmp_path)).save(4, {"params": tp, "opt": opt})
    _, _, port5 = step(tp, opt, batch(4))
    jstep, joptim = JTS.make_train_step(m, lr=1e-3, remat=False)
    like = {"params": jp, "opt": joptim.init(jp)}
    state = JCM(str(tmp_path)).restore(4, like)
    assert int(state["opt"].step) == 4
    t, lab = stream.batch(4)
    _, _, met = jax.jit(jstep)(state["params"], state["opt"],
                               {"tokens": jnp.asarray(t),
                                "labels": jnp.asarray(lab)})
    np.testing.assert_allclose(float(port5["loss"]), float(met["loss"]),
                               rtol=1e-5)
    # and the optimizer state carried across, leaf for leaf
    ref_opt = jax.tree.map(np.asarray, state["opt"])
    back = convert.lm_opt_state_to_numpy(convert.lm_opt_state_from_numpy(
        ref_opt, "cpu"))
    assert back["step"] == ref_opt.step
    for a, b in zip(jax.tree.leaves((back["mu"], back["nu"])),
                    jax.tree.leaves((ref_opt.mu, ref_opt.nu))):
        assert np.array_equal(a, b)
