"""The port's LM substrate against the reference: configs, RMSNorm, RoPE,
attention (full sequence and decode), the dense models' forward and
prefill step, decode steps, and the continuous-batching ``Engine``.

Both packages get the same numpy inputs; the port computes from the
reference's own params (``jax.tree.map(np.asarray, params)`` through
``convert.lm_params_from_numpy``).  On the CPU the port's full-sequence
attention is the kernel's plain version.  Tolerances: elementwise layers
within 1e-6 (float32 rounding of rsqrt, cos, sin); attention within
2e-5 and whole models within rtol 1e-4, atol 2e-5 (float32 sums taken in
another order, over up to 7 layers).  The engine must emit the same
tokens.
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
from repro.nn import attention as JA
from repro.nn import blocks as JB
from repro.nn import layers as JL
from repro.nn import ssm as JSSM
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.launch import serve as TS
from repro_torch.models import base as TMB
from repro_torch.nn import attention as TA
from repro_torch.nn import blocks as TB
from repro_torch.nn import layers as TL
from repro_torch.nn import ssm as TSSM
from repro_torch.train import step as TTS

PORTED = ["gemma3-1b", "stablelm-1.6b", "qwen3-14b", "deepseek-coder-33b",
          "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b",
          "xlstm-1.3b", "whisper-small", "qwen2-vl-7b"]
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, its params, the port's cfg, converted params)."""
    out = {}
    for arch in ("gemma3-1b", "stablelm-1.6b", "qwen3-14b", "hymba-1.5b"):
        m = JC.get_reduced(arch)
        jp = JMB.init_params(jax.random.PRNGKey(0), m)
        tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        out[arch] = (m, jp, TC.get_reduced(arch), tp)
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["get_arch", "get_reduced"])
@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_the_reference_field_for_field(arch, which):
    ref, port = getattr(JC, which)(arch), getattr(TC, which)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_layers == ref.n_layers


def test_every_reference_arch_is_ported():
    assert TC.list_archs() == JC.list_archs()
    assert sorted(TC.PORTED) == sorted(TC.list_archs())
    assert sorted(TC.canonical(a) for a in PORTED) == sorted(TC.PORTED)


def test_param_count_and_full_width_shapes():
    m = TC.get_arch("gemma3-1b")
    assert [s.repeats for s in m.segments] == [4, 2]
    windows = [sp.cfg.window for s in m.segments for _ in range(s.repeats)
               for sp in s.pattern]
    assert windows.count(None) == 4 and windows.count(1024) == 22
    jm = JC.get_reduced("gemma3-1b")
    jp = JMB.init_params(jax.random.PRNGKey(1), jm)
    tp = TMB.init_params(prng.prng_key(torch.tensor(1)),
                         TC.get_reduced("gemma3-1b"), "cpu")
    assert TMB.param_count(tp) == JMB.param_count(jp)
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(
        lambda a: tuple(a.shape), convert.lm_params_to_numpy(tp))


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------
def test_rmsnorm_matches_reference(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = JL.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = TL.rmsnorm_apply({"scale": _t(scale)}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta, rng):
    x = rng.normal(size=(2, 33, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(33) + 900, (2, 33)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(TL.rope_freqs(32, theta).numpy(),
                               np.asarray(JL.rope_freqs(32, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 64, 0), (False, None, 0), (True, 100, 128)])
def test_full_sequence_attention_matches_reference(causal, window, q_offset,
                                                   rng):
    """(B, S, H, D) through the port's ``flash_attention`` (the plain
    version on the CPU) against the reference's blocked XLA attention at
    S = 1024 (its scanned path) and its unblocked reference."""
    b, s, h, hkv, d = 1, 1024, 4, 2, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s + q_offset, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s + q_offset, hkv, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = TA.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JA.attention_reference(jq, jk, jv, **kw)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        TA.attention_reference(_t(q), _t(k), _t(v), **kw).numpy(),
        np.asarray(JA.attention_reference(jq, jk, jv, **kw)),
        rtol=2e-5, atol=2e-5)
    if q_offset == 0:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(JA.flash_attention_xla(jq, jk, jv, **kw)),
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ring,window,start", [
    (False, None, False), (False, None, True), (False, 16, True),
    (True, 16, False), (True, 16, True)])
@pytest.mark.parametrize("cache_len", [5, 16, 37])
def test_decode_attention_matches_reference(ring, window, start, cache_len,
                                            rng):
    b, h, hkv, d = 3, 4, 2, 16
    sc = 16 if ring else 48
    q1 = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, sc, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, sc, hkv, d)).astype(np.float32)
    st = np.array([0, 3, cache_len - 1], np.int32) if start else None
    kw = dict(window=window, ring=ring)
    want = JA.decode_attention(jnp.asarray(q1), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.int32(cache_len),
                               start=None if st is None else jnp.asarray(st),
                               **kw)
    got = TA.decode_attention(_t(q1), _t(kc), _t(vc), cache_len,
                              start=None if st is None else _t(st), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ring_narrower_than_its_window_is_a_linear_cache(rng):
    """With Sc < window (gemma3's 1024 window on a 128-token cache) the
    ring holds positions 0..Sc-1 in place until it would wrap: the same
    as a linear cache of Sc slots."""
    b, h, hkv, d, sc = 2, 4, 1, 16, 8
    q1 = _t(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    kc = _t(rng.normal(size=(b, sc, hkv, d)).astype(np.float32))
    vc = _t(rng.normal(size=(b, sc, hkv, d)).astype(np.float32))
    for n in range(1, sc + 1):
        torch.testing.assert_close(
            TA.decode_attention(q1, kc, vc, n, window=32, ring=True),
            TA.decode_attention(q1, kc, vc, n, window=32), rtol=0, atol=0)
    with pytest.raises(ValueError, match="Sc <= window"):
        TA.decode_attention(q1, kc, vc, 3, window=4, ring=True)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,s", [("gemma3-1b", 64), ("gemma3-1b", 1024),
                                    ("stablelm-1.6b", 64),
                                    ("qwen3-14b", 64), ("hymba-1.5b", 64),
                                    ("hymba-1.5b", 128)])
def test_forward_matches_reference(arch, s, models, rng):
    """gemma3 at S = 64 (reference: unblocked) and S = 1024 (its banded
    and full blocked paths); stablelm (MHA) and qwen3 (qk-norm, untied);
    hymba (the SSM branch in every layer) at S = 64 and 128, where the
    reference's scan takes its 64-step chunks."""
    m, jp, tm, tp = models[arch]
    toks = rng.integers(0, m.vocab, size=(2, s)).astype(np.int32)
    want = np.asarray(JMB.forward(jp, m, jnp.asarray(toks)))
    got = TMB.forward(tp, tm, _t(toks).long())
    assert got.shape == (2, s, m.vocab)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    # the explicit opt-out is the same plain version on the CPU
    torch.testing.assert_close(
        TMB.forward(tp, tm, _t(toks).long(), use_fused=False), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("s", [64, 1024])
def test_prefill_step_matches_reference(s, models, rng):
    m, jp, tm, tp = models["gemma3-1b"]
    toks = rng.integers(0, m.vocab, size=(2, s)).astype(np.int32)
    want = np.asarray(JTS.make_prefill_step(m)(jp, {"tokens":
                                                    jnp.asarray(toks)}))
    got = TTS.make_prefill_step(tm)(tp, {"tokens": _t(toks).long()})
    assert got.shape == (2, m.vocab)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-14b", "hymba-1.5b"])
def test_decode_steps_match_reference(arch, models, rng):
    """40 decode steps (gemma3's and hymba's 32-slot rings wrap) with a
    per-lane start, against the reference's jitted decode step (hymba's
    SSM states carried in place by the port, returned by the
    reference)."""
    m, jp, tm, tp = models[arch]
    b, cache_len = 2, 48
    jstates = JMB.init_decode_state(jp, m, b, cache_len)
    tstates = TMB.init_decode_state(tp, tm, b, cache_len)
    jdec = jax.jit(JTS.make_decode_step(m))
    tdec = TTS.make_decode_step(tm)
    start = np.array([0, 5], np.int32)
    for pos in range(40):
        tok = rng.integers(0, m.vocab, size=(b, 1)).astype(np.int32)
        jl, jstates = jdec(jp, jnp.asarray(tok), jnp.int32(pos), jstates,
                           start=jnp.asarray(start))
        tl, tstates = tdec(tp, _t(tok).long(), pos, tstates,
                           start=_t(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert all(st["len"] == 40 for seg in tstates for st in seg)


def test_decode_matches_prefill(models, rng):
    """The port's two attention paths agree: decoding a prompt token by
    token ends on the prefill step's last-position logits."""
    m, _, tm, tp = models["gemma3-1b"]
    toks = rng.integers(0, m.vocab, size=(2, 40)).astype(np.int64)
    states = TMB.init_decode_state(tp, tm, 2, 64)
    for pos in range(40):
        logits, states = TMB.decode_step(tp, tm, _t(toks[:, pos:pos + 1]),
                                         pos, states)
    want = TTS.make_prefill_step(tm)(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(logits[:, 0].numpy(), want.numpy(),
                               **MODEL_TOL)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def _serve(serve, m, params, prompts, slots, cache_len=64, max_new=6, **kw):
    """Serve `prompts` with `serve`'s Engine (either package's module)."""
    eng = serve.Engine(m, params, slots, cache_len, **kw)
    for r, p in enumerate(prompts):
        eng.submit(serve.Request(rid=r, prompt=list(p), max_new=max_new))
    eng.run(max_iters=512)
    assert len(eng.finished) == len(prompts)
    return {r.rid: r.out for r in eng.finished}


def _port(m, params, prompts, slots, **kw):
    return _serve(TS, m, params, prompts, slots, device="cpu", **kw)


@pytest.mark.parametrize("arch", ["gemma3-1b", "stablelm-1.6b",
                                  "hymba-1.5b"])
def test_engine_generates_the_reference_tokens(arch, models):
    """Five requests through two slots (three reuse a lane): the same
    tokens as the reference's ``Engine`` for every request."""
    m, jp, tm, tp = models[arch]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, m.vocab, size=n).tolist()
               for n in (12, 7, 9, 12, 5)]
    assert _port(tm, tp, prompts, 2) == _serve(JS, m, jp, prompts, 2)


def test_reused_slot_matches_fresh_engine(models):
    """Back-to-back requests through one slot: the second decodes on top
    of the first one's leftover KV and must match a fresh engine."""
    _, _, tm, tp = models["gemma3-1b"]
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, tm.vocab, size=12).tolist()
    p2 = rng.integers(0, tm.vocab, size=9).tolist()
    reused = _port(tm, tp, [p1, p2], 1)
    assert reused[1] == _port(tm, tp, [p2], 1)[0]
    assert reused[0] == _port(tm, tp, [p1], 1)[0]


def test_reused_slot_matches_fresh_engine_interleaved(models):
    _, _, tm, tp = models["gemma3-1b"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tm.vocab, size=n).tolist() for n in (10, 14, 8)]
    served = _port(tm, tp, prompts, 2)
    for rid, p in enumerate(prompts):
        assert served[rid] == _port(tm, tp, [p], 1)[0], rid


def test_kv_capacity_exhaustion_raises(models):
    _, _, tm, tp = models["gemma3-1b"]
    rng = np.random.default_rng(2)
    eng = TS.Engine(tm, tp, 1, cache_len=36, device="cpu")
    eng.submit(TS.Request(rid=0, prompt=rng.integers(0, tm.vocab, 8).tolist(),
                          max_new=4))
    eng.submit(TS.Request(rid=1, prompt=rng.integers(0, tm.vocab, 8).tolist(),
                          max_new=24))
    with pytest.raises(RuntimeError, match="KV capacity"):
        eng.run(max_iters=64)


def test_a_ring_narrower_than_its_window_sets_the_horizon(models):
    """A windowed-only model on a cache narrower than its window would
    drop in-window keys once the ring wraps: the engine stops first."""
    _, _, _, tp = models["gemma3-1b"]
    tm = TC.get_reduced("gemma3-1b")
    local = dataclasses.replace(tm, segments=tm.segments[1:])  # 1 local layer
    params = dict(tp, segments=tp["segments"][1:])
    assert TS.Engine(local, params, 1, 32, device="cpu")._kv_horizon is None
    eng = TS.Engine(local, params, 1, 16, device="cpu")
    assert eng._kv_horizon == 16
    eng.submit(TS.Request(rid=0, prompt=[1] * 10, max_new=10))
    with pytest.raises(RuntimeError, match="KV capacity"):
        eng.run()


def test_serve_main_runs_on_the_cpu(capsys):
    assert TS.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                    "--max-new", "4"]) == 0
    assert "requests=3/3" in capsys.readouterr().out


def test_lm_params_round_trip(models):
    _, jp, _, tp = models["qwen3-14b"]
    back = convert.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert "lm_head" in back


# ---------------------------------------------------------------------------
# hymba: the SSM branch in the block, its decode state, the Engine's reset
# ---------------------------------------------------------------------------
def test_hymba_block_matches_reference(rng):
    """One hybrid block (window 8, ssm_state 8): block_apply at S 70 and
    six block_decode steps, state and all, against the reference's."""
    cfg = dict(d_model=32, n_heads=4, n_kv=2, d_ff=64, window=8,
               ssm_state=8)
    jcfg, tcfg = JB.BlockCfg(**cfg), TB.BlockCfg(**cfg)
    jp = JB.block_init(jax.random.PRNGKey(4), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["mix_a"].shape == () and tp["mix_s"].shape == ()
    x = rng.normal(size=(2, 70, 32)).astype(np.float32)
    pos = np.tile(np.arange(70), (2, 1))
    want = JB.block_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TB.block_apply(tp, _t(x), tcfg, _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    jst = {"kv": tuple(jnp.zeros((2, 8, 2, 8)) for _ in range(2)),
           "len": jnp.int32(0), "ssm": JSSM.ssm_decode_init(jp["ssm"], 2)}
    tst = {"kv": tuple(torch.zeros(2, 8, 2, 8) for _ in range(2)), "len": 0,
           "ssm": TSSM.ssm_decode_init(tp["ssm"], 2, "cpu")}
    for t in range(6):
        p = np.full((2, 1), t, np.int32)
        jy, jst = JB.block_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                  jnp.asarray(p), jst, ring=True)
        ty, tst = TB.block_decode(tp, _t(x[:, t:t + 1]), tcfg, _t(p), tst,
                                  ring=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODEL_TOL)
        for a, b in zip(tst["ssm"], jst["ssm"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)
    assert tst["len"] == 6


def test_hymba_decode_matches_prefill(models, rng):
    """Decoding a prompt token by token (the SSM's one-step update and
    decode attention) ends on the prefill step's last-position logits
    (the scan and full attention): hymba's decode is its prefill."""
    m, _, tm, tp = models["hymba-1.5b"]
    toks = rng.integers(0, m.vocab, size=(2, 30)).astype(np.int64)
    states = TMB.init_decode_state(tp, tm, 2, 64)
    h = states[1][0]["ssm"][0]
    assert h.shape == (tm.segments[1].repeats, 2, 128, 8)
    for pos in range(30):
        logits, states = TMB.decode_step(tp, tm, _t(toks[:, pos:pos + 1]),
                                         pos, states)
    assert states[1][0]["ssm"][0] is h and bool(h.abs().sum() > 0)
    want = TTS.make_prefill_step(tm)(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(logits[:, 0].numpy(), want.numpy(),
                               **MODEL_TOL)


def test_reused_hymba_lane_matches_fresh_engine(models):
    """A request decoded in a reused lane, on top of the previous
    occupant's SSM state (reset on admission) and KV (masked), emits a
    fresh engine's tokens; without the reset it would not."""
    _, _, tm, tp = models["hymba-1.5b"]
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, tm.vocab, size=12).tolist()
    p2 = rng.integers(0, tm.vocab, size=9).tolist()
    reused = _port(tm, tp, [p1, p2], 1)
    assert reused[1] == _port(tm, tp, [p2], 1)[0]
    assert reused[0] == _port(tm, tp, [p1], 1)[0]


def test_hymba_engine_resets_only_the_admitted_lane(models):
    _, _, tm, tp = models["hymba-1.5b"]
    eng = TS.Engine(tm, tp, 2, 64, device="cpu")
    for r in range(2):
        eng.submit(TS.Request(rid=r, prompt=[1, 2, 3], max_new=2))
    eng.step()
    h = eng.states[0][0]["ssm"][0]
    assert bool(h[:, 0].abs().sum() > 0) and bool(h[:, 1].abs().sum() > 0)
    lane1 = h[:, 1].clone()
    TS._reset_recurrent_lane(eng.states, eng._fresh_recurrent, tm, 0)
    assert bool((h[:, 0] == 0).all()) and torch.equal(h[:, 1], lane1)
    assert all(st["ssm"][1] is not None for seg in eng.states for st in seg)


def test_serve_main_serves_hymba_on_the_cpu(capsys):
    assert TS.main(["--arch", "hymba-1.5b", "--device", "cpu", "--requests",
                    "3", "--slots", "2", "--max-new", "4"]) == 0
    assert "arch=hymba-reduced requests=3/3" in capsys.readouterr().out


def test_hymba_params_round_trip(models):
    """Hymba's tree, the 0-d mix leaves stacked to (repeats,), carried
    to numpy and back, leaf for leaf."""
    _, jp, _, tp = models["hymba-1.5b"]
    back = convert.lm_params_to_numpy(tp)
    assert back["segments"][1][0]["mix_a"].shape == (
        TC.get_reduced("hymba-1.5b").segments[1].repeats,)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = convert.lm_params_to_numpy(convert.lm_params_from_numpy(back,
                                                                   "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
