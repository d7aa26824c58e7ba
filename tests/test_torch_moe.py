"""The port's MoE FFN (``nn/moe.py``) and the two MoE decoders
(mixtral-8x7b, phi3.5-moe) against the reference: routing, the capacity
dispatch's integers, the layer and its oracle, both reduced models'
forward, decode steps, the ``Engine``, loss and gradients, and train
steps.

Both packages get the same numpy inputs; the port computes from the
reference's own params (``convert``).  The dispatch's integers are held
exactly on the reference's own router logits, apart from the model-level
checks, because logits summed in another order can cross a top-k
boundary and move every later slot.  Tolerances: the layer within
1e-5·max(1, max|y|) and the aux loss within 1e-6 (float32 sums in
another order); whole models within rtol 1e-4, atol 2e-5 as the dense
ones (``test_torch_lm.py``), with every layer's routing equal; gradients
each leaf within 1e-4 of its norm; train steps as in
``test_torch_lm_train.py``.  The engine must emit the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ref as JR
from repro.launch import serve as JS
from repro.models import base as JMB
from repro.nn import moe as JM
from repro.train import step as JTS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.kernels import ref as TR
from repro_torch.launch import serve as TS
from repro_torch.models import base as TMB
from repro_torch.nn import moe as TM
from repro_torch.train import step as TTS

ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _key(seed: int) -> torch.Tensor:
    return prng.prng_key(torch.tensor(seed))


def _close(got, want, name, tol=1e-5):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err} > {tol * scale}"


@pytest.fixture(scope="module")
def layer():
    """A reference MoE layer (8 experts, D 32, F 48), its port copy, and
    256 tokens."""
    jp = JM.moe_init(jax.random.PRNGKey(3), 8, 32, 48)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(7).normal(size=(256, 32)).astype(np.float32)
    return jp, tp, x


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, its params, the port's cfg, converted
    params)."""
    out = {}
    for arch in ARCHS:
        m = JC.get_reduced(arch)
        jp = JMB.init_params(jax.random.PRNGKey(0), m)
        tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        out[arch] = (m, jp, TC.get_reduced(arch), tp)
    return out


class _Routes:
    """Records each MoE layer's expert indices in call order, in both
    packages (``route_topk`` patched where ``moe_apply`` looks it up)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        j_route, t_route = JM.route_topk, TM.route_topk

        def j_rec(logits, k):
            idx, w = j_route(logits, k)
            # inside the reference's scan and jit: a host callback
            jax.debug.callback(
                lambda a: self.ref.append(np.asarray(a).reshape(-1, k)), idx)
            return idx, w

        def t_rec(logits, k):
            idx, w = t_route(logits, k)
            self.port.append(idx.numpy().reshape(-1, k))
            return idx, w

        monkeypatch.setattr(JM, "route_topk", j_rec)
        monkeypatch.setattr(TM, "route_topk", t_rec)

    def assert_equal(self):
        assert len(self.ref) == len(self.port) > 0
        for i, (a, b) in enumerate(zip(self.ref, self.port)):
            np.testing.assert_array_equal(b, a, err_msg=f"layer call {i}")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_moe_init_has_the_reference_layout_and_scales():
    """The same key gives the reference's leaves, bit for bit."""
    jp = JM.moe_init(jax.random.PRNGKey(0), 8, 64, 96)
    tp = TM.moe_init(_key(0), 8, 64, 96, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_topk_matches_reference(k, rng):
    logits = rng.normal(size=(3, 40, 8)).astype(np.float32) * 2
    jidx, jw = JM.route_topk(jnp.asarray(logits), k)
    tidx, tw = TM.route_topk(_t(logits), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def test_route_topk_takes_the_lower_index_on_exact_ties():
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0],
                       [-1.0, 2.0, -0.0, 0.0, 2.0],
                       [5.0, 1.0, 5.0, 1.0, 1.0]], np.float32)
    for k in (1, 2, 3):
        jidx, jw = JM.route_topk(jnp.asarray(logits), k)
        tidx, tw = TM.route_topk(_t(logits), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert TM.route_topk(_t(logits), 2)[0].tolist() == \
        [[1, 2], [0, 1], [1, 4], [0, 2]]
    # the float32 total order: 0.0 above -0.0
    assert TM.route_topk(_t(logits), 3)[0][2].tolist() == [1, 4, 3]


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_dispatch_integers_equal_the_reference(cf, layer):
    """buf_tok, occupied, slot and keep on the reference's own logits:
    heavy drops, the default capacity, none dropped."""
    jp, _, x = layer
    t, e, k = x.shape[0], 8, 2
    cap = max(int(cf * k * t / e), 1)
    assert TM.capacity(t, e, k, cf) == cap
    logits = jnp.asarray(x) @ jp["router"]
    idx, w = JM.route_topk(logits, k)
    want = jax.jit(JM._dispatch_group, static_argnums=(3, 4))(
        jnp.asarray(x), idx, w, e, cap)
    got = TM._dispatch_group(_t(idx).long(), e, cap)
    for name, g, r in zip(("buf_tok", "occupied", "slot", "keep"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert got[0].shape == got[1].shape == (e * cap,)
    dropped = int((~got[3]).sum())
    if cf == 0.25:
        assert dropped > 0
    if cf == 8.0:
        assert dropped == 0


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_moe_apply_matches_reference(cf, layer):
    jp, tp, x = layer
    want, want_aux = jax.jit(lambda p, xx: JM.moe_apply(
        p, xx, top_k=2, capacity_factor=cf, aux_loss=True))(jp, jnp.asarray(x))
    got, aux = TM.moe_apply(tp, _t(x), top_k=2, capacity_factor=cf,
                            aux_loss=True)
    _close(got.numpy(), want, f"moe_apply cf={cf}")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-6)
    assert torch.equal(TM.moe_apply(tp, _t(x), top_k=2,
                                    capacity_factor=cf), got)


def test_dense_gather_oracle_matches_reference(layer):
    jp, tp, x = layer
    logits = x @ np.asarray(jp["router"])
    idx, w = JM.route_topk(jnp.asarray(logits), 2)
    want = JR.moe_dispatch_ffn(jnp.asarray(x), jp["w_gate"], jp["w_up"],
                               jp["w_down"], idx, w)
    got = TR.moe_dispatch_ffn(_t(x), tp["w_gate"], tp["w_up"], tp["w_down"],
                              _t(idx).long(), _t(w))
    _close(got.numpy(), want, "moe_dispatch_ffn")


def test_moe_with_drops_is_the_oracle_on_its_kept_assignments(layer):
    """At the default capacity the layer is the dense-gather oracle with
    the dropped assignments' weights zeroed."""
    _, tp, x = layer
    xt = _t(x)
    t, e = x.shape[0], 8
    cap = TM.capacity(t, e, 2, 0.5)
    idx, w = TM.route_topk(xt @ tp["router"], 2)
    keep = TM._dispatch_group(idx, e, cap)[3].reshape(t, 2)
    assert not bool(keep.all())
    want = TR.moe_dispatch_ffn(xt, tp["w_gate"], tp["w_up"], tp["w_down"],
                               idx, w * keep)
    _close(TM.moe_apply(tp, xt, top_k=2, capacity_factor=0.5).numpy(),
           want.numpy(), "moe_apply with drops")


# the reference's three MoE tests (tests/test_substrate.py), on the port
def test_moe_matches_dense_oracle_when_capacity_sufficient(rng):
    x = _t(rng.normal(size=(32, 16)).astype(np.float32))
    p = TM.moe_init(_key(0), 4, 16, 32, "cpu")
    idx, w = TM.route_topk(x @ p["router"], 2)
    got = TM.moe_apply(p, x, top_k=2, capacity_factor=8.0)
    want = TR.moe_dispatch_ffn(x, p["w_gate"], p["w_up"], p["w_down"], idx, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_moe_capacity_drops_are_partial_not_nan(rng):
    x = _t(rng.normal(size=(64, 16)).astype(np.float32))
    p = TM.moe_init(_key(1), 4, 16, 32, "cpu")
    y = TM.moe_apply(p, x, top_k=2, capacity_factor=0.25)
    assert not bool(torch.isnan(y).any())


def test_moe_aux_loss_bounds(rng):
    x = _t(rng.normal(size=(128, 16)).astype(np.float32))
    p = TM.moe_init(_key(2), 8, 16, 32, "cpu")
    _, aux = TM.moe_apply(p, x, top_k=2, aux_loss=True)
    assert float(aux) >= 1.0 - 1e-3


# ---------------------------------------------------------------------------
# the layer's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_gradient_matches_reference(cf, layer):
    jp, tp, x = layer
    gy = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(JM.moe_apply(p, xx, top_k=2, capacity_factor=cf)
                       * jnp.asarray(gy))

    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = _t(x).requires_grad_(True)
    y = TM.moe_apply(live, xt, top_k=2, capacity_factor=cf)
    grads = torch.autograd.grad(y, [xt, *live.values()], _t(gy))
    _close(grads[0].numpy(), jgx, "dx")
    for name, got in zip(live, grads[1:]):
        _close(got.numpy(), jg[name], f"d{name}", tol=1e-4)


def test_moe_gradient_is_the_same_twice(rng):
    """No gradient of the layer is summed by atomic adds: two backward
    passes give the same bits (8192 tokens, drops included)."""
    p = TM.moe_init(_key(4), 8, 64, 96, "cpu")
    x = _t(rng.normal(size=(8192, 64)).astype(np.float32))
    gy = _t(rng.normal(size=(8192, 64)).astype(np.float32))
    live = {k: v.requires_grad_(True) for k, v in p.items()}
    xt = x.requires_grad_(True)

    def grads():
        y = TM.moe_apply(live, xt, top_k=2)
        return torch.autograd.grad(y, [xt, *live.values()], gy)

    first = grads()
    for a, b in zip(first, grads()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, s, models, monkeypatch):
    """Both reduced MoE archs at S 64 and 256 (mixtral's window 32 bands
    both), every layer's routing equal."""
    m, jp, tm, tp = models[arch]
    toks = np.random.default_rng(s).integers(0, m.vocab, size=(2, s))
    routes = _Routes(monkeypatch)
    want = np.asarray(JMB.forward(jp, m, jnp.asarray(toks, jnp.int32)))
    got = TMB.forward(tp, tm, _t(toks).long())
    assert got.shape == (2, s, m.vocab)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    assert len(routes.port) == tm.n_layers
    routes.assert_equal()


def test_decode_steps_match_reference(models, monkeypatch):
    """40 decode steps of reduced mixtral (its 32-slot rings wrap) with a
    per-lane start: each step routes its 2 lanes at a capacity of 1."""
    m, jp, tm, tp = models["mixtral-8x7b"]
    b, cache_len = 2, 48
    jstates = JMB.init_decode_state(jp, m, b, cache_len)
    tstates = TMB.init_decode_state(tp, tm, b, cache_len)
    jdec = jax.jit(JTS.make_decode_step(m))
    tdec = TTS.make_decode_step(tm)
    start = np.array([0, 5], np.int32)
    rng = np.random.default_rng(5)
    routes = _Routes(monkeypatch)
    for pos in range(40):
        tok = rng.integers(0, m.vocab, size=(b, 1)).astype(np.int32)
        jl, jstates = jdec(jp, jnp.asarray(tok), jnp.int32(pos), jstates,
                           start=jnp.asarray(start))
        tl, tstates = tdec(tp, _t(tok).long(), pos, tstates,
                           start=_t(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert len(routes.port) == 40 * tm.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_the_reference_tokens(arch, models):
    """Five requests through two slots (three reuse a lane)."""
    m, jp, tm, tp = models[arch]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, m.vocab, size=n).tolist()
               for n in (12, 7, 9, 12, 5)]

    def serve(mod, mm, params, **kw):
        eng = mod.Engine(mm, params, 2, 64, **kw)
        for r, p in enumerate(prompts):
            eng.submit(mod.Request(rid=r, prompt=list(p), max_new=6))
        eng.run(max_iters=512)
        assert len(eng.finished) == len(prompts)
        return {r.rid: r.out for r in eng.finished}

    assert serve(TS, tm, tp, device="cpu") == serve(JS, m, jp)


def test_decode_is_not_prefill_with_the_reference_capacity(models,
                                                          monkeypatch):
    """The reference's quirk, copied: a decode step sizes the capacity for
    its lanes (4 lanes, 4 experts, top 2: one slot an expert), so 12
    decode steps end far from the prefill step's logits, in both packages
    alike; with a capacity that drops nothing they agree."""
    m, jp, tm, tp = models["mixtral-8x7b"]
    toks = np.random.default_rng(0).integers(0, m.vocab, size=(4, 12))

    def port_decode():
        states = TMB.init_decode_state(tp, tm, 4, 32)
        for pos in range(12):
            logits, states = TMB.decode_step(tp, tm, _t(toks[:, pos:pos + 1]),
                                             pos, states)
        return logits[:, 0].numpy()

    jstates = JMB.init_decode_state(jp, m, 4, 32)
    jdec = jax.jit(JTS.make_decode_step(m))
    for pos in range(12):
        jl, jstates = jdec(jp, jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                           jnp.int32(pos), jstates)
    j_dec = np.asarray(jl[:, 0])
    j_pre = np.asarray(JTS.make_prefill_step(m)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}))
    t_pre = TTS.make_prefill_step(tm)(tp, {"tokens": _t(toks).long()}).numpy()
    t_dec = port_decode()
    np.testing.assert_allclose(t_dec, j_dec, **MODEL_TOL)
    np.testing.assert_allclose(t_pre, j_pre, **MODEL_TOL)
    scale = float(np.abs(j_pre).max())
    assert np.abs(j_dec - j_pre).max() > 0.1 * scale
    assert np.abs(t_dec - t_pre).max() > 0.1 * scale
    monkeypatch.setattr(TM, "capacity", lambda t, e, k, cf: t)
    np.testing.assert_allclose(
        port_decode(),
        TTS.make_prefill_step(tm)(tp, {"tokens": _t(toks).long()}).numpy(),
        **MODEL_TOL)


class _HostMesh:
    """The port's view of a one-device host mesh, (data=1, model=1)."""
    shape = {"data": 1, "model": 1}


def test_e_par_combine_under_the_host_mesh_spreads_nan_as_the_reference():
    """Under the one-device host mesh both packages take the
    expert-parallel combine (a size-1 'model' axis divides E): on finite
    tokens the port's is the plain combine's bits, forward and gradient,
    and with token 0 non-finite 1 row is NaN without the mesh and 52 of
    256 under it, in both packages (moe_init(key 0, 8, 64, 128), x from
    key 1, top 2)."""
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.train import shardings as JSH
    from repro_torch.train import shardings as TSH

    jp = JM.moe_init(jax.random.PRNGKey(0), 8, 64, 128)
    tp = {k: _t(v) for k, v in jp.items()}
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (256, 64)))
    # one jit a context: the mesh is read at trace time
    j_apply = jax.jit(lambda p, a: JM.moe_apply(p, a, top_k=2))
    j_apply_mesh = jax.jit(lambda p, a: JM.moe_apply(p, a, top_k=2))

    def port(x, mesh, grad=False):
        live = {k: v.clone().requires_grad_(grad) for k, v in tp.items()}
        with TSH.use_mesh(mesh):
            y = TM.moe_apply(live, _t(x), top_k=2)
        if not grad:
            return y.detach().numpy()
        g = torch.autograd.grad((y * y).sum(), list(live.values()))
        return [t.numpy() for t in g]

    assert TM._e_par(8) is False
    with TSH.use_mesh(_HostMesh()):
        assert TM._e_par(8) and TM._num_groups(256) == 1
    np.testing.assert_array_equal(port(x0, _HostMesh()), port(x0, None))
    for a, b in zip(port(x0, _HostMesh(), True), port(x0, None, True)):
        np.testing.assert_array_equal(a, b)
    bad = x0.copy()
    bad[0] = np.inf
    j_plain = np.asarray(j_apply(jp, jnp.asarray(bad)))
    with JSH.use_mesh(j_host_mesh()):
        j_mesh = np.asarray(j_apply_mesh(jp, jnp.asarray(bad)))
    nan_rows = lambda y: int(np.isnan(y).any(axis=1).sum())
    assert nan_rows(j_plain) == nan_rows(port(bad, None)) == 1
    assert nan_rows(j_mesh) == nan_rows(port(bad, _HostMesh())) == 52
    np.testing.assert_array_equal(np.isnan(port(bad, _HostMesh())),
                                  np.isnan(j_mesh))
    np.testing.assert_allclose(np.nan_to_num(port(bad, _HostMesh())),
                               np.nan_to_num(j_mesh), **MODEL_TOL)


def test_train_launcher_runs_under_the_host_mesh_as_the_reference(tmp_path):
    """``launch/train --arch mixtral-8x7b`` builds ``make_host_mesh()`` in
    both packages, so both take the e_par combine: the port's losses are
    the reference's over 4 steps on the reduced config."""
    import json

    from repro.launch import train as JLT
    from repro_torch.launch import train as TLT

    base = ["--arch", "mixtral-8x7b", "--batch", "4", "--seq", "32",
            "--steps", "4", "--log-every", "1"]
    h_ref, h_port = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    calls = []
    e_par = TM._e_par

    def spy(e):
        calls.append(e_par(e))
        return calls[-1]

    JLT.main(base + ["--ckpt-dir", str(tmp_path / "r"),
                     "--history-out", h_ref])
    TM._e_par, saved = spy, TM._e_par
    try:
        TLT.main(base + ["--ckpt-dir", str(tmp_path / "p"), "--history-out",
                         h_port, "--device", "cpu"])
    finally:
        TM._e_par = saved
    assert calls and all(calls)
    with open(h_ref) as f:
        want = [r["loss"] for r in json.load(f)]
    with open(h_port) as f:
        got = [r["loss"] for r in json.load(f)]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _batch(vocab, b, s, step=0):
    from repro.data import synthetic as JD
    toks, labels = JD.SyntheticStream(JD.DataConfig(
        vocab=vocab, seq_len=s, global_batch=b, seed=0)).batch(step)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": _t(toks).long(), "labels": _t(labels).long()})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, models):
    m, jp, tm, tp = models[arch]
    jb, tb = _batch(m.vocab, 2, 128)

    def loss_fn(p):
        return JTS.next_token_loss(JMB.forward(p, m, jb["tokens"]),
                                   jb["labels"])

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(jp)
    loss, grads = TTS.loss_and_grads(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = jax.tree.leaves(convert.lm_params_to_numpy(grads))
    want = jax.tree.leaves(want_g)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b, np.float64)
        err = np.linalg.norm(a.astype(np.float64) - b)
        assert err <= 1e-4 * max(np.linalg.norm(b), 1e-30), (arch, i, err)


def test_two_train_steps_match_reference(models):
    m, jp, tm, tp = models["mixtral-8x7b"]
    pairs = [_batch(m.vocab, 2, 64, step=i) for i in range(2)]
    jstep, joptim = JTS.make_train_step(m, remat=False, lr=3e-4)
    jstep = jax.jit(jstep)
    jopt, jparams, want_l = joptim.init(jp), jp, []
    for jb, _ in pairs:
        jparams, jopt, met = jstep(jparams, jopt, jb)
        want_l.append(float(met["loss"]))
    tstep, toptim = TTS.make_train_step(tm, remat=False, lr=3e-4)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu")
    topt, got_l = toptim.init(tparams), []
    for _, tb in pairs:
        tparams, topt, met = tstep(tparams, topt, tb)
        got_l.append(float(met["loss"]))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(tparams)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)
