"""The port's Algorithm 1 training against the reference package.

Both packages start from one state, carried across with
``repro_torch.convert`` or drawn by each from the same seed (the port's
``init_state`` gives the reference's weights bit for bit), and get the
same numpy data.  What is held, and how close:

- ``prng.split``, the one-key training noise and the encoded batches: bit
  for bit;
- ``init_state(seed)``: G's and D's weights and the rng carry, bit for
  bit;
- one ``make_train_step``: the gradients first (read from the first Adam
  moment, which after one step from zero moments is 0.1·g rounded once in
  both packages), then the metrics and the params, at the reference's own
  step tolerance (rtol 1e-4, atol 1e-5, as ``tests/test_fused_path.py``);
- ``train_gan`` from one state for 2 epochs x 2 batches: the loss
  histories within rtol 1e-3, the satisfied rates equal.

These two run both packages on the host oracle (the float64 numpy
``evaluate``, the same code in both).  Inside the reference's jitted step
XLA fuses its jnp oracle with the hard decode and rounds it differently
from the same oracle run alone, to which the port's torch oracle is
bit-identical; where a generated config's latency or power lands on its
objective, that flips the row's satisfied label (one row in 32 in about
40% of random 32-row dnnweaver batches).  The two oracle routes are held
to each other within the port below.

Also:

- the invariants of ``tests/test_algorithm1.py``, on the port.

Small sizes throughout (2 layers x 32, batch 32), on the CPU, where every
dense layer takes the plain versions of the kernels through
``FusedDense``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gan as JG
from repro.core import train as JT
from repro.core.encoding import ConfigDim as JDim, ConfigSpace as JSpace
from repro.dataset.generator import generate_dataset as j_generate
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro.design_models.im2col import Im2colModel as JIm2col
from repro_torch import convert as C
from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core import train as T
from repro_torch.core.dse_api import GANDSE
from repro_torch.core.encoding import ConfigDim, ConfigSpace
from repro_torch.dataset.generator import generate_dataset, generate_tasks
from repro_torch.design_models import DnnWeaverModel, Im2colModel
from repro_torch.design_models.base import DesignModel
from repro_torch.kernels import fused_dense as FD

STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
LAYERS, NEURONS, BATCH, LR = 2, 32, 32, 1e-3


# ---------------------------------------------------------------------------
# one state, both packages
# ---------------------------------------------------------------------------
def _cfgs(jm, tm, **kw):
    jcfg = JG.GANConfig(n_net=jm.net_space.n_dims, **kw).scaled(
        LAYERS, NEURONS, lr=LR, batch_size=BATCH)
    tcfg = G.GANConfig(n_net=tm.net_space.n_dims, **kw).scaled(
        LAYERS, NEURONS, lr=LR, batch_size=BATCH)
    return jcfg, tcfg


def _ref_state(jm, jcfg, seed=0):
    """The reference's own initial state (params, zero moments, rng)."""
    rng, g_rng, d_rng = jax.random.split(jax.random.PRNGKey(seed), 3)
    gp = JG.init_generator(g_rng, jcfg, jm.space)
    dp = JG.init_discriminator(d_rng, jcfg, jm.space)
    g_optim, d_optim, _ = JT.make_train_step(jm, jcfg)
    return JT.TrainState(gp, dp, g_optim.init(gp), d_optim.init(dp), rng)


def _ref_to_numpy(st) -> dict:
    def opt(o):
        return {"step": np.asarray(o.step), "mu": jax.tree.map(np.asarray, o.mu),
                "nu": jax.tree.map(np.asarray, o.nu)}
    return {"g_params": jax.tree.map(np.asarray, st.g_params),
            "d_params": jax.tree.map(np.asarray, st.d_params),
            "g_opt": opt(st.g_opt), "d_opt": opt(st.d_opt),
            "rng": np.asarray(st.rng)}


def _close_trees(jtree, ttree, rtol=STEP_RTOL, atol=STEP_ATOL, what=""):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        b = b.detach().cpu().numpy() if torch.is_tensor(b) else b
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")


@pytest.fixture(scope="module")
def dnnweaver_data():
    jm, tm = JDnnWeaver(), DnnWeaverModel()
    jds, tds = j_generate(jm, 128, seed=0), generate_dataset(tm, 128, seed=0)
    assert np.array_equal(jds.cfg_idx, tds.cfg_idx)
    return jm, tm, jds, tds


# ---------------------------------------------------------------------------
# PRNG, noise, encoding, losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_split_matches_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(key, n)).astype(np.int64)
    got = prng.split(torch.from_numpy(np.asarray(key).astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_of_a_key_batch_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    got = prng.split(torch.from_numpy(np.asarray(keys).astype(np.int64)), 3)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("batch,noise_dim", [(32, 8), (37, 8), (1, 3),
                                             (1024, 8)])
def test_training_noise_matches_reference(batch, noise_dim):
    """One key for the whole (batch, noise_dim) draw, bit for bit."""
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    want = np.asarray(JG.sample_noise(
        key, batch, JG.GANConfig(n_net=6, noise_dim=noise_dim)))
    got = G.sample_train_noise(
        torch.from_numpy(np.asarray(key).astype(np.int64)), batch,
        G.GANConfig(n_net=6, noise_dim=noise_dim)).numpy()
    assert got.shape == (batch, noise_dim)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_encode_batch_matches_reference(dnnweaver_data):
    jm, tm, jds, tds = dnnweaver_data
    idx = np.arange(5, 45)
    want = JT.encode_batch(jm, jds, idx)
    got = T.encode_batch(tm, tds, idx)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_losses_match_reference(rng):
    model, jmodel = Im2colModel(), JIm2col()
    b = 23
    logits = rng.normal(size=(b, model.space.onehot_width)).astype(np.float32)
    probs = np.array(jax.nn.softmax(logits, axis=-1))
    target = model.space.onehot_from_indices(
        model.space.sample_indices(rng, b)).astype(np.float32)
    want = np.asarray(JG.grouped_cross_entropy(jmodel.space, target, probs))
    got = G.grouped_cross_entropy(model.space, torch.from_numpy(target),
                                  torch.from_numpy(probs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    sat_logits = rng.normal(size=(b, 2)).astype(np.float32) * 3
    sat = (rng.random(b) < 0.5).astype(np.float32)
    want = np.asarray(JG.satisfaction_ce(sat_logits, sat))
    got = G.satisfaction_ce(torch.from_numpy(sat_logits),
                            torch.from_numpy(sat)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_decode_hard_ties_go_to_the_first_index():
    space = ConfigSpace(dims=(ConfigDim("a", (1., 2., 3.)),
                              ConfigDim("b", (1., 2.))))
    jspace = JSpace(dims=(JDim("a", (1., 2., 3.)), JDim("b", (1., 2.))))
    probs = np.array([[0.4, 0.4, 0.2, 0.5, 0.5],
                      [0.2, 0.4, 0.4, 0.3, 0.7]], np.float32)
    want = np.asarray(JG.decode_hard(jspace, probs))
    got = G.decode_hard(space, torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 0], [1, 1]])


# ---------------------------------------------------------------------------
# state conversion
# ---------------------------------------------------------------------------
def test_train_state_round_trips_bit_for_bit(dnnweaver_data):
    """Reference TrainState -> port -> numpy: every leaf equal, with its
    dtype (float32 leaves, int32 step, uint32 key).  Taken after one step,
    so the moments are not zero."""
    jm, tm, jds, _ = dnnweaver_data
    jcfg, _ = _cfgs(jm, tm)
    st = JT.train_gan(jm, jds, jcfg, iters=1, seed=0,
                      state=_ref_state(jm, jcfg))
    tree = _ref_to_numpy(st)
    back = C.train_state_to_numpy(C.train_state_from_numpy(tree, "cpu"))
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(back["g_opt"]["step"]) == 4      # 128 rows in batches of 32


# ---------------------------------------------------------------------------
# one Algorithm 1 step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("models", [(JDnnWeaver, DnnWeaverModel),
                                    (JIm2col, Im2colModel)],
                         ids=["dnnweaver", "im2col"])
def test_one_step_matches_reference(models):
    rng = np.random.default_rng(12)
    jm, tm = models[0](), models[1]()
    jcfg, tcfg = _cfgs(jm, tm)
    jds, tds = j_generate(jm, 64, seed=0), generate_dataset(tm, 64, seed=0)
    jst = _ref_state(jm, jcfg)
    tst = C.train_state_from_numpy(_ref_to_numpy(jst), "cpu")
    idx = rng.permutation(64)[:BATCH]
    jbatch = {k: jnp.asarray(v) for k, v in
              JT.encode_batch(jm, jds, idx).items()}
    tbatch = {k: torch.from_numpy(v) for k, v in
              T.encode_batch(tm, tds, idx).items()}
    tbatch["net_idx"] = tbatch["net_idx"].long()
    *jout, jmet = JT.make_train_step(jm, jcfg, use_jax_oracle=False)[2](
        jst.g_params, jst.d_params, jst.g_opt, jst.d_opt, jbatch, jst.rng)
    *tout, tmet = T.make_train_step(tm, tcfg, use_torch_oracle=False)[2](
        tst.g_params, tst.d_params, tst.g_opt, tst.d_opt, tbatch, tst.rng)
    # gradients first: mu = 0.1·g after one step from zero moments
    for j_opt, t_opt, name in ((jout[2], tout[2], "G"),
                               (jout[3], tout[3], "D")):
        scale = max(float(np.abs(np.asarray(l)).max())
                    for l in jax.tree.leaves(j_opt.mu))
        _close_trees(j_opt.mu, t_opt.mu, atol=STEP_ATOL * scale,
                     what=f"{name} gradient")
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)
    _close_trees(jout[0], tout[0], what="G params")
    _close_trees(jout[1], tout[1], what="D params")
    np.testing.assert_array_equal(tout[4].numpy(),
                                  np.asarray(jout[4]).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("models", [(JDnnWeaver, DnnWeaverModel),
                                    (JIm2col, Im2colModel)],
                         ids=["dnnweaver", "im2col"])
def test_init_state_matches_reference_init(models, seed):
    """``init_state(seed)`` draws G from split(PRNGKey(seed), 3)[1] and D
    from [2] as the reference does: every weight leaf, the biases, zero
    moments and the rng carry [0] bit for bit."""
    from test_torch_prng import assert_normal_bits
    jm, tm = models[0](), models[1]()
    jcfg, tcfg = _cfgs(jm, tm)
    want = _ref_to_numpy(_ref_state(jm, jcfg, seed))
    got = C.train_state_to_numpy(T.init_state(tm, tcfg, seed, "cpu"))
    for name in ("g_params", "d_params"):
        for jl, tl in zip(want[name]["layers"], got[name]["layers"]):
            assert_normal_bits(tl["w"], jl["w"])
            np.testing.assert_array_equal(tl["b"], jl["b"])
            assert tl["w"].shape == jl["w"].shape
    del want["g_params"], want["d_params"], got["g_params"], got["d_params"]
    flat_w, tdef_w = jax.tree.flatten(want)
    flat_g, tdef_g = jax.tree.flatten(got)
    assert tdef_w == tdef_g
    for a, b in zip(flat_w, flat_g):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b.reshape(-1).view(np.uint8),
                                      a.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("models", [(JDnnWeaver, DnnWeaverModel),
                                    (JIm2col, Im2colModel)],
                         ids=["dnnweaver", "im2col"])
def test_one_step_from_init_state_matches_reference(models):
    """Each package from its own initial state for seed 0 (no weights
    carried across): one Algorithm 1 step on the host oracle, held as
    `test_one_step_matches_reference` holds it."""
    rng = np.random.default_rng(12)
    jm, tm = models[0](), models[1]()
    jcfg, tcfg = _cfgs(jm, tm)
    jds, tds = j_generate(jm, 64, seed=0), generate_dataset(tm, 64, seed=0)
    jst, tst = _ref_state(jm, jcfg), T.init_state(tm, tcfg, 0, "cpu")
    idx = rng.permutation(64)[:BATCH]
    jbatch = {k: jnp.asarray(v) for k, v in
              JT.encode_batch(jm, jds, idx).items()}
    tbatch = {k: torch.from_numpy(v) for k, v in
              T.encode_batch(tm, tds, idx).items()}
    tbatch["net_idx"] = tbatch["net_idx"].long()
    *jout, jmet = JT.make_train_step(jm, jcfg, use_jax_oracle=False)[2](
        jst.g_params, jst.d_params, jst.g_opt, jst.d_opt, jbatch, jst.rng)
    *tout, tmet = T.make_train_step(tm, tcfg, use_torch_oracle=False)[2](
        tst.g_params, tst.d_params, tst.g_opt, tst.d_opt, tbatch, tst.rng)
    for j_opt, t_opt, name in ((jout[2], tout[2], "G"),
                               (jout[3], tout[3], "D")):
        scale = max(float(np.abs(np.asarray(l)).max())
                    for l in jax.tree.leaves(j_opt.mu))
        _close_trees(j_opt.mu, t_opt.mu, atol=STEP_ATOL * scale,
                     what=f"{name} gradient")
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)
    _close_trees(jout[0], tout[0], what="G params")
    _close_trees(jout[1], tout[1], what="D params")
    np.testing.assert_array_equal(tout[4].numpy(),
                                  np.asarray(jout[4]).astype(np.int64))


def test_train_gan_from_one_state_matches_reference_history(dnnweaver_data):
    """2 epochs x 2 batches, warm-started from one converted state in both
    packages (the epoch permutations come from the same numpy seed)."""
    jm, tm, _, _ = dnnweaver_data
    jds, tds = j_generate(jm, 64, seed=1), generate_dataset(tm, 64, seed=1)
    jcfg, tcfg = _cfgs(jm, tm)
    jst = _ref_state(jm, jcfg, seed=3)
    tst = C.train_state_from_numpy(_ref_to_numpy(jst), "cpu")
    ja = JT.train_gan(jm, jds, jcfg, iters=2, seed=5, state=jst,
                      use_jax_oracle=False)
    ta = T.train_gan(tm, tds, tcfg, iters=2, seed=5, state=tst, device="cpu",
                     use_torch_oracle=False)
    assert len(ta.history) == len(ja.history) == 4
    for jr, tr in zip(ja.history, ta.history):
        assert tr["iter"] == jr["iter"]
        assert tr["sat_rate"] == jr["sat_rate"]
        for k in ("loss_g", "loss_d", "loss_config", "loss_critic"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(ta.rng.numpy(),
                                  np.asarray(ja.rng).astype(np.int64))
    assert int(ta.g_opt.step) == int(ja.g_opt.step) == 4


def test_train_gan_cold_start_keeps_the_reference_rng(dnnweaver_data):
    """From a seed the rng carry is split(PRNGKey(seed), 3)[0] advanced
    once per step, as the reference's."""
    jm, tm, jds, tds = dnnweaver_data
    jcfg, tcfg = _cfgs(jm, tm)
    ja = JT.train_gan(jm, jds, jcfg, iters=1, seed=4)
    ta = T.train_gan(tm, tds, tcfg, iters=1, seed=4, device="cpu")
    np.testing.assert_array_equal(ta.rng.numpy(),
                                  np.asarray(ja.rng).astype(np.int64))
    assert len(ta.history) == 4
    assert all(np.isfinite(r[k]) for r in ta.history for k in r)


# ---------------------------------------------------------------------------
# Algorithm 1's invariants (tests/test_algorithm1.py, on the port)
# ---------------------------------------------------------------------------
class ConstModel(DesignModel):
    """Design model whose satisfaction is globally constant (numpy only,
    so training takes the host-oracle route)."""

    name = "const"

    def __init__(self, always_satisfy: bool):
        self.always = always_satisfy
        self.space = ConfigSpace(dims=(ConfigDim("a", (1., 2., 4., 8.)),
                                       ConfigDim("b", (1., 2.))))
        self.net_space = ConfigSpace(dims=(ConfigDim("n", (1., 2.)),))

    def evaluate(self, net, config):
        b = np.broadcast_shapes(net[..., 0].shape, config[..., 0].shape)
        val = 0.5 if self.always else 2.0
        return np.full(b, val), np.full(b, val)


def _const_setup(always: bool):
    model = ConstModel(always)
    cfg = G.GANConfig(n_net=1, w_critic=0.5).scaled(1, 16, lr=1e-3,
                                                     batch_size=32)
    ds = generate_dataset(model, 64, seed=0)
    ds.latency[:] = 1.0      # model returns 0.5 (always) or 2.0 (never)
    ds.power[:] = 1.0
    return model, cfg, ds


def test_all_satisfied_masks_config_loss():
    model, cfg, ds = _const_setup(True)
    st = T.train_gan(model, ds, cfg, iters=1, device="cpu")
    assert len(st.history) == 2
    for h in st.history:
        assert h["loss_config"] == pytest.approx(0.0, abs=1e-6)
        assert h["sat_rate"] == pytest.approx(1.0)
        assert h["loss_g"] == pytest.approx(0.5 * h["loss_critic"], rel=1e-6)


def test_none_satisfied_full_config_loss():
    model, cfg, ds = _const_setup(False)
    st = T.train_gan(model, ds, cfg, iters=1, device="cpu")
    for h in st.history:
        assert h["loss_config"] > 0.0
        assert h["sat_rate"] == pytest.approx(0.0)
    assert all(torch.isfinite(p).all() for p in
               [q for layer in st.g_params["layers"] for q in layer.values()])


def _const_batch(model, ds, n=16):
    b = {k: torch.from_numpy(v) for k, v in
         T.encode_batch(model, ds, np.arange(n)).items()}
    b["net_idx"] = b["net_idx"].long()
    return b


def test_d_update_leaves_g_bit_identical():
    """The D loss sees G's probs detached: its gradient w.r.t. G is absent,
    and a step's D half leaves G's params as G's own update left them."""
    model, cfg, ds = _const_setup(False)
    g_key, d_key = prng.split(prng.prng_key(torch.tensor(0)))
    gp = G.init_generator(g_key, cfg, model.space, "cpu")
    dp = G.init_discriminator(d_key, cfg, model.space, "cpu")
    batch = _const_batch(model, ds)
    noise = G.sample_train_noise(prng.prng_key(torch.tensor(0)), 16, cfg)
    leaves = [t.requires_grad_() for layer in gp["layers"]
              for t in layer.values()]
    probs = G.generator_apply(gp, model.space, batch["net_enc"],
                              batch["obj_enc"], noise).detach()
    d_leaves = [t.detach().requires_grad_() for layer in dp["layers"]
                for t in layer.values()]
    it = iter(d_leaves)
    d_live = {"layers": [{k: next(it) for k in layer}
                         for layer in dp["layers"]]}
    logits = G.discriminator_apply(d_live, batch["net_enc"], probs,
                                   batch["obj_enc"])
    loss = torch.mean(G.satisfaction_ce(logits, torch.zeros(16)))
    grads = torch.autograd.grad(loss, leaves + d_leaves, allow_unused=True)
    assert all(g is None for g in grads[:len(leaves)])
    assert all(g is not None for g in grads[len(leaves):])
    # the full step: G after the step equals G after its own update alone
    for t in leaves:
        t.requires_grad_(False)
    g_optim, d_optim, step = T.make_train_step(model, cfg)
    go, do = g_optim.init(gp), d_optim.init(dp)
    rng = prng.prng_key(torch.tensor(1))
    g_new, d_new, *_ = step(gp, dp, go, do, batch, rng)
    frozen_d = dataclasses.replace(cfg, d_lr=0.0)
    g_alone, d_same, *_ = T.make_train_step(model, frozen_d)[2](
        gp, dp, go, do, batch, rng)
    for a, b in zip(g_new["layers"], g_alone["layers"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert any(not torch.equal(a["w"], b["w"])
               for a, b in zip(d_new["layers"], d_same["layers"]))


def test_critic_gradient_flows_through_frozen_d():
    """G's critic gradient is nonzero (it flows THROUGH D into G), and the
    frozen D collects none."""
    model, cfg, ds = _const_setup(False)
    g_key, d_key = prng.split(prng.prng_key(torch.tensor(0)))
    gp = G.init_generator(g_key, cfg, model.space, "cpu")
    dp = G.init_discriminator(d_key, cfg, model.space, "cpu")
    batch = _const_batch(model, ds)
    noise = G.sample_train_noise(prng.prng_key(torch.tensor(0)), 16, cfg)
    leaves = [t.requires_grad_() for layer in gp["layers"]
              for t in layer.values()]
    probs = G.generator_apply(gp, model.space, batch["net_enc"],
                              batch["obj_enc"], noise)
    frozen = {"layers": [{k: v.detach() for k, v in layer.items()}
                         for layer in dp["layers"]]}
    logits = G.discriminator_apply(frozen, batch["net_enc"], probs,
                                   batch["obj_enc"])
    loss = torch.mean(G.satisfaction_ce(logits, torch.ones(16)))
    grads = torch.autograd.grad(loss, leaves)
    assert sum(float(g.abs().sum()) for g in grads) > 0.0
    assert all(t.grad is None for layer in dp["layers"]
               for t in layer.values())


def test_step_runs_every_layer_through_the_dense_kernels(dnnweaver_data,
                                                         monkeypatch):
    """One step calls each dense wrapper as often as the card launches its
    kernel: forward 3(L+1) (G, D in G's loss, D in D's loss), dx
    L + (L+1) + L (G's first layer and D's first layer in D's loss need
    none), dW/db 2(L+1)."""
    jm, tm, _, tds = dnnweaver_data
    _, tcfg = _cfgs(jm, tm)
    calls = {"dense_forward": 0, "dense_dx": 0, "dense_dw_db": 0}
    for name in calls:
        orig = getattr(FD, name)

        def spy(*a, _o=orig, _n=name):
            calls[_n] += 1
            return _o(*a)
        monkeypatch.setattr(FD, name, spy)
    st = C.train_state_from_numpy(
        _ref_to_numpy(_ref_state(jm, _cfgs(jm, tm)[0])), "cpu")
    T.make_train_step(tm, tcfg)[2](
        st.g_params, st.d_params, st.g_opt, st.d_opt,
        _const_batch(tm, tds, BATCH), st.rng)
    n = LAYERS + 1
    assert calls == {"dense_forward": 3 * n,
                     "dense_dx": LAYERS + n + LAYERS,
                     "dense_dw_db": 2 * n}
    # the explicit opt-out takes the plain versions, not the wrappers
    calls.update(dense_forward=0, dense_dx=0, dense_dw_db=0)
    T.make_train_step(tm, dataclasses.replace(tcfg, use_fused=False))[2](
        st.g_params, st.d_params, st.g_opt, st.d_opt,
        _const_batch(tm, tds, BATCH), st.rng)
    assert calls == {"dense_forward": 0, "dense_dx": 0, "dense_dw_db": 0}


def test_host_oracle_route_matches_torch_oracle_route(dnnweaver_data):
    """The oracle switch changes the execution route, not the math."""
    _, tm, _, tds = dnnweaver_data
    cfg = G.GANConfig(n_net=tm.net_space.n_dims).scaled(1, 16, lr=1e-3,
                                                         batch_size=64)
    a = T.train_gan(tm, tds, cfg, iters=1, seed=0, use_torch_oracle=True,
                    device="cpu")
    b = T.train_gan(tm, tds, cfg, iters=1, seed=0, use_torch_oracle=False,
                    device="cpu")
    assert len(a.history) == len(b.history) == 2
    for ra, rb in zip(a.history, b.history):
        for k in ra:
            np.testing.assert_allclose(ra[k], rb[k], rtol=2e-3, atol=1e-4,
                                       err_msg=k)


class _BrokenModel(ConstModel):
    """Metrics NaN on half the configs and +inf on the rest."""

    def evaluate(self, net, config):
        b = np.broadcast_shapes(net[..., 0].shape, config[..., 0].shape)
        bad = np.broadcast_to(config[..., 0] > 2.0, b)
        return np.where(bad, np.nan, np.inf), np.where(bad, np.inf, np.nan)

    def evaluate_torch(self, net, config):
        lat, pw = self.evaluate(net.numpy(), config.numpy())
        return (torch.from_numpy(lat).float(), torch.from_numpy(pw).float())


@pytest.mark.parametrize("use_torch_oracle", [True, False])
def test_oracle_maps_nan_and_inf_to_infeasible(use_torch_oracle):
    oracle, on_device = T.make_oracle(_BrokenModel(True), use_torch_oracle)
    assert on_device == use_torch_oracle
    cfg_idx = torch.tensor([[0, 0], [3, 1], [2, 0]])
    net_idx = torch.zeros((3, 1), dtype=torch.int64)
    lat, pw = oracle(cfg_idx, net_idx)
    assert lat.dtype == pw.dtype == torch.float32
    big = np.float32(3.4e38)
    np.testing.assert_array_equal(lat.numpy(), [big] * 3)
    np.testing.assert_array_equal(pw.numpy(), [big] * 3)


def test_oracle_refuses_a_torch_route_the_model_lacks():
    with pytest.raises(ValueError, match="no torch oracle"):
        T.make_oracle(ConstModel(True), use_torch_oracle=True)
    assert T.make_oracle(ConstModel(True))[1] is False


def test_gandse_train_attaches_the_trained_generator():
    model = DnnWeaverModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims).scaled(1, 16, lr=1e-3,
                                                            batch_size=32)
    engine = GANDSE(model, cfg, device="cpu")
    assert engine.g_params is None and engine.state is None
    st = engine.train(n_data=64, iters=1, seed=0)
    assert st is engine.state and len(st.history) == 2
    for a, b in zip(engine.g_params["layers"], st.g_params["layers"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    res = engine.explore_batch(generate_tasks(model, 4, seed=1), seed=0)
    assert len(res) == 4
    assert all(r.selection.n_candidates >= 1 for r in res)
