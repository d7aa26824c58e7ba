"""The port's baselines against the reference package (Table 5's four
other methods), on the CPU at small sizes (1 x 32 nets, 4-16 tasks), each
case fed the same numpy inputs in both packages.

Tolerances:

- Selections, RandomSearch's and SA's lanes (best config, evaluations),
  and initial weights: exact.
- LargeMLP's probs from the same params and seeds: atol 1e-6
  (``PROBS_ATOL``: float32 sums in another order; the reference runs a
  vmapped per-task forward, the port one row batch); its Selections from
  those probs: exact.
- One training step (LargeMLP, DRL): loss and new params rtol 1e-4, atol
  1e-5, gradients atol 1e-5 of the largest (the step tolerance of
  ``tests/test_torch_train.py``).

One lane is allowed to differ, named in
``test_sa_lanes_of_table5_match_reference``: lane 105 of Table 5's
dnnweaver tasks, where XLA, fusing the reference's jnp oracle into its
jitted anneal, rounds a config's float32 power 2 ulps above the same
oracle run alone (which the port's torch oracle equals), across the
objective.  SA's accept test also runs torch's float32 ``exp`` where the
reference runs XLA's (an ulp apart at some arguments), which could
change an accept only where the uniform draw falls inside that ulp; no
tested lane meets one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines.drl import PolicyGradientDRL as JDRL
from repro.baselines.mlp import LargeMLP as JMLP
from repro.baselines.mlp import _cached_fwd as j_mlp_fwd
from repro.baselines.random_search import RandomSearch as JRS
from repro.baselines.sa import SimulatedAnnealing as JSA
from repro.core import gan as JG
from repro.core.explorer import ExplorerConfig as JXCfg
from repro.core.train import encode_batch as j_encode
from repro.dataset.generator import generate_dataset as j_generate
from repro.dataset.generator import generate_tasks as j_tasks
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro.design_models.im2col import Im2colModel as JIm2col
from repro_torch.baselines import (LargeMLP, PolicyGradientDRL, RandomSearch,
                                   SimulatedAnnealing)
from repro_torch.baselines.sa import _temperatures
from repro_torch.convert import g_params_from_numpy
from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core import train as T
from repro_torch.core.dse_api import GANDSE, DSEMethod
from repro_torch.core.explorer import ExplorerConfig
from repro_torch.dataset.generator import generate_dataset, generate_tasks
from repro_torch.design_models import DnnWeaverModel, Im2colModel
from repro_torch.design_models.base import DesignModel

PROBS_ATOL = 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
BASELINES = (LargeMLP, PolicyGradientDRL, SimulatedAnnealing, RandomSearch)


class _TInfeasible(DnnWeaverModel):
    """Every config infeasible: the zero-feasible edge case."""

    name = "dnnweaver_infeasible"

    def evaluate(self, net, config):
        lat, pw = super().evaluate(net, config)
        return np.full_like(lat, np.inf), np.full_like(pw, np.inf)

    def evaluate_torch(self, net, config):
        lat, pw = super().evaluate_torch(net, config)
        return torch.full_like(lat, np.inf), torch.full_like(pw, np.inf)


class _THostOnly(DnnWeaverModel):
    """Torch oracle hidden: the sequential host fallback."""

    name = "dnnweaver_host_only"
    evaluate_torch = DesignModel.evaluate_torch


class _JInfeasible(JDnnWeaver):
    name = "dnnweaver_infeasible"

    def evaluate(self, net, config):
        lat, pw = super().evaluate(net, config)
        return np.full_like(lat, np.inf), np.full_like(pw, np.inf)

    def evaluate_jax(self, net, config):
        lat, pw = super().evaluate_jax(net, config)
        return jnp.full_like(lat, jnp.inf), jnp.full_like(pw, jnp.inf)


def _same(a, b):
    if (a.cfg_idx is None) != (b.cfg_idx is None):
        return False
    if a.cfg_idx is not None and not np.array_equal(a.cfg_idx, b.cfg_idx):
        return False
    return (a.latency, a.power, a.satisfied, a.n_candidates) == \
        (b.latency, b.power, b.satisfied, b.n_candidates)


def _assert_all_same(got, want):
    assert len(got) == len(want)
    for t, (a, b) in enumerate(zip(got, want)):
        assert _same(a.selection, b.selection), (t, a.selection, b.selection)


def _to_torch(params):
    return g_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def data():
    jm, tm = JDnnWeaver(), DnnWeaverModel()
    jds, tds = j_generate(jm, 256, seed=0), generate_dataset(tm, 256, seed=0)
    jt, tt = j_tasks(jm, 4, seed=2), generate_tasks(tm, 4, seed=2)
    np.testing.assert_array_equal(jt.net_idx, tt.net_idx)
    return jm, tm, jds, tds, tt


@pytest.fixture(scope="module")
def mlps(data):
    """A 1 x 32 LargeMLP trained one epoch in the reference, and the
    port's with the reference's params attached."""
    jm, tm, jds, tds, _ = data
    xj = JXCfg(prob_threshold=0.1, max_candidates=128)
    xt = ExplorerConfig(prob_threshold=0.1, max_candidates=128)
    j = JMLP(jm, hidden_layers=1, neurons=32, explorer_cfg=xj)
    j.train(n_data=0, iters=1, seed=0, ds=jds)
    t = LargeMLP(tm, hidden_layers=1, neurons=32, explorer_cfg=xt,
                 device="cpu").attach(tds, _to_torch(j.params))
    return j, t


@pytest.fixture(scope="module")
def drls(data):
    jm, tm, jds, tds, _ = data
    j = JDRL(jm, hidden_layers=1, neurons=32, rollout_len=8, batch_tasks=16)
    j.train(n_data=0, iters=2, seed=0, ds=jds)
    t = PolicyGradientDRL(tm, hidden_layers=1, neurons=32, rollout_len=8,
                          batch_tasks=16, device="cpu")
    return j, t.attach(tds, _to_torch(j.params))


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------
def test_all_methods_speak_the_protocol(data):
    tm = data[1]
    methods = [GANDSE(tm, device="cpu")] + [cls(tm, device="cpu")
                                            for cls in BASELINES]
    names = set()
    for m in methods:
        assert isinstance(m, DSEMethod), type(m).__name__
        names.add(m.method_name)
    assert names == {"GANDSE", "LargeMLP", "DRL", "SA", "RandomSearch"}
    # model-free methods accept the shared training call as a no-op
    for cls in (SimulatedAnnealing, RandomSearch):
        m = cls(tm, device="cpu")
        assert m.train(n_data=0, iters=0) is m


@pytest.mark.parametrize("cls", BASELINES, ids=lambda c: c.__name__)
def test_baselines_default_to_the_card(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(DnnWeaverModel())
    assert cls(DnnWeaverModel(), device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# RandomSearch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_samples", [64, 600])   # 600: select's device route
@pytest.mark.parametrize("batched", [True, False])
def test_random_search_matches_reference(data, n_samples, batched):
    jm, tm, _, _, tasks = data
    want = JRS(jm, n_samples=n_samples).explore_tasks(tasks, seed=6,
                                                     batched=batched)
    got = RandomSearch(tm, n_samples=n_samples, device="cpu").explore_tasks(
        tasks, seed=6, batched=batched)
    _assert_all_same(got, want)


# ---------------------------------------------------------------------------
# LargeMLP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 1])
def test_mlp_init_params_bit_for_bit(data, seed):
    jm, tm = data[:2]
    want = JMLP(jm, hidden_layers=2, neurons=32).init_params(seed)
    got = LargeMLP(tm, hidden_layers=2, neurons=32,
                   device="cpu").init_params(seed)
    for a, b in zip(jax.tree.leaves(want), [t for p in got["layers"]
                                            for t in (p["b"], p["w"])]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_mlp_loss_and_gradients_match_reference(data):
    jm, tm, jds, tds, _ = data
    j = JMLP(jm, hidden_layers=2, neurons=32)
    t = LargeMLP(tm, hidden_layers=2, neurons=32, device="cpu")
    jp = j.init_params(1)
    idx = np.random.default_rng(4).permutation(jds.n)[:64]
    jb = {k: jnp.asarray(v) for k, v in j_encode(jm, jds, idx).items()}
    tb = {k: torch.from_numpy(v) for k, v in T.encode_batch(tm, tds,
                                                             idx).items()}
    jn = JG.sample_noise_dim(jax.random.PRNGKey(9), 64, 8)
    tn = G.sample_noise_dim(prng.prng_key(torch.tensor(9)), 64, 8)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    fwd = j_mlp_fwd(jm.space, 8, False)[0]

    def loss_fn(p):
        probs = fwd(p, jb["net_enc"], jb["obj_enc"], jn)
        return jnp.mean(JG.grouped_cross_entropy(jm.space, jb["cfg_onehot"],
                                                 probs))

    want_loss, want_g = jax.value_and_grad(loss_fn)(jp)
    loss, grads = t.loss_and_grads(_to_torch(jp), tb, tn)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(want_g))
    for a, b in zip(jax.tree.leaves(want_g), [x for p in grads["layers"]
                                              for x in (p["b"], p["w"])]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=STEP_RTOL,
                                   atol=STEP_ATOL * scale)


@pytest.mark.parametrize("models,lr", [((JDnnWeaver, DnnWeaverModel), 2e-5),
                                       ((JIm2col, Im2colModel), 1e-3)],
                         ids=["dnnweaver", "im2col"])
def test_mlp_train_step_matches_reference(models, lr):
    """`train` on a dataset of one batch is one step: the same permutation,
    noise (``split(PRNGKey(seed))``) and Adam update in both packages."""
    jm, tm = models[0](), models[1]()
    jds, tds = j_generate(jm, 64, seed=1), generate_dataset(tm, 64, seed=1)
    j = JMLP(jm, hidden_layers=2, neurons=32, lr=lr, batch_size=64)
    t = LargeMLP(tm, hidden_layers=2, neurons=32, lr=lr, batch_size=64,
                 device="cpu")
    j.train(n_data=0, iters=1, seed=5, ds=jds)
    t.train(n_data=0, iters=1, seed=5, ds=tds)
    for a, b in zip(jax.tree.leaves(j.params), [x for p in t.params["layers"]
                                                for x in (p["b"], p["w"])]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
    assert t.n_params() == j.n_params()


@pytest.mark.parametrize("noise_samples", [1, 3])
def test_mlp_probs_match_reference(data, mlps, noise_samples):
    j, t = mlps
    tasks = data[4]
    j.explorer_cfg.noise_samples = t.explorer_cfg.noise_samples = \
        noise_samples
    try:
        seeds = np.array([0, 5, 2**31 - 1, 2**33 + 2], np.int64)
        want = np.asarray(j.generator_probs_device(
            tasks.net_idx, tasks.lat_obj, tasks.pow_obj, seeds))
        got = t.generator_probs_device(tasks.net_idx, tasks.lat_obj,
                                       tasks.pow_obj, seeds).numpy()
    finally:
        j.explorer_cfg.noise_samples = t.explorer_cfg.noise_samples = 1
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)


@pytest.mark.parametrize("dense", [False, True])
def test_mlp_selections_from_the_reference_probs(data, mlps, dense):
    """The reference's own probs through the port's select routes give
    the reference LargeMLP's Selections exactly."""
    from repro_torch.core.explorer import enumerate_candidates_batch
    from repro_torch.core.fused_select import fused_select_batch
    from repro_torch.core.selector import select_batch
    j, t = mlps
    tasks = data[4]
    xcfg = t.explorer_cfg
    want = j.explore_batch(tasks, seed=11)
    probs = torch.from_numpy(np.array(j.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj, np.arange(4) + 11)))
    if dense:
        cand, valid, counts = enumerate_candidates_batch(
            t.model.space, probs, xcfg.prob_threshold, xcfg.max_candidates)
        got = select_batch(t.model, tasks.net_idx, cand, valid, counts,
                           tasks.lat_obj, tasks.pow_obj)
    else:
        got = fused_select_batch(t.model, tasks.net_idx, probs,
                                 xcfg.prob_threshold, xcfg.max_candidates,
                                 tasks.lat_obj, tasks.pow_obj)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _same(a, b.selection), (i, a, b.selection)


@pytest.mark.parametrize("route", ["fused", "dense", "sequential"])
def test_mlp_selections_match_reference(data, mlps, route, monkeypatch):
    """The port's batched LargeMLP takes the dense route at this batch and
    cap; with the dense block capped at 0 rows, the streaming route."""
    from repro_torch.core import fused_select as FS
    j, t = mlps
    tasks = data[4]
    if route == "fused":
        monkeypatch.setattr(FS, "DENSE_ROWS", 0)
    j.explorer_cfg.batch_route = "dense" if route == "dense" else "fused"
    try:
        batched = route != "sequential"
        want = j.explore_tasks(tasks, seed=3, batched=batched)
        got = t.explore_tasks(tasks, seed=3, batched=batched)
    finally:
        j.explorer_cfg.batch_route = "fused"
    _assert_all_same(got, want)
    assert any(r.selection.cfg_idx is not None for r in got)


# ---------------------------------------------------------------------------
# SimulatedAnnealing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cooling,steps", [(0.95, 4), (0.9, 3), (0.99, 1)])
def test_sa_temperatures_match_the_reference_schedule(cooling, steps):
    """float32 ``t_init * cooling ** (step // steps_per_temp)``, bit for
    bit XLA's (the float64 power rounded once is an ulp away at two of
    the 338 levels of the default schedule)."""
    sa = SimulatedAnnealing(DnnWeaverModel(), cooling=cooling,
                            steps_per_temp=steps, device="cpu")
    got = _temperatures(1.0, cooling, steps, sa.max_steps)
    k = jnp.arange(sa.max_steps) // steps
    want = np.asarray(1.0 * jnp.power(jnp.float32(cooling),
                                      k.astype(jnp.float32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("models,n_tasks,seed", [
    ((JDnnWeaver, DnnWeaverModel), 16, 5),
    ((JIm2col, Im2colModel), 8, 11),
], ids=["dnnweaver", "im2col"])
def test_sa_device_lanes_match_reference(models, n_tasks, seed):
    jm, tm = models[0](), models[1]()
    tasks = generate_tasks(tm, n_tasks, seed=seed)
    want = JSA(jm).explore_tasks(tasks, seed=seed)
    got = SimulatedAnnealing(tm, device="cpu").explore_tasks(tasks, seed=seed)
    _assert_all_same(got, want)


#: Table 5's dnnweaver SA lanes (200 hard tasks from seed 1, explored
#: from seed 2) that differ from the reference's, with the config where
#: the port's lane stops: the reference's jitted anneal fuses the oracle
#: and rounds that config's power 2 ulps up, over the objective
SA_TABLE5_LANES_OFF = {105: [2, 1, 4, 0]}


def test_sa_lanes_of_table5_match_reference():
    jm, tm = JDnnWeaver(), DnnWeaverModel()
    tasks = generate_tasks(tm, 200, seed=1, slack=(1.0, 1.0))
    want = JSA(jm).explore_tasks(tasks, seed=2)
    got = SimulatedAnnealing(tm, device="cpu").explore_tasks(tasks, seed=2)
    off = [t for t, (a, b) in enumerate(zip(got, want))
           if not _same(a.selection, b.selection)]
    assert off == sorted(SA_TABLE5_LANES_OFF)
    for t, cfg in SA_TABLE5_LANES_OFF.items():
        assert got[t].selection.cfg_idx.tolist() == cfg and got[t].satisfied
        net = jnp.asarray(tasks.net_idx[t:t + 1].astype(np.int32))
        c = jnp.asarray([cfg], jnp.int32)
        po = np.float32(tasks.pow_obj[t])
        alone = np.asarray(jm.evaluate_jax_indices(net, c)[1])[0]
        fused = np.asarray(jax.jit(lambda n, c_: jnp.maximum(
            0.0, (jm.evaluate_jax_indices(n, c_)[1] - po) / po))(net, c))[0]
        torch_pw = tm.evaluate_torch_indices(
            torch.as_tensor(tasks.net_idx[t:t + 1], dtype=torch.int64),
            torch.as_tensor([cfg]))[1].numpy()[0]
        assert torch_pw == alone <= po      # violation 0: the lane stops
        assert fused > 0.0                  # the reference's lane goes on


def test_sa_zero_feasible_lanes_match_reference(data):
    tasks = data[4]
    want = JSA(_JInfeasible()).explore_tasks(tasks, seed=5)
    sa = SimulatedAnnealing(_TInfeasible(), device="cpu")
    got = sa.explore_tasks(tasks, seed=5)
    _assert_all_same(got, want)
    for r in got:    # every proposal evaluated: no early satisfied exit
        assert r.selection.n_candidates == sa.max_steps + 1
        assert not r.satisfied and r.selection.latency == np.inf


def test_sa_host_lanes_match_reference(data):
    jm, tm, _, _, tasks = data
    want = JSA(jm).explore_tasks(tasks, seed=7, batched=False)
    got = SimulatedAnnealing(tm, device="cpu").explore_tasks(
        tasks, seed=7, batched=False)
    _assert_all_same(got, want)
    one = SimulatedAnnealing(tm, device="cpu").explore(
        tasks.net_idx[0], tasks.lat_obj[0], tasks.pow_obj[0], seed=3)
    ref = JSA(jm).explore(tasks.net_idx[0], tasks.lat_obj[0],
                          tasks.pow_obj[0], seed=3)
    assert _same(one.selection, ref.selection)


# ---------------------------------------------------------------------------
# PolicyGradientDRL
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batched", [True, False])
def test_drl_rollout_from_converted_params_matches_reference(data, drls,
                                                             batched):
    j, t = drls
    tasks = data[4]
    _assert_all_same(t.explore_tasks(tasks, seed=4, batched=batched),
                     j.explore_tasks(tasks, seed=4, batched=batched))


def test_drl_rollout_many_lanes_matches_reference(drls):
    j, t = drls
    tasks = generate_tasks(t.model, 32, seed=8)
    _assert_all_same(t.explore_tasks(tasks, seed=40),
                     j.explore_tasks(tasks, seed=40))


def test_drl_one_train_iteration_matches_reference(data):
    """One REINFORCE iteration (a 16-task, 8-step rollout on the host
    oracle, then one Adam step) from the same seed: the new params."""
    jm, tm, jds, tds, _ = data
    j = JDRL(jm, hidden_layers=1, neurons=32, rollout_len=8, batch_tasks=16,
             lr=1e-3)
    t = PolicyGradientDRL(tm, hidden_layers=1, neurons=32, rollout_len=8,
                          batch_tasks=16, lr=1e-3, device="cpu")
    j.train(n_data=0, iters=1, seed=3, ds=jds)
    t.train(n_data=0, iters=1, seed=3, ds=tds)
    for a, b in zip(jax.tree.leaves(j.params), [x for p in t.params["layers"]
                                                for x in (p["b"], p["w"])]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)


# ---------------------------------------------------------------------------
# explore_tasks: batched equals sequential, within the port
# ---------------------------------------------------------------------------
def _one_by_one(method, tasks, seed):
    """The batch's tasks one at a time: LargeMLP and RandomSearch through
    their sequential host route; DRL and SA through single-task device
    runs (their host routes draw from numpy, not threefry)."""
    if isinstance(method, (LargeMLP, RandomSearch)):
        return method.explore_tasks(tasks, seed=seed, batched=False)
    return [method.explore(tasks.net_idx[i], tasks.lat_obj[i],
                           tasks.pow_obj[i], seed=seed + i)
            for i in range(len(tasks))]


def test_explore_tasks_equal_their_sequential_route(data, mlps, drls):
    tm, tasks = data[1], data[4]
    for method in (mlps[1], drls[1], SimulatedAnnealing(tm, device="cpu"),
                   RandomSearch(tm, n_samples=64, device="cpu")):
        _assert_all_same(method.explore_tasks(tasks, seed=9),
                         _one_by_one(method, tasks, 9))


def test_explore_tasks_zero_feasible(data, mlps, drls):
    tds, tasks = data[3], data[4]
    inf = _TInfeasible()
    m = LargeMLP(inf, hidden_layers=1, neurons=32,
                 explorer_cfg=mlps[1].explorer_cfg,
                 device="cpu").attach(tds, mlps[1].params)
    d = PolicyGradientDRL(inf, hidden_layers=1, neurons=32, rollout_len=8,
                          device="cpu").attach(tds, drls[1].params)
    rs = RandomSearch(inf, n_samples=32, device="cpu")
    for method in (m, d, rs):
        batched = method.explore_tasks(tasks, seed=3)
        _assert_all_same(batched, _one_by_one(method, tasks, 3))
        for r in batched:
            assert not r.satisfied and r.selection.latency == np.inf
    for r in m.explore_tasks(tasks, seed=3):
        assert r.selection.cfg_idx is None and r.selection.n_candidates > 0


def test_explore_tasks_host_only_model(data, mlps, drls):
    tds, tasks = data[3], data[4]
    host = _THostOnly()
    assert not host.has_torch_oracle
    m = LargeMLP(host, hidden_layers=1, neurons=32,
                 explorer_cfg=mlps[1].explorer_cfg,
                 device="cpu").attach(tds, mlps[1].params)
    d = PolicyGradientDRL(host, hidden_layers=1, neurons=32, rollout_len=8,
                          device="cpu").attach(tds, drls[1].params)
    for method in (m, d, SimulatedAnnealing(host, device="cpu"),
                   RandomSearch(host, n_samples=32, device="cpu")):
        res = method.explore_tasks(tasks, seed=9)
        assert len(res) == len(tasks)
        # a forced batched route falls back too (the GANDSE rule)
        _assert_all_same(method.explore_tasks(tasks, seed=9, batched=True),
                         res)
