"""The port's explore path against the reference package.

Split at the probs boundary, as the ROADMAP's parity rule says:

- *given identical probs*, candidate enumeration and Selections are
  identical (exact equality): the streaming ``fused_select_batch`` and the
  host ``select``, over adversarial tile boundaries, ties, zero-feasible
  tasks and ragged counts, on a synthetic model whose metrics are exact
  small integers (float32 and float64 chains agree), and on the three
  real design models;
- the dense route (``enumerate_candidates_batch`` + ``select_batch``)
  and ``select``'s device route, given identical probs or candidates:
  identical candidates and Selections, equal to the fused route's;
  ``select_from_probs`` picks between the two batched routes from the
  batch and the cap;
- *given identical params and seed*, G's probs are allclose (atol 1e-6:
  float32 sums in another order; the reference's CPU route is the vmapped
  per-task forward, the port's the flattened row batch) and the
  Selections of ``GANDSE.explore_batch`` are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse_api as JAPI
from repro.core import explorer as JE
from repro.core import gan as JG
from repro.core.encoding import ConfigDim as JDim, ConfigSpace as JSpace
from repro.core.fused_select import fused_select_batch as j_fused
from repro.core import selector as JS
from repro.core.selector import select as j_select
from repro.dataset import generator as JGEN
from repro.design_models.base import DesignModel as JDesignModel
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro.design_models.im2col import Im2colModel as JIm2col
from repro.design_models.tpu_mesh import TpuMeshModel as JTpuMesh
from repro_torch.convert import g_params_from_numpy, g_params_to_numpy
from repro_torch.core import dse_api as API
from repro_torch.core import explorer as E
from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core import shard
from repro_torch.core.encoding import ConfigDim, ConfigSpace
from repro_torch.core import fused_select as FS
from repro_torch.core.fused_select import fused_select_batch
from repro_torch.core import selector as S
from repro_torch.core.selector import select
from repro_torch.dataset import generator as GEN
from repro_torch.design_models import (DnnWeaverModel, Im2colModel,
                                       TpuMeshModel)
from repro_torch.design_models.base import DesignModel

PROBS_ATOL = 1e-6


# ---------------------------------------------------------------------------
# synthetic models, one per package
# ---------------------------------------------------------------------------
def _dims(sizes):
    return [(f"d{k}", tuple(float(v) for v in range(n)))
            for k, n in enumerate(sizes)]


class _Mix:
    """Metrics are small-integer hashes of the config values — exact in
    float32 — with small moduli forcing exact ties; ``inf_mod`` marks
    every config whose mix it divides infeasible (1 -> none feasible)."""

    name = "mix"

    def _setup(self, sizes, lat_mod, pw_mod, inf_mod, dim_cls, space_cls):
        self.space = space_cls(dims=tuple(dim_cls(n, c)
                                          for n, c in _dims(sizes)))
        self.net_space = space_cls(dims=(dim_cls("n", (0.0, 1.0)),))
        self._w = np.arange(1, len(sizes) + 1, dtype=np.float64) * 3.0 + 2.0
        self.lat_mod, self.pw_mod, self.inf_mod = lat_mod, pw_mod, inf_mod

    def _mix(self, s, mod, where, inf):
        lat = mod(s * 7.0 + 3.0, self.lat_mod) + 1.0
        pw = mod(s * 5.0 + 11.0, self.pw_mod) + 1.0
        if self.inf_mod:
            bad = mod(s, self.inf_mod) == 0
            lat, pw = where(bad, inf, lat), where(bad, inf, pw)
        return lat, pw

    def evaluate(self, net, config):
        c = np.asarray(config, np.float64)
        return self._mix((c * self._w).sum(-1), np.mod, np.where, np.inf)


class JMix(_Mix, JDesignModel):
    def __init__(self, sizes, lat_mod=61.0, pw_mod=53.0, inf_mod=0.0):
        self._setup(sizes, lat_mod, pw_mod, inf_mod, JDim, JSpace)

    def evaluate_jax(self, net, config):
        s = (config * jnp.asarray(self._w, config.dtype)).sum(-1)
        return self._mix(s, jnp.mod, jnp.where, jnp.inf)


class TMix(_Mix, DesignModel):
    def __init__(self, sizes, lat_mod=61.0, pw_mod=53.0, inf_mod=0.0):
        self._setup(sizes, lat_mod, pw_mod, inf_mod, ConfigDim, ConfigSpace)

    def evaluate_torch(self, net, config):
        w = torch.as_tensor(self._w, dtype=config.dtype, device=config.device)
        s = (config * w).sum(-1)
        return self._mix(s, torch.remainder, torch.where, float("inf"))


def _probs(space, n_tasks, seed, peak=0.9):
    """Per-group dirichlet probs scaled so each group's max is `peak`:
    thresholds then slice ragged employed sets."""
    rng = np.random.default_rng(seed)
    cols = []
    for dim in space.dims:
        p = rng.dirichlet(np.ones(dim.n), size=n_tasks)
        cols.append(p / p.max(axis=1, keepdims=True) * peak)
    return np.concatenate(cols, axis=1).astype(np.float32)


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
        assert _same(a, b), (t, a, b)


# ---------------------------------------------------------------------------
# given identical probs
# ---------------------------------------------------------------------------
MIX_CASES = [
    # sizes, thresh, cap, tile, lat_mod, pw_mod, inf_mod, n_tasks
    ((5, 7, 3), 0.05, 4096, 16, 61.0, 53.0, 0.0, 12),     # multi-tile
    ((5, 7, 3), 0.05, 4096, 105, 61.0, 53.0, 0.0, 8),     # tile == max total
    ((5, 7, 3), 0.05, 4096, 104, 61.0, 53.0, 0.0, 8),     # tile - 1
    ((5, 7, 3), 0.05, 4096, 106, 61.0, 53.0, 0.0, 8),     # tile + 1
    ((4, 4, 4, 4), 0.1, 60, 7, 5.0, 3.0, 0.0, 16),        # trim + many ties
    ((6, 5), 0.0, 4096, 4, 1.0, 1.0, 0.0, 4),             # all ties: first wins
    ((6, 5), 0.0, 4096, 8, 61.0, 53.0, 1.0, 5),           # zero feasible
    ((6, 5, 4), 0.0, 4096, 32, 61.0, 53.0, 7.0, 9),       # holes mid-tile
    ((3, 9, 2, 5), 0.3, 50, 3, 13.0, 11.0, 5.0, 11),      # ragged + trim
]


@pytest.mark.parametrize("case", MIX_CASES)
def test_fused_and_host_select_match_reference(case):
    sizes, thresh, cap, tile, lm, pm, im, t = case
    jm, tm = JMix(sizes, lm, pm, im), TMix(sizes, lm, pm, im)
    probs = _probs(jm.space, t, seed=sum(sizes) + t)
    rng = np.random.default_rng(t)
    lo = rng.uniform(1.0, 60.0, t)
    po = rng.uniform(1.0, 50.0, t)
    net = np.zeros((t, 1), np.int32)
    want = j_fused(jm, net, probs, thresh, cap, lo, po, tile=tile)
    got = fused_select_batch(tm, net, torch.from_numpy(probs), thresh, cap,
                             lo, po, tile=tile)
    _assert_all_same(got, want)
    host = []
    for i in range(t):
        cand = E.enumerate_candidates(tm.space, probs[i], thresh, cap)
        np.testing.assert_array_equal(
            cand, JE.enumerate_candidates(jm.space, probs[i], thresh, cap))
        host.append(select(tm, net[i], cand, lo[i], po[i]))
        assert _same(host[-1], j_select(jm, net[i], cand, lo[i], po[i],
                                        use_jax=False))
    _assert_all_same(host, want)     # exact-integer metrics: routes agree


@pytest.mark.parametrize("sizes,thresh,cap", [
    ((5, 7, 3), 0.05, 4096),
    ((4, 4, 4, 4), 0.1, 60),
    ((3, 9, 2, 5), 0.3, 7),
    ((8, 1, 8), 0.0, 1),
])
def test_enumeration_cores_match_reference(sizes, thresh, cap):
    jm, tm = JMix(sizes), TMix(sizes)
    probs = _probs(jm.space, 10, seed=len(sizes) + cap)
    probs[0] = probs[1]                          # duplicate rows
    probs[2, :3] = probs[2, 0]                   # tied probabilities
    j_masks, j_radix = JE._enum_core(jm.space)
    t_masks, t_radix = E._enum_core(tm.space)
    jk, jc, jt = j_masks(jnp.asarray(probs), jnp.float32(thresh),
                         jnp.int32(cap))
    tk, tc, tt = t_masks(torch.from_numpy(probs), thresh, cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jtab, jstr = j_radix(jk, jc)
    ttab, tstr = t_radix(tk, tc)
    np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    np.testing.assert_array_equal(tstr.numpy(), np.asarray(jstr))


class _JTable(JDesignModel):
    """Lookup model: candidate i -> (lat[i], pw[i]) (reference side)."""

    name = "table"

    def __init__(self, lat, pw):
        self.lat, self.pw = np.asarray(lat, float), np.asarray(pw, float)
        self.space = JSpace(dims=(JDim("i", tuple(
            float(i) for i in range(len(self.lat)))),))
        self.net_space = JSpace(dims=(JDim("n", (0.0, 1.0)),))

    def evaluate(self, net, config):
        i = np.asarray(config)[..., 0].astype(int)
        return self.lat[i], self.pw[i]


class _TTable(DesignModel):
    name = "table"

    def __init__(self, lat, pw):
        self.lat, self.pw = np.asarray(lat, float), np.asarray(pw, float)
        self.space = ConfigSpace(dims=(ConfigDim("i", tuple(
            float(i) for i in range(len(self.lat)))),))
        self.net_space = ConfigSpace(dims=(ConfigDim("n", (0.0, 1.0)),))

    def evaluate(self, net, config):
        i = np.asarray(config)[..., 0].astype(int)
        return self.lat[i], self.pw[i]


def test_host_select_copies_the_stall_at_equality():
    """The published chain stalls once L_opt == LO exactly: the satisfying
    second candidate (1.0, 1.0) is never taken after (1.0, 2.0).  The port
    copies the chain, so both packages return the same unsatisfied
    Selection (ROADMAP Queue 3)."""
    lat, pw = [1.0, 1.0], [2.0, 1.0]
    cands = np.arange(2, dtype=np.int32)[:, None]
    got = select(_TTable(lat, pw), np.array([0]), cands, 1.0, 1.0)
    want = j_select(_JTable(lat, pw), np.array([0]), cands, 1.0, 1.0)
    assert _same(got, want)
    assert not got.satisfied and got.cfg_idx.tolist() == [0]


REAL = {
    "dnnweaver": (JDnnWeaver, DnnWeaverModel),
    "im2col": (JIm2col, Im2colModel),
    "tpu_mesh": (JTpuMesh, TpuMeshModel),
}


@pytest.mark.parametrize("name,thresh,cap,tile", [
    ("dnnweaver", 0.1, 4096, 1024),
    ("dnnweaver", 0.02, 500, 64),
    ("im2col", 0.2, 4096, 1024),
    ("im2col", 0.25, 4096, 300),
    ("tpu_mesh", 0.2, 4096, 1024),
    ("tpu_mesh", 0.1, 100, 16),
])
def test_real_models_select_matches_reference_given_probs(name, thresh, cap,
                                                          tile):
    jm, tm = REAL[name][0](), REAL[name][1]()
    t = 16
    probs = _probs(jm.space, t, seed=cap + tile)
    tasks = JGEN.generate_tasks(jm, t, seed=3)
    want = j_fused(jm, tasks.net_idx, probs, thresh, cap, tasks.lat_obj,
                   tasks.pow_obj, tile=tile)
    got = fused_select_batch(tm, tasks.net_idx, torch.from_numpy(probs),
                             thresh, cap, tasks.lat_obj, tasks.pow_obj,
                             tile=tile)
    _assert_all_same(got, want)
    assert any(s.cfg_idx is not None for s in got)


# ---------------------------------------------------------------------------
# given identical params and seed: the whole serving path
# ---------------------------------------------------------------------------
def _engines(name, layers=2, neurons=32, noise_samples=1):
    jm, tm = REAL[name][0](), REAL[name][1]()
    jcfg = JG.GANConfig(n_net=jm.net_space.n_dims).scaled(layers, neurons)
    tcfg = G.GANConfig(n_net=tm.net_space.n_dims).scaled(layers, neurons)
    xj = JE.ExplorerConfig(noise_samples=noise_samples)
    xt = E.ExplorerConfig(noise_samples=noise_samples)
    g = JG.init_generator(jax.random.PRNGKey(7), jcfg, jm.space)
    numpy_params = jax.tree.map(np.asarray, g)
    je = JAPI.GANDSE(jm, jcfg, xj)
    je.attach(JGEN.generate_dataset(jm, 512, seed=0), g)
    te = API.GANDSE(tm, tcfg, xt, device="cpu")
    te.attach(GEN.generate_dataset(tm, 512, seed=0),
              g_params_from_numpy(numpy_params, "cpu"))
    return je, te


@pytest.mark.parametrize("name", sorted(REAL))
@pytest.mark.parametrize("n_tasks,noise_samples", [(16, 1), (12, 2)])
def test_explore_batch_matches_reference(name, n_tasks, noise_samples):
    je, te = _engines(name, noise_samples=noise_samples)
    tasks = JGEN.generate_tasks(je.model, n_tasks, seed=1)
    seed = 2**31 - 4                       # sums cross the int32 edge
    seeds = JE.row_seeds(seed, n_tasks)
    jp = je._explorer.generator_probs(tasks.net_idx, tasks.lat_obj,
                                      tasks.pow_obj, seed=seeds)
    tp = te._explorer.generator_probs(tasks.net_idx, tasks.lat_obj,
                                      tasks.pow_obj, seed=seeds)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROBS_ATOL)
    want = je.explore_batch(tasks, seed=seed)
    got = te.explore_batch(tasks, seed=seed)
    _assert_all_same([r.selection for r in got], [r.selection for r in want])
    assert [r.lat_obj for r in got] == [r.lat_obj for r in want]
    assert any(r.selection.cfg_idx is not None for r in got)
    s_got, s_want = API.summarize(got), JAPI.summarize(want)
    for k in ("n_tasks", "n_satisfied", "n_candidates"):
        assert s_got[k] == s_want[k]


@pytest.mark.parametrize("name", ["dnnweaver", "tpu_mesh"])
def test_explore_single_task_matches_reference(name):
    je, te = _engines(name)
    tasks = JGEN.generate_tasks(je.model, 3, seed=5)
    for i in range(3):
        args = (tasks.net_idx[i], tasks.lat_obj[i], tasks.pow_obj[i])
        got, want = te.explore(*args, seed=40 + i), je.explore(*args,
                                                              seed=40 + i)
        assert _same(got.selection, want.selection)
        if got.selection.cfg_idx is not None:
            assert te.emit_config(got) == je.emit_config(want)


def test_explore_batch_rows_do_not_depend_on_batch_placement():
    """Row t with seed s equals a one-task batch with seed s (the
    ``cache_key`` contract), padding rows included."""
    _, te = _engines("im2col")
    tasks = GEN.generate_tasks(te.model, 5, seed=9)
    seeds = np.array([11, 2**33 + 1, -3, 7, 11], np.int64)
    batch = te.explore_batch(tasks, seed=seeds)
    for i in (0, 2, 4):
        one = te.explore_batch(tasks.take([i]), seed=seeds[i:i + 1])
        assert _same(one[0].selection, batch[i].selection)
    assert API.cache_key("im2col", tasks.net_idx[0], tasks.lat_obj[0],
                         tasks.pow_obj[0], 11) == \
        JAPI.cache_key("im2col", tasks.net_idx[0], tasks.lat_obj[0],
                       tasks.pow_obj[0], 11)


def test_params_round_trip_and_pad_tasks_match_reference(rng):
    from repro.core import shard as jshard
    cfg = G.GANConfig(n_net=6).scaled(2, 16)
    p = G.init_generator(prng.prng_key(torch.tensor(1)), cfg,
                         Im2colModel().space, "cpu")
    back = g_params_from_numpy(g_params_to_numpy(p), "cpu")
    for a, b in zip(p["layers"], back["layers"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    for n in (1, 3, 4, 5, 17):
        tasks = GEN.generate_tasks(DnnWeaverModel(), n, seed=n)
        seeds = np.arange(n, dtype=np.int64) * 3
        tp, sp, nr = shard.pad_tasks(tasks, seeds)
        jtp, jsp, jnr = jshard.pad_tasks(tasks, seeds)
        assert nr == jnr == n
        np.testing.assert_array_equal(tp.net_idx, jtp.net_idx)
        np.testing.assert_array_equal(sp, jsp)
        assert shard.pow2_bucket(n) == jshard.pow2_bucket(n)


def test_summarize_and_parse_network_match_reference():
    got, want = API.summarize([]), JAPI.summarize([])
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))
    desc = {"IC": 60, "OC": 33, "OW": 9, "OH": 64, "KW": 4, "KH": 1}
    np.testing.assert_array_equal(
        API.parse_network(desc, Im2colModel()),
        JAPI.parse_network(desc, JIm2col()))


# ---------------------------------------------------------------------------
# the dense route and select's device route
# ---------------------------------------------------------------------------
DENSE_CASES = [
    # model, thresh, cap, n_tasks
    ("mix", 0.05, 4096, 12),
    ("mix", 0.1, 60, 16),
    ("mix", 0.0, 1, 4),
    ("dnnweaver", 0.1, 4096, 16),
    ("im2col", 0.2, 500, 16),
    ("tpu_mesh", 0.1, 100, 8),
]


def _dense_models(name):
    if name == "mix":
        return JMix((3, 9, 2, 5), 13.0, 11.0, 5.0), TMix((3, 9, 2, 5), 13.0,
                                                        11.0, 5.0)
    return REAL[name][0](), REAL[name][1]()


def _dense_inputs(name, jm, t, seed):
    probs = _probs(jm.space, t, seed=seed)
    if name == "mix":
        rng = np.random.default_rng(t)
        return (probs, np.zeros((t, 1), np.int32), rng.uniform(1.0, 14.0, t),
                rng.uniform(1.0, 12.0, t))
    tasks = JGEN.generate_tasks(jm, t, seed=seed)
    return probs, tasks.net_idx, tasks.lat_obj, tasks.pow_obj


@pytest.mark.parametrize("case", DENSE_CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_enumerate_candidates_batch_matches_reference(case):
    name, thresh, cap, t = case
    jm, tm = _dense_models(name)
    probs = _dense_inputs(name, jm, t, seed=cap + t)[0]
    jc, jv, jn = JE.enumerate_candidates_batch(jm.space, probs, thresh, cap)
    tc, tv, tn = E.enumerate_candidates_batch(tm.space,
                                              torch.from_numpy(probs),
                                              thresh, cap)
    assert tc.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tn, np.asarray(jn))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # padding rows hold what the mixed radix gives past the product; only
    # the real rows are a contract
    for i in range(t):
        np.testing.assert_array_equal(tc[i, :tn[i]].numpy(),
                                      np.asarray(jc)[i, :jn[i]])
        np.testing.assert_array_equal(
            tc[i, :tn[i]].numpy(),
            E.enumerate_candidates(tm.space, probs[i], thresh, cap))


@pytest.mark.parametrize("case", DENSE_CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_select_batch_and_dense_route_match_reference(case):
    name, thresh, cap, t = case
    jm, tm = _dense_models(name)
    probs, net, lo, po = _dense_inputs(name, jm, t, seed=cap + t + 1)
    jc, jv, jn = JE.enumerate_candidates_batch(jm.space, probs, thresh, cap)
    want = JS.select_batch(jm, net, jc, jv, jn, lo, po)
    tc, tv, tn = E.enumerate_candidates_batch(tm.space,
                                              torch.from_numpy(probs),
                                              thresh, cap)
    got = S.select_batch(tm, net, tc, tv, tn, lo, po)
    _assert_all_same(got, want)
    # the fused route gives the dense route's Selections
    _assert_all_same(fused_select_batch(tm, net, torch.from_numpy(probs),
                                        thresh, cap, lo, po, tile=64), got)
    # ... and select's device route, one task at a time
    for i in range(t):
        cand = tc[i, :tn[i]].numpy()
        one = select(tm, net[i], cand, lo[i], po[i], use_torch=True,
                     device="cpu")
        assert _same(one, got[i]), i
        assert _same(one, j_select(jm, net[i], cand, lo[i], po[i],
                                   use_jax=True))


def test_select_routes_by_candidate_count_and_override():
    """use_torch=None: the device route (`select_batch` for one task) from
    TORCH_MIN_CANDIDATES rows on, as the reference's JAX_MIN_CANDIDATES
    crossover; an explicit use_torch overrides the count either way."""
    assert S.TORCH_MIN_CANDIDATES == JS.JAX_MIN_CANDIDATES == 512
    tm = TMix((8, 8, 8, 2), 61.0, 53.0, 0.0)
    cands = np.stack(np.meshgrid(*[np.arange(n) for n in (8, 8, 8, 2)],
                                 indexing="ij"), -1).reshape(-1, 4)
    calls = []
    real = S.select_batch

    def spy(*a, **k):
        calls.append(a[2].shape[1])
        return real(*a, **k)

    net = np.zeros(1, np.int32)
    S.select_batch = spy
    try:
        below = select(tm, net, cands[:511], 30.0, 20.0, device="cpu")
        select(tm, net, cands[:512], 30.0, 20.0, device="cpu")
        select(tm, net, cands[:600], 30.0, 20.0, use_torch=False,
               device="cpu")
        forced = select(tm, net, cands[:511], 30.0, 20.0, use_torch=True,
                        device="cpu")
    finally:
        S.select_batch = real
    assert calls == [512, 511]
    # exact small-integer metrics: both routes take the same winner
    assert _same(forced, below)


@pytest.mark.parametrize("name", sorted(REAL))
def test_dense_route_fits_the_cap_and_the_block(name):
    """select_from_probs takes the dense route while the cap is within
    _DENSE_LIM and T x pow2(cap) rows within DENSE_ROWS, else streams."""
    tm = REAL[name][1]()
    rows = FS.DENSE_ROWS
    assert FS.dense_route_fits(tm, rows // 4096, 4096)
    assert FS.dense_route_fits(tm, rows // 4096, 3000)      # pow2: 4096
    assert not FS.dense_route_fits(tm, rows // 4096 + 1, 4096)
    assert FS.dense_route_fits(tm, 1, E._DENSE_LIM)
    assert not FS.dense_route_fits(tm, 1, E._DENSE_LIM + 1)


@pytest.mark.parametrize("name", sorted(REAL))
def test_explore_batch_dense_route_matches_fused_and_reference(name,
                                                               monkeypatch):
    """explore_batch takes the dense route at this batch and cap, and the
    streaming route when the dense block is capped at 0 rows: the same
    Selections, the reference's dense route's too."""
    je, te = _engines(name)
    tasks = JGEN.generate_tasks(je.model, 12, seed=4)
    taken = []
    for route in ("select_batch", "fused_select_batch"):
        real = getattr(FS, route)
        monkeypatch.setattr(FS, route, lambda *a, _f=real, _r=route, **k: (
            taken.append(_r), _f(*a, **k))[1])
    dense = te.explore_batch(tasks, seed=21)
    with monkeypatch.context() as mp:
        mp.setattr(FS, "DENSE_ROWS", 0)
        fused = te.explore_batch(tasks, seed=21)
    assert taken == ["select_batch", "fused_select_batch"]
    je.explorer_cfg.batch_route = "dense"
    want = je.explore_batch(tasks, seed=21)
    _assert_all_same([r.selection for r in dense],
                     [r.selection for r in fused])
    _assert_all_same([r.selection for r in dense],
                     [r.selection for r in want])
    # the dense route's rows do not depend on the batch either
    one = te.explore_batch(tasks.take([3]), seed=np.array([24]))
    assert _same(one[0].selection, dense[3].selection)
