"""The port's `DSEServer` (``repro_torch.serve``) against the reference's.

On the CPU at a small size (G 1 x 32, dnnweaver and im2col, 1-10 tasks,
threshold 0.1, cap 128), both packages' engines hold the same G params
(the reference's init for a key, carried over with
``convert.g_params_from_numpy``) and the same dataset:

- one request stream (shuffled submits, duplicates of queued requests, a
  malformed ``net_idx``, expired and far deadlines, verbatim repeats, a
  fresh seed) gives the same responses in the same order in both
  servers: rid, source, error, batch size, degraded flag, task identity
  and every Selection field (``cfg_idx``, latency, power, satisfied,
  ``n_candidates``; not ``dse_seconds``, a wall time), exactly; and the
  same counters (all but the dispatch seconds);
- the same stream under a burst of injected faults (the degraded
  fallback and its recovery) gives the same responses and counters too;
- the launcher (``launch/dse_serve``) reports the reference launcher's
  counts for the same flags, in both modes.

Then the contracts of the reference's ``tests/test_serve.py``, each pinned
on the port's server as the reference pins them: parity with a direct
batch, the cache, coalescing, round robin over models, requeue on
failure, the poison request, retention, hot swap with invalidation,
backoff, the queue bound, deadlines and the degraded fallback.  And the
port's own: every engine of the port registers with its sequential
route, the kernel route reported never says the CPU runs a kernel, and a
served G forward builds no autograd graph.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import dse_api as JAPI
from repro.core import explorer as JE
from repro.core import gan as JG
from repro.dataset import generator as JGEN
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro.design_models.im2col import Im2colModel as JIm2col
from repro.launch import dse_serve as j_dse_serve
from repro import serve as JS
from repro.serve import server as j_server
from repro_torch.baselines import (LargeMLP, PolicyGradientDRL, RandomSearch,
                                   SimulatedAnnealing)
from repro_torch.convert import g_params_from_numpy
from repro_torch.core import dse_api as API
from repro_torch.core import explorer as E
from repro_torch.core import gan as G
from repro_torch.dataset import generator as GEN
from repro_torch.design_models import DnnWeaverModel, Im2colModel
from repro_torch.kernels import dispatch
from repro_torch.launch import dse_serve
from repro_torch import serve as S
from repro_torch.serve import server as t_server

MODELS = {"dnnweaver": (JDnnWeaver, DnnWeaverModel),
          "im2col": (JIm2col, Im2colModel)}
XCFG = dict(prob_threshold=0.1, max_candidates=128)


def _params(name, key):
    """The reference's G for PRNGKey(key) at 1 x 32, as numpy."""
    jm = MODELS[name][0]()
    cfg = JG.GANConfig(n_net=jm.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=64, lr=1e-3)
    return jax.tree.map(np.asarray,
                        JG.init_generator(jax.random.PRNGKey(key), cfg,
                                          jm.space))


def _jengine(name="dnnweaver", key=3):
    jm = MODELS[name][0]()
    cfg = JG.GANConfig(n_net=jm.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=64, lr=1e-3)
    e = JAPI.GANDSE(jm, cfg, JE.ExplorerConfig(**XCFG))
    e.attach(JGEN.generate_dataset(jm, 256, seed=0),
             jax.tree.map(jax.numpy.asarray, _params(name, key)))
    return e


def _tengine(name="dnnweaver", key=3):
    tm = MODELS[name][1]()
    cfg = G.GANConfig(n_net=tm.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=64, lr=1e-3)
    e = API.GANDSE(tm, cfg, E.ExplorerConfig(**XCFG), device="cpu")
    e.attach(GEN.generate_dataset(tm, 256, seed=0),
             g_params_from_numpy(_params(name, key), "cpu"))
    return e


@pytest.fixture(scope="module")
def engine():
    return _tengine()


def _sel(s):
    return (None if s.cfg_idx is None else s.cfg_idx.tolist(), s.latency,
            s.power, s.satisfied, s.n_candidates)


def _fields(r):
    """Everything a response says but wall times (the retry-after hint is
    an estimate from dispatch seconds: only its presence compares)."""
    return (r.rid, r.model_name, r.source, r.batch_size, r.error,
            r.retry_after is None, r.degraded,
            None if r.net_idx is None else r.net_idx.tolist(), r.seed,
            None if r.result is None else
            (_sel(r.result.selection), r.result.lat_obj, r.result.pow_obj))


def _assert_selection_equal(tag, i, sa, sb):
    assert _sel(sa) == _sel(sb), (tag, i)


def _stats(srv):
    return {k: v for k, v in srv.stats.items() if k != "dispatch_s"}


# ---------------------------------------------------------------------------
# the same stream through both packages
# ---------------------------------------------------------------------------
def _stream(pkg, server_mod, engine, tasks):
    """One request stream; returns (responses in answer order, the errors
    submit raised, the counters)."""
    name = engine.model.name
    srv = pkg.DSEServer(pkg.ServeConfig(max_batch=4))
    srv.register(engine)

    def submit(i, seed, **kw):
        return srv.submit(name, tasks.net_idx[i], tasks.lat_obj[i],
                          tasks.pow_obj[i], seed=seed, **kw)

    for i in [3, 0, 5, 1, 4, 2, 6, 9, 7, 8]:
        submit(i, 7 + i)
    submit(0, 7)                                  # rides queued rid of row 0
    submit(5, 12)                                 # and row 5
    errors = []
    n_dims = engine.model.net_space.n_dims
    for bad in (np.full(n_dims, -1), np.zeros(n_dims + 1, np.int64)):
        try:
            srv.submit(name, bad, 1e-3, 2.0)
        except ValueError as e:
            errors.append(str(e))
    submit(1, 50, deadline=server_mod._now() - 1.0)   # expired at the door
    submit(2, 51, deadline=server_mod._now() + 3600.0)
    out = srv.drain()
    submit(3, 10)                                 # verbatim repeats: cache
    submit(4, 11)
    submit(3, 99)                                 # a fresh seed: dispatch
    out += srv.drain()
    return out, errors, _stats(srv)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stream_matches_reference(name):
    je, te = _jengine(name), _tengine(name)
    tasks = JGEN.generate_tasks(je.model, 10, seed=2)
    want, jerr, jstats = _stream(JS, j_server, je, tasks)
    got, terr, tstats = _stream(S, t_server, te, tasks)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert terr == jerr and len(terr) == 2
    assert tstats == jstats
    sources = [r.source for r in got]
    assert sources.count("coalesced") == 2 and sources.count("cache") == 2
    assert sources.count("rejected") == 1
    assert any(r.result is not None and r.result.selection.cfg_idx is not None
               for r in got)


def _fault_stream(pkg, engine, tasks):
    faulty = pkg.FaultyEngine(engine, pkg.FaultPlan(burst_start=0,
                                                    burst_len=2))
    srv = pkg.DSEServer(pkg.ServeConfig(
        max_batch=4, cache_capacity=0, max_dispatch_attempts=10,
        retry_backoff_base=0.001, retry_jitter=0.0,
        degrade_after=2, degrade_probe_after=1))
    srv.register(faulty)
    for i in range(6):
        srv.submit(engine.model.name, tasks.net_idx[i], tasks.lat_obj[i],
                   tasks.pow_obj[i], seed=7 + i)
    out, raised = [], 0
    for _ in range(50):
        try:
            out += srv.drain()
        except pkg.InjectedFault:
            raised += 1
            continue
        break
    out += srv.drain()
    return out, raised, _stats(srv), faulty.fault_stats()


def test_degraded_fallback_matches_reference():
    je, te = _jengine(), _tengine()
    tasks = JGEN.generate_tasks(je.model, 6, seed=2)
    want = _fault_stream(JS, je, tasks)
    got = _fault_stream(S, te, tasks)
    assert [_fields(r) for r in got[0]] == [_fields(r) for r in want[0]]
    assert got[1:] == want[1:]
    assert got[2]["degraded_entered"] == got[2]["degraded_recovered"] == 1
    assert any(r.degraded for r in got[0])


@pytest.mark.parametrize("concurrent", [False, True])
def test_launcher_matches_reference(concurrent, capsys):
    """The slice through its entry point: the port's ``dse_serve`` on the
    CPU reports the reference launcher's counts for the same flags (the
    same G init for the seed, so the same satisfied count)."""
    argv = ["--requests", "24", "--max-batch", "8", "--model", "dnnweaver"]
    argv += ["--concurrent"] if concurrent else []
    assert j_dse_serve.main(argv) == 0
    want = capsys.readouterr().out
    assert dse_serve.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    keys = ("requests", "served", "satisfied")
    # the sync pump's batching is fixed by the stream; the front end's
    # depends on arrival timing
    keys += () if concurrent else ("batches", "coalesced", "cache_hits")

    def counts(line):
        return {k: re.search(rf" {k}=(\S+)", line).group(1) for k in keys}

    assert counts(got) == counts(want)
    assert "kernels=cpu:plain" in got
    rep = dse_serve.serve(argv + ["--device", "cpu"])
    direct = rep["engine"].explore_tasks(rep["tasks"], seed=0)
    for r in rep["responses"]:
        i = int(r.seed)
        _assert_selection_equal("launcher", i, r.result.selection,
                                direct[i].selection)
    s = rep["server"].summary()
    assert (s["failed"], s["retried"], s["degraded_entered"]) == (0, 0, 0)


# ---------------------------------------------------------------------------
# the reference's serving contracts on the port's server
# ---------------------------------------------------------------------------
def _submit_all(srv, model, tasks, seed0, order):
    rid_to_row = {}
    for i in order:
        rid = srv.submit(model.name, tasks.net_idx[i], tasks.lat_obj[i],
                         tasks.pow_obj[i], seed=seed0 + i)
        rid_to_row[rid] = i
    return rid_to_row


def test_server_parity_with_direct_batch(engine):
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=4))
    srv.register(engine)
    tasks = GEN.generate_tasks(model, 6, seed=2)
    direct = engine.explore_tasks(tasks, seed=7)
    rid_to_row = _submit_all(srv, model, tasks, 7, [3, 0, 5, 1, 4, 2])
    responses = srv.drain()
    assert len(responses) == 6
    assert srv.stats["batches"] == 2 and srv.stats["padded_rows"] == 0
    for r in responses:
        i = rid_to_row[r.rid]
        _assert_selection_equal("parity", i, r.result.selection,
                                direct[i].selection)
    srv2 = S.DSEServer(S.ServeConfig(max_batch=4, cache_capacity=0))
    srv2.register(engine)
    rid_to_row = _submit_all(srv2, model, tasks, 7, [2, 0, 1])
    for r in srv2.drain():
        i = rid_to_row[r.rid]
        _assert_selection_equal("padded", i, r.result.selection,
                                direct[i].selection)
    assert srv2.stats["padded_rows"] == 1


def test_server_warm_pass_hits_cache(engine):
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=8))
    srv.register(engine)
    tasks = GEN.generate_tasks(model, 6, seed=2)
    rid_to_row = _submit_all(srv, model, tasks, 7, range(6))
    cold = {rid_to_row[r.rid]: r for r in srv.drain()}
    assert all(r.source == "dispatch" for r in cold.values())
    batches = srv.stats["batches"]
    rid_to_row = _submit_all(srv, model, tasks, 7, range(6))
    warm = {rid_to_row[r.rid]: r for r in srv.drain()}
    assert srv.stats["batches"] == batches
    for i in range(6):
        assert warm[i].cached
        _assert_selection_equal("warm", i, warm[i].result.selection,
                                cold[i].result.selection)
    rid = srv.submit(model.name, tasks.net_idx[0], tasks.lat_obj[0],
                     tasks.pow_obj[0], seed=99)
    (resp,) = srv.drain()
    assert resp.rid == rid and resp.source == "dispatch"


def test_server_coalesces_identical_inflight(engine):
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=8))
    srv.register(engine)
    tasks = GEN.generate_tasks(model, 2, seed=2)
    args = (model.name, tasks.net_idx[0], tasks.lat_obj[0], tasks.pow_obj[0])
    r1 = srv.submit(*args, seed=7)
    r2 = srv.submit(*args, seed=7)
    r3 = srv.submit(model.name, tasks.net_idx[1], tasks.lat_obj[1],
                    tasks.pow_obj[1], seed=8)
    responses = {r.rid: r for r in srv.drain()}
    assert srv.stats["dispatched_rows"] == 2 and srv.stats["coalesced"] == 1
    assert responses[r2].source == "coalesced"
    _assert_selection_equal("coalesce", 0, responses[r1].result.selection,
                            responses[r2].result.selection)
    assert responses[r3].source == "dispatch"


def test_multi_model_registry_round_robin(engine):
    g2 = _tengine("im2col")
    srv = S.DSEServer(S.ServeConfig(max_batch=4))
    srv.register(engine)
    srv.register(g2)
    t1 = GEN.generate_tasks(engine.model, 4, seed=2)
    t2 = GEN.generate_tasks(g2.model, 4, seed=2)
    direct1 = engine.explore_tasks(t1, seed=7)
    direct2 = g2.explore_tasks(t2, seed=7)
    rids = {}
    for i in range(4):
        rids[srv.submit("dnnweaver", t1.net_idx[i], t1.lat_obj[i],
                        t1.pow_obj[i], seed=7 + i)] = ("dnnweaver", i)
        rids[srv.submit("im2col", t2.net_idx[i], t2.lat_obj[i],
                        t2.pow_obj[i], seed=7 + i)] = ("im2col", i)
    responses = srv.drain()
    assert len(responses) == 8
    # round robin: the two models' batches alternate
    assert [r.model_name for r in responses[::4]] == ["dnnweaver", "im2col"]
    for r in responses:
        name, i = rids[r.rid]
        want = (direct1 if name == "dnnweaver" else direct2)[i]
        _assert_selection_equal(name, i, r.result.selection, want.selection)


class _Flaky:
    """Fails its first `fails` dispatches, then passes through."""

    def __init__(self, inner, fails=1):
        self._inner, self.model, self.calls = inner, inner.model, 0
        self.fails = fails

    def explore_tasks(self, tasks, seed=0):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError("transient engine failure")
        return self._inner.explore_tasks(tasks, seed=seed)


def test_dispatch_failure_loses_no_requests(engine):
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=8))
    srv.register(_Flaky(engine))
    tasks = GEN.generate_tasks(model, 2, seed=2)
    rids = _submit_all(srv, model, tasks, 7, range(2))
    dup = srv.submit(model.name, tasks.net_idx[0], tasks.lat_obj[0],
                     tasks.pow_obj[0], seed=7)
    with pytest.raises(RuntimeError, match="transient"):
        srv.drain()
    assert srv.batcher.pending() == 2
    responses = {r.rid: r for r in srv.drain()}
    assert set(responses) == set(rids) | {dup}
    direct = engine.explore_tasks(tasks, seed=7)
    for rid, i in rids.items():
        _assert_selection_equal("retry", i, responses[rid].result.selection,
                                direct[i].selection)
    assert responses[dup].source == "coalesced"


def test_poison_request_cannot_wedge_the_queue(engine):
    model = engine.model

    class PoisonOnSeed:
        def __init__(self, inner):
            self._inner, self.model = inner, inner.model

        def explore_tasks(self, tasks, seed=0):
            if np.any(np.asarray(seed) == 666):
                raise RuntimeError("poison request")
            return self._inner.explore_tasks(tasks, seed=seed)

    srv = S.DSEServer(S.ServeConfig(max_batch=8))
    srv.register(PoisonOnSeed(engine))
    tasks = GEN.generate_tasks(model, 3, seed=2)
    bad = srv.submit(model.name, tasks.net_idx[0], tasks.lat_obj[0],
                     tasks.pow_obj[0], seed=666)
    other = srv.submit(model.name, tasks.net_idx[1], tasks.lat_obj[1],
                       tasks.pow_obj[1], seed=7)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="poison"):
            srv.drain()
    assert srv.batcher.pending() == 0
    responses = {r.rid: r for r in srv.drain()}
    assert responses[bad].source == "failed" and not responses[bad].ok
    assert "poison" in responses[bad].error
    assert responses[other].source == "failed"
    rid = srv.submit(model.name, tasks.net_idx[2], tasks.lat_obj[2],
                     tasks.pow_obj[2], seed=8)
    (resp,) = srv.drain()
    assert resp.rid == rid and resp.ok and resp.source == "dispatch"
    assert srv.stats["failed"] == 2


def test_submit_copies_net_idx(engine):
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=4))
    srv.register(engine)
    tasks = GEN.generate_tasks(model, 2, seed=2)
    buf = np.array(tasks.net_idx[0], np.int64)
    srv.submit(model.name, buf, tasks.lat_obj[0], tasks.pow_obj[0], seed=7)
    buf[:] = 0
    (resp,) = srv.drain()
    direct = engine.explore(tasks.net_idx[0], tasks.lat_obj[0],
                            tasks.pow_obj[0], seed=7)
    _assert_selection_equal("copy", 0, resp.result.selection,
                            direct.selection)
    warm = srv.submit(model.name, tasks.net_idx[0], tasks.lat_obj[0],
                      tasks.pow_obj[0], seed=7)
    (hit,) = srv.drain()
    assert hit.rid == warm and hit.cached


def test_response_retention_is_bounded(engine):
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=4, cache_capacity=0,
                                    response_retention=2))
    srv.register(engine)
    tasks = GEN.generate_tasks(model, 4, seed=2)
    rid_to_row = _submit_all(srv, model, tasks, 7, range(4))
    responses = srv.drain()
    assert [r.rid for r in responses] == sorted(rid_to_row)[-2:]
    assert len(srv._responses) == 2
    assert all(srv.response(r) is not None for r in sorted(rid_to_row)[-2:])
    assert srv.stats["dispatched_rows"] == 4


def test_hot_swap_refreshes_params_and_invalidates(engine):
    model = engine.model
    e = _tengine(key=3)
    srv = S.DSEServer(S.ServeConfig(max_batch=4))
    srv.register(e)
    tasks = GEN.generate_tasks(model, 4, seed=2)
    rid_to_row = _submit_all(srv, model, tasks, 7, range(4))
    cold = {rid_to_row[r.rid]: r for r in srv.drain()}
    params_b = g_params_from_numpy(_params("dnnweaver", 4), "cpu")
    assert srv.swap(model.name, e.ds, params_b) == 4
    assert srv.params_generation(model.name) == 1
    rid_to_row = _submit_all(srv, model, tasks, 7, range(4))
    swapped = {rid_to_row[r.rid]: r for r in srv.drain()}
    assert all(r.source == "dispatch" for r in swapped.values())
    direct_b = _tengine(key=4).explore_tasks(tasks, seed=7)
    changed = 0
    for i in range(4):
        _assert_selection_equal("swap", i, swapped[i].result.selection,
                                direct_b[i].selection)
        changed += _sel(cold[i].result.selection) != \
            _sel(swapped[i].result.selection)
    assert changed > 0, "different params produced identical selections"


def test_retry_backoff_window_blocks_then_allows(engine):
    import time

    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=8, retry_backoff_base=0.25,
                                    retry_jitter=0.0))
    srv.register(_Flaky(engine))
    tasks = GEN.generate_tasks(model, 2, seed=2)
    rids = _submit_all(srv, model, tasks, 7, range(2))
    with pytest.raises(RuntimeError, match="transient"):
        srv.step()
    assert srv.batcher.pending() == 2
    assert srv.step() == 0
    backoff = srv.summary()["backoff"]
    assert model.name in backoff and 0 < backoff[model.name] <= 0.25
    assert srv.summary()["inflight_attempts"] == {r: 1 for r in rids}
    time.sleep(0.26)
    assert srv.step() == 2
    assert srv.stats["dispatch_attempts"] == 2 and srv.stats["retried"] == 2
    assert srv.summary()["backoff"] == {}


def test_queue_bound_rejects_at_the_door(engine):
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=8, max_queue=2,
                                    cache_capacity=0))
    srv.register(engine)
    tasks = GEN.generate_tasks(model, 4, seed=2)
    rid_to_row = _submit_all(srv, model, tasks, 7, range(4))
    assert srv.batcher.pending() == 2
    shed = [srv.response(r) for r, i in rid_to_row.items() if i >= 2]
    assert all(r is not None and r.rejected for r in shed)
    assert all("queue full" in r.error for r in shed)
    assert all(r.retry_after and 0 < r.retry_after <= 60 for r in shed)
    assert srv.stats["rejected"] == srv.stats["rejected_queue"] == 2
    direct = engine.explore_tasks(tasks, seed=7)
    served = {rid_to_row[r.rid]: r for r in srv.drain() if r.ok}
    assert sorted(served) == [0, 1]
    for i, r in served.items():
        _assert_selection_equal("bounded", i, r.result.selection,
                                direct[i].selection)


def test_deadline_sheds_before_dispatch(engine):
    import time

    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=8, cache_capacity=0))
    srv.register(engine)
    tasks = GEN.generate_tasks(model, 3, seed=2)
    dead = srv.submit(model.name, tasks.net_idx[0], tasks.lat_obj[0],
                      tasks.pow_obj[0], seed=7, deadline=t_server._now() - 1)
    assert srv.response(dead).rejected
    assert "at admission" in srv.response(dead).error
    soon = srv.submit(model.name, tasks.net_idx[1], tasks.lat_obj[1],
                      tasks.pow_obj[1], seed=8,
                      deadline=t_server._now() + 0.02)
    ok = srv.submit(model.name, tasks.net_idx[2], tasks.lat_obj[2],
                    tasks.pow_obj[2], seed=9)
    time.sleep(0.03)
    responses = {r.rid: r for r in srv.drain()}
    assert responses[soon].rejected
    assert "before dispatch" in responses[soon].error
    assert responses[ok].ok and responses[ok].source == "dispatch"
    assert srv.stats["rejected_deadline"] == 2
    assert srv.stats["dispatched_rows"] == 1


def test_sync_degraded_fallback_and_recovery(engine):
    model = engine.model
    faulty = S.FaultyEngine(engine, S.FaultPlan(burst_start=0, burst_len=2))
    srv = S.DSEServer(S.ServeConfig(
        max_batch=4, cache_capacity=0, max_dispatch_attempts=10,
        retry_backoff_base=0.001, retry_jitter=0.0,
        degrade_after=2, degrade_probe_after=1))
    srv.register(faulty)
    tasks = GEN.generate_tasks(model, 6, seed=2)
    direct = engine.explore_tasks(tasks, seed=7)
    rid_to_row = _submit_all(srv, model, tasks, 7, range(6))
    responses = {}
    for _ in range(50):
        try:
            responses.update({r.rid: r for r in srv.drain()})
        except S.InjectedFault:
            continue
        break
    responses.update({r.rid: r for r in srv.drain()})
    assert len(responses) == 6 and all(r.ok for r in responses.values())
    for rid, i in rid_to_row.items():
        _assert_selection_equal("degraded", i,
                                responses[rid].result.selection,
                                direct[i].selection)
    assert faulty.injected_errors == 2
    assert srv.stats["degraded_entered"] == 1
    assert srv.stats["degraded_batches"] >= 1
    assert srv.stats["degraded_recovered"] == 1
    assert srv.stats["failed"] == 0
    assert any(r.degraded for r in responses.values())
    assert not srv.summary()["degraded"]


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------
def test_every_port_engine_registers_with_its_sequential_route(engine):
    """GANDSE and the four baselines all take ``batched=``: the degraded
    fallback is armed for each, and a baseline serves its own
    ``explore_tasks`` results."""
    model = engine.model
    srv = S.DSEServer(S.ServeConfig(max_batch=4))
    for cls in (LargeMLP, PolicyGradientDRL, SimulatedAnnealing,
                RandomSearch):
        srv.register(cls(model, device="cpu"))
        assert srv._supports_batched[model.name], cls.__name__
    srv.register(engine)
    assert srv._supports_batched[model.name]
    rs = RandomSearch(model, n_samples=8, device="cpu")
    srv.register(rs)
    tasks = GEN.generate_tasks(model, 3, seed=2)
    rid_to_row = _submit_all(srv, model, tasks, 7, range(3))
    direct = rs.explore_tasks(tasks, seed=7)
    for r in srv.drain():
        i = rid_to_row[r.rid]
        _assert_selection_equal("random", i, r.result.selection,
                                direct[i].selection)


def test_kernel_route_report_never_claims_the_cpu():
    assert dispatch.kernel_route_active(None, "cuda")
    assert dispatch.kernel_route_active(True, torch.device("cuda"))
    assert not dispatch.kernel_route_active(False, "cuda")
    for flag in (None, True, False):
        assert not dispatch.kernel_route_active(flag, "cpu")
        assert not dispatch.kernel_route_active(flag, None)
    e = _tengine()
    for use_fused in (None, True, False):
        srv = S.DSEServer(S.ServeConfig(use_fused=use_fused))
        srv.register(e)
        assert e.gan_cfg.use_fused is use_fused
        assert srv.summary()["kernels"] == {
            "backend": {"dnnweaver": "cpu"}, "fused": {"dnnweaver": False}}
    assert srv.summary()["sharding"] == {"n_shards": 1, "mesh": None,
                                         "task_axes": None}


def test_set_use_fused_rebuilds_on_the_same_params(engine):
    e = _tengine()
    tasks = GEN.generate_tasks(e.model, 4, seed=2)
    before = e.explore_tasks(tasks, seed=7)
    params = e.g_params
    srv = S.DSEServer(S.ServeConfig(use_fused=False))
    srv.register(e)
    assert e.gan_cfg.use_fused is False
    assert e._explorer.gan_cfg.use_fused is False
    assert all(p[k] is q[k] for p, q in zip(params["layers"],
                                            e.g_params["layers"])
               for k in ("w", "b"))
    after = e.explore_tasks(tasks, seed=7)
    for i, (a, b) in enumerate(zip(before, after)):
        _assert_selection_equal("use_fused", i, a.selection, b.selection)


def test_served_forward_builds_no_autograd_graph():
    """Grad mode is per thread: even with params that require grad, the
    server's execute runs G without autograd, while the same engine
    called directly builds a graph (so the check is not vacuous)."""
    e = _tengine()
    params = {"layers": [{k: v.clone().requires_grad_() for k, v in p.items()}
                         for p in e.g_params["layers"]]}
    e.attach(e.ds, params)
    seen = []
    inner = e._explorer.generator_probs_device

    def spy(*a, **kw):
        out = inner(*a, **kw)
        seen.append((torch.is_grad_enabled(), out.grad_fn is not None))
        return out

    e._explorer.generator_probs_device = spy
    tasks = GEN.generate_tasks(e.model, 3, seed=2)
    e.explore_tasks(tasks, seed=7)
    assert seen == [(True, True)]
    srv = S.DSEServer(S.ServeConfig(max_batch=4))
    srv.register(e)
    _submit_all(srv, e.model, tasks, 7, range(3))
    assert len(srv.drain()) == 3
    assert seen[1:] == [(False, False)]
