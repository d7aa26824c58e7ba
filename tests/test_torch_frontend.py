"""The port's concurrent front end (``repro_torch.serve.frontend``) and the
thread safety of its serving primitives, on the CPU at a small size (G
1 x 32 on dnnweaver, threshold 0.1, cap 128, up to 16 tasks).

- The contracts of the reference's ``tests/test_frontend.py`` on the
  port: every non-rejected response equals a standalone
  ``explore_tasks`` Selection, field for field (exact), and every
  submitted request terminates exactly once — under the healthy engine, a
  slow one (admission reject and block, deadlines, stop without drain),
  injected faults (the degraded fallback and its recovery), a hot swap
  during dispatch and concurrent submitters.  The front end's answers
  also equal the reference's direct batch on the same params.
- The cases of the reference's ``tests/test_serve_concurrency.py`` for the
  port's `MicroBatcher` and `ResultCache` (conservation under racing
  admit/pop/requeue/shed, the cache's bound and counters, well-formed
  batches) and the params-generation stamp that keeps a swap racing a
  dispatch from poisoning the cache.
- ``kernels/build.load`` builds a source once when the first launches
  come from two threads at once (nvcc and the loader stubbed here; the
  ``cuda`` twin in ``tests/test_torch_serve_cuda.py`` builds for real).

Every wait has its own timeout, so no test can hang the suite.
"""
import threading
import time
from collections import Counter

import jax
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal CI image — seeded-random fallback
    from _mini_hypothesis import given, settings, strategies as st

from repro.core import dse_api as JAPI
from repro.core import explorer as JE
from repro.core import gan as JG
from repro.dataset import generator as JGEN
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro_torch.convert import g_params_from_numpy
from repro_torch.core import dse_api as API
from repro_torch.core import explorer as E
from repro_torch.core import gan as G
from repro_torch.core.dse_api import DSEResult
from repro_torch.core.selector import Selection
from repro_torch.dataset.generator import generate_tasks
from repro_torch.dataset import generator as GEN
from repro_torch.design_models import DnnWeaverModel
from repro_torch.kernels import build
from repro_torch.serve import (DSERequest, DSEServer, FaultPlan, FaultyEngine,
                               FrontendConfig, MicroBatcher, ResultCache,
                               ServeConfig, ServeFrontend)

MODEL = DnnWeaverModel()
XCFG = dict(prob_threshold=0.1, max_candidates=128)
WAIT = 60


def _params(key):
    jm = JDnnWeaver()
    cfg = JG.GANConfig(n_net=jm.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=64, lr=1e-3)
    return jax.tree.map(np.asarray, JG.init_generator(
        jax.random.PRNGKey(key), cfg, jm.space))


def _tengine(key=3):
    cfg = G.GANConfig(n_net=MODEL.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=64, lr=1e-3)
    e = API.GANDSE(MODEL, cfg, E.ExplorerConfig(**XCFG), device="cpu")
    e.attach(GEN.generate_dataset(MODEL, 256, seed=0),
             g_params_from_numpy(_params(key), "cpu"))
    return e


@pytest.fixture(scope="module")
def engine():
    return _tengine()


class SlowEngine:
    """Transparent wrapper that stalls every dispatch (host-side sleep)."""

    def __init__(self, inner, delay_s):
        self._inner, self.delay_s = inner, delay_s
        self.model = inner.model
        self.method_name = inner.method_name

    def explore_tasks(self, tasks, seed=0, batched=None):
        time.sleep(self.delay_s)
        return self._inner.explore_tasks(tasks, seed=seed, batched=batched)


def _sel(s):
    return (None if s.cfg_idx is None else s.cfg_idx.tolist(), s.latency,
            s.power, s.satisfied, s.n_candidates)


def _assert_selection_equal(tag, i, sa, sb):
    assert _sel(sa) == _sel(sb), (tag, i)


def _submit_tasks(fe, tasks, n, seed0=7, timeout_s=None):
    futs = {}
    for i in range(n):
        fut = fe.submit(MODEL.name, tasks.net_idx[i], tasks.lat_obj[i],
                        tasks.pow_obj[i], seed=seed0 + i, timeout_s=timeout_s)
        futs[fut.rid] = (i, fut)
    return futs


# ---------------------------------------------------------------------------
# the front end (the reference's tests/test_frontend.py)
# ---------------------------------------------------------------------------
def test_frontend_parity_with_direct_batch_and_reference(engine):
    tasks = generate_tasks(MODEL, 10, seed=2)
    direct = engine.explore_tasks(tasks, seed=7)
    je = JAPI.GANDSE(JDnnWeaver(), JG.GANConfig(
        n_net=MODEL.net_space.n_dims).scaled(layers=1, neurons=32,
                                             batch_size=64, lr=1e-3),
        JE.ExplorerConfig(**XCFG))
    je.attach(JGEN.generate_dataset(je.model, 256, seed=0),
              jax.tree.map(jax.numpy.asarray, _params(3)))
    ref = je.explore_tasks(tasks, seed=7)
    srv = DSEServer(ServeConfig(max_batch=4))
    srv.register(engine)
    with ServeFrontend(srv) as fe:
        futs = _submit_tasks(fe, tasks, 10)
        for rid, (i, fut) in futs.items():
            resp = fut.result(timeout=WAIT)
            assert resp.ok and resp.source in ("dispatch", "cache",
                                               "coalesced")
            _assert_selection_equal("parity", i, resp.result.selection,
                                    direct[i].selection)
            _assert_selection_equal("reference", i, resp.result.selection,
                                    ref[i].selection)
    assert srv.batcher.pending() == 0


def test_frontend_cache_and_coalesce(engine):
    tasks = generate_tasks(MODEL, 3, seed=2)
    srv = DSEServer(ServeConfig(max_batch=8))
    srv.register(engine)
    with ServeFrontend(srv) as fe:
        first = _submit_tasks(fe, tasks, 3)
        dup = [fe.submit(MODEL.name, tasks.net_idx[i], tasks.lat_obj[i],
                         tasks.pow_obj[i], seed=7 + i) for i in range(3)]
        by_row = {i: fut.result(WAIT) for _, (i, fut) in first.items()}
        for i, fut in enumerate(dup):
            resp = fut.result(timeout=WAIT)
            assert resp.source in ("cache", "coalesced"), resp.source
            _assert_selection_equal("dup", i, resp.result.selection,
                                    by_row[i].result.selection)
    assert srv.stats["dispatched_rows"] == 3


def test_frontend_admission_reject_sheds_load(engine):
    srv = DSEServer(ServeConfig(max_batch=1, max_queue=2, cache_capacity=0,
                                retry_jitter=0.0))
    srv.register(SlowEngine(engine, delay_s=0.05))
    tasks = generate_tasks(MODEL, 12, seed=2)
    with ServeFrontend(srv, FrontendConfig(admission="reject")) as fe:
        futs = _submit_tasks(fe, tasks, 12)
        resps = [fut.result(timeout=WAIT) for _, fut in futs.values()]
    rejected = [r for r in resps if r.rejected]
    served = [r for r in resps if r.ok]
    assert len(rejected) + len(served) == 12
    assert rejected
    assert all(r.retry_after and r.retry_after > 0 for r in rejected)
    assert all("queue full" in r.error for r in rejected)
    assert srv.stats["rejected_queue"] == len(rejected)


def test_frontend_admission_block_backpressures(engine):
    srv = DSEServer(ServeConfig(max_batch=2, max_queue=2, cache_capacity=0))
    srv.register(SlowEngine(engine, delay_s=0.01))
    tasks = generate_tasks(MODEL, 8, seed=2)
    with ServeFrontend(srv, FrontendConfig(admission="block")) as fe:
        futs = _submit_tasks(fe, tasks, 8)
        resps = [fut.result(timeout=WAIT) for _, fut in futs.values()]
    assert all(r.ok for r in resps)
    assert srv.stats["rejected"] == 0


def test_frontend_deadline_sheds_expired(engine):
    srv = DSEServer(ServeConfig(max_batch=1, cache_capacity=0))
    srv.register(SlowEngine(engine, delay_s=0.3))
    tasks = generate_tasks(MODEL, 8, seed=2)
    with ServeFrontend(srv, FrontendConfig(max_prepared=1)) as fe:
        lead = fe.submit(MODEL.name, tasks.net_idx[0], tasks.lat_obj[0],
                         tasks.pow_obj[0], seed=7)
        time.sleep(0.05)
        late = [fe.submit(MODEL.name, tasks.net_idx[i], tasks.lat_obj[i],
                          tasks.pow_obj[i], seed=7 + i, timeout_s=0.05)
                for i in range(1, 8)]
        assert lead.result(timeout=WAIT).ok
        resps = [fut.result(timeout=WAIT) for fut in late]
    rejected = [r for r in resps if r.rejected]
    served = [r for r in resps if r.ok]
    assert len(rejected) + len(served) == 7
    assert len(served) <= 2 and len(rejected) >= 5
    assert all("deadline" in r.error for r in rejected)
    assert srv.stats["rejected_deadline"] == len(rejected)


def test_frontend_degraded_fallback_activates_and_recovers(engine):
    faulty = FaultyEngine(engine, FaultPlan(burst_start=0, burst_len=3))
    srv = DSEServer(ServeConfig(
        max_batch=2, cache_capacity=0, max_dispatch_attempts=10,
        retry_backoff_base=0.005, retry_jitter=0.0,
        degrade_after=2, degrade_probe_after=1))
    srv.register(faulty)
    tasks = generate_tasks(MODEL, 10, seed=2)
    direct = engine.explore_tasks(tasks, seed=7)
    with ServeFrontend(srv) as fe:
        futs = _submit_tasks(fe, tasks, 10)
        resps = {i: fut.result(timeout=WAIT) for _, (i, fut) in futs.items()}
    assert all(r.ok for r in resps.values()), \
        {i: (r.source, r.error) for i, r in resps.items() if not r.ok}
    for i, r in resps.items():
        _assert_selection_equal("faulty", i, r.result.selection,
                                direct[i].selection)
    assert faulty.injected_errors == 3
    assert srv.stats["degraded_entered"] == 1
    assert srv.stats["degraded_batches"] >= 1
    assert srv.stats["degraded_recovered"] == 1
    assert not srv.summary()["degraded"]
    assert any(r.degraded for r in resps.values())
    assert srv.stats["failed"] == 0


def test_frontend_stop_without_drain_rejects_queued(engine):
    srv = DSEServer(ServeConfig(max_batch=1, cache_capacity=0))
    srv.register(SlowEngine(engine, delay_s=0.2))
    tasks = generate_tasks(MODEL, 6, seed=2)
    fe = ServeFrontend(srv).start()
    futs = _submit_tasks(fe, tasks, 6)
    time.sleep(0.05)
    fe.stop(drain=False, timeout=WAIT)
    states = [fut.result(timeout=WAIT) for _, fut in futs.values()]
    assert all(r.ok or r.rejected for r in states)
    assert any(r.rejected and "shutting down" in r.error for r in states)
    assert srv.batcher.pending() == 0


def test_frontend_metrics_snapshot(engine):
    srv = DSEServer(ServeConfig(max_batch=4))
    srv.register(engine)
    tasks = generate_tasks(MODEL, 4, seed=2)
    with ServeFrontend(srv) as fe:
        for _, fut in _submit_tasks(fe, tasks, 4).values():
            fut.result(timeout=WAIT)
        m = fe.metrics()
    lat = m["frontend"]["latency"]
    assert lat["n"] == 4 and lat["p99_ms"] >= lat["p50_ms"] > 0
    assert m["frontend"]["inflight"] == 0
    assert m["dispatch_attempts"] >= m["batches"] >= 1
    assert m["kernels"] == {"backend": {"dnnweaver": "cpu"},
                            "fused": {"dnnweaver": False}}


def test_frontend_swap_during_dispatch_parity():
    serving = _tengine(3)
    params_b = g_params_from_numpy(_params(4), "cpu")
    ref_a, ref_b = _tengine(3), _tengine(4)
    tasks = generate_tasks(MODEL, 6, seed=2)
    direct_a = ref_a.explore_tasks(tasks, seed=7)
    direct_b = ref_b.explore_tasks(tasks, seed=7)
    direct_b2 = ref_b.explore_tasks(tasks, seed=107)
    srv = DSEServer(ServeConfig(max_batch=4))
    srv.register(serving)
    with ServeFrontend(srv) as fe:
        for rid, (i, fut) in _submit_tasks(fe, tasks, 6, 7).items():
            _assert_selection_equal("pre-swap", i,
                                    fut.result(WAIT).result.selection,
                                    direct_a[i].selection)
        gen0 = srv.params_generation(MODEL.name)
        fe.swap(MODEL.name, serving.ds, params_b)
        assert srv.params_generation(MODEL.name) == gen0 + 1
        for rid, (i, fut) in _submit_tasks(fe, tasks, 6, 107).items():
            _assert_selection_equal("post-swap", i,
                                    fut.result(WAIT).result.selection,
                                    direct_b2[i].selection)
        for rid, (i, fut) in _submit_tasks(fe, tasks, 6, 7).items():
            resp = fut.result(WAIT)
            assert resp.source in ("dispatch", "coalesced"), resp.source
            _assert_selection_equal("re-ask", i, resp.result.selection,
                                    direct_b[i].selection)
    assert srv.stats["swaps"] == 1


def test_frontend_concurrent_submitters(engine):
    tasks = generate_tasks(MODEL, 16, seed=2)
    direct = engine.explore_tasks(tasks, seed=7)
    srv = DSEServer(ServeConfig(max_batch=8))
    srv.register(engine)
    results, errors = {}, []
    lock = threading.Lock()

    def submitter(rows):
        try:
            for i in rows:
                fut = fe.submit(MODEL.name, tasks.net_idx[i],
                                tasks.lat_obj[i], tasks.pow_obj[i],
                                seed=7 + i)
                resp = fut.result(timeout=WAIT)
                with lock:
                    results[i] = resp
        except Exception as e:      # pragma: no cover - surfaced below
            errors.append(e)

    with ServeFrontend(srv) as fe:
        threads = [threading.Thread(target=submitter,
                                    args=(range(k, 16, 4),))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 16
    for i, resp in results.items():
        assert resp.ok
        _assert_selection_equal("mt", i, resp.result.selection,
                                direct[i].selection)


# ---------------------------------------------------------------------------
# the serving primitives under races (tests/test_serve_concurrency.py)
# ---------------------------------------------------------------------------
_NET = np.array([1, 2, 3], np.int64)


def _req(rid, model="m0", seed=None, deadline=None):
    return DSERequest(rid=rid, model_name=model, net_idx=_NET, lat_obj=1.0,
                      pow_obj=2.0, seed=rid if seed is None else seed,
                      deadline=deadline)


def _run_threads(fns):
    """One thread per fn behind a common barrier; re-raises the first
    error, fails on a thread still alive after its join timeout."""
    barrier = threading.Barrier(len(fns))
    errors = []

    def wrap(fn):
        def run():
            barrier.wait(timeout=WAIT)
            try:
                fn()
            except BaseException as e:    # pragma: no cover - surfaced below
                errors.append(e)
        return run

    threads = [threading.Thread(target=wrap(fn)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "thread wedged"
    if errors:
        raise errors[0]


def test_concurrent_admit_and_pop_conserves_requests():
    n_threads, n_each = 4, 200
    batcher = MicroBatcher(max_batch=7)
    popped = []
    pop_lock = threading.Lock()
    total = n_threads * n_each

    def admitter(k):
        def run():
            for i in range(n_each):
                batcher.admit(_req(k * n_each + i))
        return run

    def popper():
        while True:
            with pop_lock:
                if len(popped) >= total:
                    return
                b = batcher.next_batch()
                if b is not None:
                    popped.extend(r.rid for r in b.requests)

    _run_threads([admitter(k) for k in range(n_threads)] + [popper, popper])
    assert len(popped) == total and len(set(popped)) == total
    assert batcher.pending() == 0
    for k in range(n_threads):
        mine = [r for r in popped if k * n_each <= r < (k + 1) * n_each]
        assert mine == sorted(mine)


def test_concurrent_requeue_front_loses_nothing():
    batcher = MicroBatcher(max_batch=5)
    n = 300
    delivered = []
    lock = threading.Lock()

    def admitter():
        for i in range(n):
            batcher.admit(_req(i))

    def flaky_popper():
        fail_next = True
        while True:
            with lock:
                if len(delivered) >= n:
                    return
                b = batcher.next_batch()
                if b is None:
                    continue
                if fail_next:
                    batcher.requeue_front(b.requests)
                else:
                    delivered.extend(r.rid for r in b.requests)
                fail_next = not fail_next

    _run_threads([admitter, flaky_popper, flaky_popper])
    assert sorted(delivered) == list(range(n))
    assert batcher.pending() == 0


def test_concurrent_shed_admit_pop_partition():
    batcher = MicroBatcher(max_batch=4)
    n = 400
    popped, shed = [], []
    lock = threading.Lock()
    done = threading.Event()

    def admitter():
        for i in range(n):
            batcher.admit(_req(i))
        done.set()

    def popper():
        while not (done.is_set() and batcher.pending() == 0):
            b = batcher.next_batch()
            if b is not None:
                with lock:
                    popped.extend(r.rid for r in b.requests)

    def shedder():
        while not (done.is_set() and batcher.pending() == 0):
            out = batcher.shed(lambda r: r.rid % 2 == 1)
            with lock:
                shed.extend(r.rid for r in out)

    _run_threads([admitter, popper, shedder])
    leftovers = []
    while True:
        b = batcher.next_batch()
        if b is None:
            break
        leftovers.extend(r.rid for r in b.requests)
    counts = Counter(popped) + Counter(shed) + Counter(leftovers)
    assert counts == Counter(range(n))
    assert all(r % 2 == 1 for r in shed)


def test_concurrent_cache_put_get_invalidate():
    cache = ResultCache(capacity=32)
    n_keys, n_rounds = 64, 150
    values = {k: f"v{k}" for k in range(n_keys)}
    reads = Counter()
    lock = threading.Lock()

    def writer(offset):
        def run():
            for i in range(n_rounds):
                k = (i + offset) % n_keys
                cache.put(("m", k), values[k])
                assert len(cache) <= 32
        return run

    def reader():
        hits = misses = 0
        for i in range(n_rounds * 2):
            k = i % n_keys
            got = cache.get(("m", k))
            if got is None:
                misses += 1
            else:
                hits += 1
                assert got == values[k]
        with lock:
            reads["hits"] += hits
            reads["misses"] += misses

    def invalidator():
        for _ in range(20):
            cache.invalidate_model("other")
        cache.invalidate_model("m")

    _run_threads([writer(0), writer(17), reader, reader, invalidator])
    s = cache.stats()
    assert s["size"] <= s["capacity"] == 32
    assert s["hits"] == reads["hits"] and s["misses"] == reads["misses"]
    assert s["hits"] + s["misses"] == 2 * n_rounds * 2


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=1, max_value=4),
       st.integers(min_value=1, max_value=16),
       st.integers(min_value=1, max_value=60))
def test_property_admit_pop_conservation(n_admitters, max_batch, n_each):
    batcher = MicroBatcher(max_batch=max_batch)
    total = n_admitters * n_each
    popped = []
    lock = threading.Lock()

    def admitter(k):
        def run():
            for i in range(n_each):
                batcher.admit(_req(k * n_each + i))
        return run

    def popper():
        while True:
            with lock:
                if len(popped) >= total:
                    return
                b = batcher.next_batch()
                if b is not None:
                    popped.extend(r.rid for r in b.requests)

    _run_threads([admitter(k) for k in range(n_admitters)] + [popper])
    assert sorted(popped) == list(range(total))
    assert batcher.pending() == 0


def test_batch_formation_under_concurrency_is_well_formed():
    batcher = MicroBatcher(max_batch=6)
    n = 120
    batches = []
    lock = threading.Lock()

    def admitter(model):
        def run():
            for i in range(n):
                batcher.admit(_req(i, model=model))
        return run

    def popper():
        got = 0
        while got < 2 * n:
            b = batcher.next_batch()
            with lock:
                if b is not None:
                    batches.append(b)
                got = sum(x.n_real for x in batches)

    _run_threads([admitter("a"), admitter("b"), popper])
    assert sum(b.n_real for b in batches) == 2 * n
    for b in batches:
        assert b.padded_size >= b.n_real
        assert (b.padded_size & (b.padded_size - 1)) == 0
        assert len(b.seeds) == b.padded_size
        np.testing.assert_array_equal(b.seeds[: b.n_real],
                                      [r.seed for r in b.requests])
        assert len({r.model_name for r in b.requests}) == 1


class _StubSpace:
    n_dims = 3
    group_sizes = (8, 8, 8)


class _StubModel:
    name = "stub"
    net_space = _StubSpace()


class _StubEngine:
    """Selections carry the params tag attached at explore time."""

    method_name = "stub"

    def __init__(self):
        self.model = _StubModel()
        self.params_tag = 0.0

    def attach(self, ds, g_params):
        self.params_tag = float(g_params)

    def explore_tasks(self, tasks, seed=0, batched=None):
        tag = self.params_tag
        return [DSEResult(Selection(np.zeros(3, np.int64), tag, tag, True, 1),
                          float(tasks.lat_obj[i]), float(tasks.pow_obj[i]),
                          0.0)
                for i in range(len(tasks))]


def _stub_server():
    srv = DSEServer(ServeConfig(max_batch=4))
    srv.register(_StubEngine())
    return srv


def test_swap_between_execute_and_publish_skips_cache():
    srv = _stub_server()
    rid = srv.submit("stub", _NET, 1.0, 2.0, seed=7)
    batch = srv.form_batch()
    results, info = srv.execute_batch(batch)
    assert srv.swap("stub", ds=None, g_params=1.0) == 0
    srv.publish_batch(batch, results, info)
    resp = srv.response(rid)
    assert resp.ok and resp.result.selection.latency == 0.0
    assert srv.stats["stale_cache_skips"] == 1
    rid2 = srv.submit("stub", _NET, 1.0, 2.0, seed=7)
    batch2 = srv.form_batch()
    assert batch2 is not None, "stale result was cached: re-ask hit the LRU"
    srv.publish_batch(batch2, *srv.execute_batch(batch2))
    assert srv.response(rid2).result.selection.latency == 1.0
    rid3 = srv.submit("stub", _NET, 1.0, 2.0, seed=7)
    assert srv.response(rid3).cached


def test_swap_before_form_serves_and_caches_new_params():
    srv = _stub_server()
    rid = srv.submit("stub", _NET, 1.0, 2.0, seed=3)
    srv.swap("stub", ds=None, g_params=5.0)
    batch = srv.form_batch()
    srv.publish_batch(batch, *srv.execute_batch(batch))
    assert srv.response(rid).result.selection.latency == 5.0
    assert srv.stats["stale_cache_skips"] == 0
    assert srv.response(srv.submit("stub", _NET, 1.0, 2.0, seed=3)).cached


def test_swap_race_under_threads_never_poisons_cache():
    srv = _stub_server()
    lock = threading.Lock()
    tags = []

    def one_round(i):
        barrier = threading.Barrier(2)

        def dispatcher():
            with lock:
                srv.submit("stub", _NET, 1.0, float(i + 2), seed=i)
                batch = srv.form_batch()
            results, info = srv.execute_batch(batch)
            barrier.wait(timeout=WAIT)
            with lock:
                srv.publish_batch(batch, results, info)

        def swapper():
            barrier.wait(timeout=WAIT)
            with lock:
                srv.swap("stub", ds=None, g_params=float(i + 1))

        _run_threads([dispatcher, swapper])
        with lock:
            rid = srv.submit("stub", _NET, 1.0, float(i + 2), seed=i)
            batch = srv.form_batch()
        if batch is not None:
            results, info = srv.execute_batch(batch)
            with lock:
                srv.publish_batch(batch, results, info)
        tags.append(srv.response(rid).result.selection.latency)

    for i in range(40):
        one_round(i)
    assert tags == [float(i + 1) for i in range(40)]


# ---------------------------------------------------------------------------
# the kernels' build under two first launches at once
# ---------------------------------------------------------------------------
def test_two_threads_first_load_builds_once(tmp_path, monkeypatch):
    """The first launches of a kernel may come from the serving and the
    training thread at once: ``build.load`` runs nvcc once and both get
    the one library (nvcc and the loader stubbed: no toolkit here)."""
    src = tmp_path / "k.cu"
    src.write_text("// a source\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    runs, binds = [], []

    class Proc:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.05)                     # a slow build widens the race
        open(cmd[cmd.index("-o") + 1], "w").close()
        return Proc()

    monkeypatch.setattr(build.subprocess, "run", fake_run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_info", {})
    got = []
    _run_threads([lambda: got.append(build.load(src, binds.append))] * 2)
    assert len(runs) == 1 and len(binds) == 1
    assert len(got) == 2 and got[0] is got[1]
    assert set(build.build_info) == {"k.cu"}
